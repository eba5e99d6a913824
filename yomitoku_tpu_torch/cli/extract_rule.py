"""``yomitoku_torch_extract``: rule-based structured extraction (the port's
copy of yomitoku_tpu/cli/extract_rule.py, the JAX package's
``yomitoku_extract``, with its flag surface).

Each page of an image or PDF (the port's own PDF engine) goes through
the port's ``TableSemanticParser`` (``batch`` over the selected pages),
then the rule-based extractor
(``extractor.rule_pipeline.run_rule_extraction``) writes the extracted
fields as JSON.

Differences from the JAX CLI:

* ``-d/--device`` defaults to ``"cuda"`` (``cuda|cpu``); any other value
  raises (``base.resolve_device``), and asking for CUDA where there is
  no card raises rather than running on the CPU.
* The file loop.  The JAX CLI passes over any exception of a file
  (``except Exception: continue``).  Here a file that fails to load,
  parse or extract is logged with its traceback and skipped, but a
  ``KernelBuildError`` or an error raised on the card ends the run
  (``cli.main.is_device_fault``).
"""

import argparse
import os
import time
from pathlib import Path

from ..constants import SUPPORT_INPUT_FORMAT
from ..base import resolve_device
from ..data.functions import load_image, load_pdf
from ..extractor.rule_pipeline import run_rule_extraction
from ..extractor.schema import ExtractionSchema
from ..table_semantic_parser import TableSemanticParser
from ..utils.logger import set_logger
from ..utils.misc import save_image
from .main import is_device_fault

logger = set_logger(__name__, "INFO")


def parse_pages(pages_str):
    pages = set()
    for part in pages_str.split(","):
        if "-" in part:
            start, end = map(int, part.split("-"))
            pages.update(range(start, end + 1))
        else:
            pages.add(int(part))
    return sorted(pages)


def collect_files(path):
    if path.is_dir():
        files = sorted(
            f
            for f in path.rglob("*")
            if f.is_file() and f.suffix[1:].lower() in SUPPORT_INPUT_FORMAT
        )
        if not files:
            logger.warning(f"No supported files found in {path}")
        return files
    return [path]


def process_single_file(file_path, args, tsp, schema):
    logger.info(f"Processing file: {file_path}")
    if file_path.suffix.lower() == ".pdf":
        imgs = load_pdf(str(file_path), dpi=args.dpi)
    else:
        imgs = load_image(str(file_path))

    target_pages = range(1, len(imgs) + 1)
    if args.pages is not None:
        target_pages = parse_pages(args.pages)

    selected = [
        (page, img)
        for page, img in enumerate(imgs)
        if (page + 1) in target_pages
    ]
    # pipeline the semantic pass over pages (one page's host stages —
    # contours, cell postprocess, clustering, grid/kv parse — overlap the
    # next page's device programs); extraction/saving stays sequential
    start_all = time.time()
    outputs = tsp.batch([img for _, img in selected])
    logger.info(
        f"Parsed {len(selected)} page(s) in {time.time() - start_all:.2f}s"
    )

    for (page, img), (semantic_info, vis_layout, vis_ocr) in zip(
        selected, outputs
    ):
        start = time.time()

        if args.vis and vis_layout is not None:
            save_image(
                vis_layout,
                os.path.join(args.outdir, f"{file_path.stem}_p{page + 1}_layout.jpg"),
            )
        if args.vis and vis_ocr is not None:
            save_image(
                vis_ocr,
                os.path.join(args.outdir, f"{file_path.stem}_p{page + 1}_ocr.jpg"),
            )

        run_rule_extraction(
            semantic_info=semantic_info,
            img=img,
            schema=schema,
            no_normalize=args.no_normalize,
            visualize=args.vis,
            simple=args.simple,
            outdir=args.outdir,
            filename=f"{file_path.stem}_p{page + 1}_extract",
        )
        logger.info(f"Page {page + 1} done in {time.time() - start:.2f}s")


def main():
    parser = argparse.ArgumentParser(
        description="Extract structured data from document images (rule-based)"
    )
    parser.add_argument("input", type=str,
                        help="Input image, PDF path, or directory")
    parser.add_argument("-s", "--schema", type=str, required=True,
                        help="Extraction schema file (YAML)")
    parser.add_argument("-o", "--outdir", type=str, default="results")
    parser.add_argument("-d", "--device", type=str, default="cuda",
                        help="device to use (cuda|cpu)")
    parser.add_argument("-v", "--vis", action="store_true")
    parser.add_argument("--no-normalize", action="store_true")
    parser.add_argument("--simple", action="store_true")
    parser.add_argument("--pages", type=str, default=None)
    parser.add_argument("--dpi", type=int, default=200)
    parser.add_argument("--encoding", type=str, default="utf-8")
    args = parser.parse_args()

    path = Path(args.input)
    if not path.exists():
        raise FileNotFoundError(f"Input path not found: {args.input}")
    schema_path = Path(args.schema)
    if not schema_path.exists():
        raise FileNotFoundError(f"Schema file not found: {args.schema}")

    resolve_device(args.device)
    schema = ExtractionSchema.from_yaml(str(schema_path))
    logger.info(f"Loaded schema with {len(schema.fields)} fields")

    tsp = TableSemanticParser(configs={}, device=args.device, visualize=args.vis)
    os.makedirs(args.outdir, exist_ok=True)

    for file_path in collect_files(path):
        try:
            process_single_file(file_path, args, tsp, schema)
        except Exception as e:
            if is_device_fault(e):
                raise
            logger.exception(f"Failed to process {file_path}: {e}")


if __name__ == "__main__":
    main()
