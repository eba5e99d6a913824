"""``yomitoku_torch_extract_with_llm``: LLM-based structured extraction
(the port's copy of yomitoku_tpu/cli/extract.py, the JAX package's
``yomitoku_extract_with_llm``, with its flag surface).

Each page of an image or PDF (the port's own PDF engine) goes through
the port's ``TableSemanticParser`` (``batch`` over the selected pages),
then the LLM extractor (``extractor.pipeline.run_extraction``: a chat
request to an OpenAI-compatible server that the user runs,
``--api_base``; ``--prompt-only`` writes the prompt and sends nothing;
the ``openai`` package is imported only when a request is made) writes
the extracted fields as JSON.

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

from ..base import resolve_device
from ..data.functions import load_image, load_pdf
from ..extractor.pipeline import run_extraction
from ..extractor.schema import ExtractionSchema
from ..table_semantic_parser import TableSemanticParser
from ..utils.logger import set_logger
from ..utils.misc import save_image
from .extract_rule import collect_files, parse_pages
from .main import is_device_fault

logger = set_logger(__name__, "INFO")


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
    # pipeline the semantic pass over pages; the (network-bound) LLM
    # extraction and saving stay sequential
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

        run_extraction(
            semantic_info=semantic_info,
            img=img,
            schema=schema,
            model=args.model,
            api_base=args.api_base,
            api_key=args.api_key,
            temperature=args.temperature,
            max_tokens=args.max_tokens,
            table_id=args.table_id,
            no_normalize=args.no_normalize,
            prompt_only=args.prompt_only,
            visualize=args.vis,
            simple=args.simple,
            outdir=args.outdir,
            filename=f"{file_path.stem}_p{page + 1}_extract",
        )
        logger.info(f"Page {page + 1} done in {time.time() - start:.2f}s")


def main():
    parser = argparse.ArgumentParser(
        description="Extract structured data from document images using an LLM"
    )
    parser.add_argument("input", type=str,
                        help="Input image, PDF path, or directory")
    parser.add_argument("-s", "--schema", type=str, required=True,
                        help="Extraction schema file (YAML)")
    parser.add_argument("-m", "--model", type=str, required=True,
                        help="LLM model name")
    parser.add_argument("--api_base", type=str,
                        default="http://localhost:8000/v1")
    parser.add_argument("--api_key", type=str, default="")
    parser.add_argument("-o", "--outdir", type=str, default="results")
    parser.add_argument("-d", "--device", type=str, default="cuda",
                        help="device to use (cuda|cpu)")
    parser.add_argument("-v", "--vis", action="store_true")
    parser.add_argument("--table_id", type=str, default=None)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--max_tokens", type=int, default=4096)
    parser.add_argument("--no-normalize", action="store_true")
    parser.add_argument("--prompt-only", action="store_true")
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
