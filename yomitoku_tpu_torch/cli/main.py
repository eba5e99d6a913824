"""``yomitoku_torch`` console entry point: the port's copy of
yomitoku_tpu/cli/main.py, with its flag surface.

A PDF is rendered by the port's own PDF engine (``data.pdf``, host C++
built at first use), each page goes through the port's
``DocumentAnalyzer`` (``analyzer.batch`` in chunks of 4 pages), and the
result is written as JSON, CSV, HTML, Markdown or a searchable PDF.
``--num_devices`` reaches the analyzer as in the JAX CLI: above 1 its
``batch`` takes the page axis, over one replica per card where two or
more take part.

Differences from the JAX CLI:

* ``-d/--device`` defaults to ``"cuda"`` (``cuda|cpu``); any other value
  raises (``base.resolve_device``), and asking for CUDA where there is no
  card raises rather than running on the CPU.
* ``--lite`` takes ``parseq-tiny`` and ``dbnetv2_1-lite``, as there.
* The directory loop.  The JAX CLI passes over any exception of a file
  (``except Exception: continue``), which would hide a kernel or device
  failure.  Here a file that fails to load, parse or export is logged
  with its traceback and skipped, but a ``KernelBuildError`` or an error
  raised on the card (``torch.AcceleratorError``, a CUDA out-of-memory
  error, a ``RuntimeError`` that names CUDA) ends the run with a non-zero
  exit.
"""

import argparse
import os
import re
import time
from pathlib import Path

import torch

from ..constants import SUPPORT_OUTPUT_FORMAT
from ..data.functions import load_image, load_pdf
from ..base import resolve_device
from ..document_analyzer import DocumentAnalyzer
from ..export import (
    convert_csv,
    convert_html,
    convert_json,
    convert_markdown,
    save_csv,
    save_html,
    save_json,
    save_markdown,
)
from ..ops._build import KernelBuildError
from ..utils.logger import set_logger
from ..utils.misc import save_image
from ..utils.searchable_pdf import create_searchable_pdf

logger = set_logger(__name__, "INFO")


def merge_all_pages(results):
    out = None
    for result in results:
        fmt = result["format"]
        data = result["data"]
        if fmt in ("json", "pdf"):
            out = [data] if out is None else out + [data]
        elif fmt == "csv":
            out = data if out is None else out + data
        elif fmt in ("html", "md"):
            out = data if out is None else out + "\n" + data
    return out


def save_merged_file(out_path, args, out, imgs):
    if args.format == "json":
        save_json(out, out_path, args.encoding)
    elif args.format == "csv":
        save_csv(out, out_path, args.encoding)
    elif args.format == "html":
        save_html(out, out_path, args.encoding)
    elif args.format == "md":
        save_markdown(out, out_path, args.encoding)
    elif args.format == "pdf":
        create_searchable_pdf(
            list(imgs),
            out,
            output_path=out_path,
            font_path=args.font_path,
            image_quality=args.pdf_quality,
        )


def validate_encoding(encoding):
    if encoding not in ["utf-8", "utf-8-sig", "shift-jis", "euc-jp", "cp932"]:
        raise ValueError(f"Invalid encoding: {encoding}")
    return True


def parse_pages(pages_str):
    pages = set()
    for part in pages_str.split(","):
        if "-" in part:
            start, end = map(int, part.split("-"))
            pages.update(range(start, end + 1))
        else:
            pages.add(int(part))
    return sorted(pages)


def _sanitize_path_component(component):
    if not component:
        return component
    return re.sub(r"^\.+", lambda m: "_" * len(m.group(0)), component)


def process_single_file(args, analyzer, path, format):
    if path.suffix[1:].lower() == "pdf":
        imgs = load_pdf(path, dpi=args.dpi)
    else:
        imgs = load_image(path)

    target_pages = range(1, len(imgs) + 1)
    if args.pages is not None:
        target_pages = parse_pages(args.pages)

    format_results = []
    processed_imgs = []
    dirname = _sanitize_path_component(path.parent.name)
    filename = path.stem
    # pipeline consecutive pages: one page's host stages overlap the
    # next page's device programs/transfers.  Chunked so lazy PDF page
    # iterators stay OOM-safe on huge documents.
    def _pipelined_pages(chunk=4):
        window = []
        for page, img in enumerate(imgs):
            if (page + 1) not in target_pages:
                continue
            window.append((page, img))
            if len(window) == chunk:
                for item, out in zip(window, analyzer.batch([i for _, i in window])):
                    yield item, out
                window = []
        for item, out in zip(window, analyzer.batch([i for _, i in window])):
            yield item, out

    for (page, img), (result, ocr, layout) in _pipelined_pages():
        processed_imgs.append(img)

        if ocr is not None:
            out_path = os.path.join(
                args.outdir, f"{dirname}_{filename}_p{page + 1}_ocr.jpg"
            )
            save_image(ocr, out_path)
            logger.info(f"Output file: {out_path}")
        if layout is not None:
            out_path = os.path.join(
                args.outdir, f"{dirname}_{filename}_p{page + 1}_layout.jpg"
            )
            save_image(layout, out_path)
            logger.info(f"Output file: {out_path}")

        out_path = os.path.join(
            args.outdir, f"{dirname}_{filename}_p{page + 1}.{format}"
        )

        if format == "json":
            if args.combine:
                data = convert_json(
                    result, out_path, args.ignore_line_break, img,
                    args.figure, args.figure_dir,
                ).model_dump()
            else:
                data = result.to_json(
                    out_path,
                    ignore_line_break=args.ignore_line_break,
                    encoding=args.encoding,
                    img=img,
                    export_figure=args.figure,
                    figure_dir=args.figure_dir,
                ).model_dump()
            format_results.append({"format": format, "data": data})
        elif format == "csv":
            if args.combine:
                data = convert_csv(
                    result, out_path, args.ignore_line_break, img,
                    args.figure, args.figure_letter, args.figure_dir,
                )
            else:
                data = result.to_csv(
                    out_path,
                    ignore_line_break=args.ignore_line_break,
                    encoding=args.encoding,
                    img=img,
                    export_figure=args.figure,
                    export_figure_letter=args.figure_letter,
                    figure_dir=args.figure_dir,
                )
            format_results.append({"format": format, "data": data})
        elif format == "html":
            if args.combine:
                data, _ = convert_html(
                    result, out_path,
                    ignore_line_break=args.ignore_line_break, img=img,
                    export_figure=args.figure,
                    export_figure_letter=args.figure_letter,
                    figure_width=args.figure_width,
                    figure_dir=args.figure_dir,
                )
            else:
                data = result.to_html(
                    out_path,
                    ignore_line_break=args.ignore_line_break,
                    img=img,
                    export_figure=args.figure,
                    export_figure_letter=args.figure_letter,
                    figure_width=args.figure_width,
                    figure_dir=args.figure_dir,
                    encoding=args.encoding,
                )
            format_results.append({"format": format, "data": data})
        elif format == "md":
            if args.combine:
                data, _ = convert_markdown(
                    result, out_path,
                    ignore_line_break=args.ignore_line_break, img=img,
                    export_figure=args.figure,
                    export_figure_letter=args.figure_letter,
                    figure_width=args.figure_width,
                    figure_dir=args.figure_dir,
                )
            else:
                data = result.to_markdown(
                    out_path,
                    ignore_line_break=args.ignore_line_break,
                    img=img,
                    export_figure=args.figure,
                    export_figure_letter=args.figure_letter,
                    figure_width=args.figure_width,
                    figure_dir=args.figure_dir,
                    encoding=args.encoding,
                )
            format_results.append({"format": format, "data": data})
        elif format == "pdf":
            if not args.combine:
                create_searchable_pdf(
                    [img],
                    [result],
                    output_path=out_path,
                    font_path=args.font_path,
                    image_quality=args.pdf_quality,
                )
            format_results.append({"format": format, "data": result})

    out = merge_all_pages(format_results)
    if args.combine and format_results:
        out_path = os.path.join(args.outdir, f"{dirname}_{filename}.{format}")
        save_merged_file(out_path, args, out, processed_imgs)


def is_device_fault(exc):
    """Whether ``exc`` (or an exception it was raised from) is a kernel
    build failure or an error raised on the card: those end a directory
    run, where a file that fails to load or parse is skipped."""
    accel = getattr(torch, "AcceleratorError", None)
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, (KernelBuildError, torch.cuda.OutOfMemoryError)):
            return True
        if accel is not None and isinstance(exc, accel):
            return True
        if isinstance(exc, RuntimeError) and "CUDA" in str(exc):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("arg1", type=str,
                        help="path of target image file or directory")
    parser.add_argument("-f", "--format", type=str, default="json",
                        help="output format type (json|csv|html|md|pdf)")
    parser.add_argument("-v", "--vis", action="store_true",
                        help="visualize the result")
    parser.add_argument("-o", "--outdir", type=str, default="results",
                        help="output directory")
    parser.add_argument("-l", "--lite", action="store_true",
                        help="use lite models")
    parser.add_argument("-d", "--device", type=str, default="cuda",
                        help="device to use (cuda|cpu)")
    parser.add_argument("--td_cfg", type=str, default=None)
    parser.add_argument("--tr_cfg", type=str, default=None)
    parser.add_argument("--lp_cfg", type=str, default=None)
    parser.add_argument("--tsr_cfg", type=str, default=None)
    parser.add_argument("--tr_name", type=str, default="parseq-large-v4_1")
    parser.add_argument("--td_name", type=str, default="dbnetv2_1")
    parser.add_argument("--ignore_line_break", action="store_true")
    parser.add_argument("--figure", action="store_true")
    parser.add_argument("--figure_letter", action="store_true")
    parser.add_argument("--figure_width", type=int, default=200)
    parser.add_argument("--figure_dir", type=str, default="figures")
    parser.add_argument("--encoding", type=str, default="utf-8")
    parser.add_argument("--combine", action="store_true")
    parser.add_argument("--ignore_meta", action="store_true")
    parser.add_argument("--reading_order", default="auto", type=str,
                        choices=["auto", "left2right", "top2bottom",
                                 "right2left"])
    parser.add_argument("--font_path", default=None, type=str)
    parser.add_argument("--pdf_quality", type=str, default="high",
                        choices=["high", "middle", "low"])
    parser.add_argument("--dpi", type=int, default=200)
    parser.add_argument("--pages", type=str, default=None)
    parser.add_argument("--enable-rec-orientation-fallback",
                        action="store_true")
    parser.add_argument("--rec-orientation-fallback-thresh", type=float,
                        default=0.75)
    parser.add_argument("--ignore_ruby", action="store_true")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="number of cards (1: the port runs on one "
                             "card; more raises)")
    parser.add_argument("--ruby_threshold", type=float, default=1.0)
    return parser


def main():
    args = build_parser().parse_args()

    path = Path(args.arg1)
    if not path.exists():
        raise FileNotFoundError(f"File not found: {args.arg1}")

    format = args.format.lower()
    if format not in SUPPORT_OUTPUT_FORMAT:
        raise ValueError(
            f"Invalid output format: {args.format}. "
            f"Supported formats are {SUPPORT_OUTPUT_FORMAT}"
        )
    if (
        args.font_path is not None
        and not os.path.exists(args.font_path)
        and format == "pdf"
    ):
        raise FileNotFoundError(f"Font file not found: {args.font_path}")
    validate_encoding(args.encoding)
    resolve_device(args.device)
    if format == "markdown":
        format = "md"
    args.format = format

    configs = {
        "ocr": {
            "text_detector": {"path_cfg": args.td_cfg},
            "text_recognizer": {"path_cfg": args.tr_cfg},
        },
        "layout_analyzer": {
            "layout_parser": {"path_cfg": args.lp_cfg},
            "table_structure_recognizer": {"path_cfg": args.tsr_cfg},
        },
    }
    if args.lite:
        # lite = tiny recognizer + reduced-resolution detector (same
        # weights), as in the JAX CLI
        configs["ocr"]["text_recognizer"]["model_name"] = "parseq-tiny"
        configs["ocr"]["text_detector"]["model_name"] = "dbnetv2_1-lite"
    else:
        configs["ocr"]["text_recognizer"]["model_name"] = args.tr_name
        configs["ocr"]["text_detector"]["model_name"] = args.td_name
    if args.enable_rec_orientation_fallback:
        configs["ocr"]["text_recognizer"]["rec_orientation_fallback"] = True
        configs["ocr"]["text_recognizer"][
            "rec_orientation_fallback_thresh"
        ] = args.rec_orientation_fallback_thresh

    analyzer = DocumentAnalyzer(
        configs=configs,
        visualize=args.vis,
        device=args.device,
        num_devices=args.num_devices,
        ignore_meta=args.ignore_meta,
        reading_order=args.reading_order,
        ignore_ruby=args.ignore_ruby,
        ruby_threshold=args.ruby_threshold,
    )

    os.makedirs(args.outdir, exist_ok=True)
    logger.info(f"Output directory: {args.outdir}")

    if path.is_dir():
        for f in [f for f in path.rglob("*") if f.is_file()]:
            try:
                start = time.time()
                logger.info(f"Processing file: {f}")
                process_single_file(args, analyzer, Path(f), format)
                logger.info(
                    f"Total Processing time: {time.time() - start:.2f} sec"
                )
            except Exception as e:
                if is_device_fault(e):
                    raise
                logger.exception(f"Skipped file: {f}")
    else:
        start = time.time()
        logger.info(f"Processing file: {path}")
        process_single_file(args, analyzer, path, format)
        logger.info(f"Total Processing time: {time.time() - start:.2f} sec")


if __name__ == "__main__":
    main()
