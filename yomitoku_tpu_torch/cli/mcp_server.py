"""``yomitoku_torch_mcp`` — MCP server exposing the port's OCR over
RESOURCE_DIR files (the port's copy of yomitoku_tpu/cli/mcp_server.py).

FastMCP with a ``process_ocr(filename, output_format)`` tool
(json/markdown/html/csv), a ``file://list`` resource, stdio/sse
transports, and a lazily-built global DocumentAnalyzer on the card
(``device="cuda"``) with per-page progress.  As in the JAX server, every
page's export is given the last page's image.

The ``mcp`` package is an optional extra; importing this module without it
raises with an install hint.
"""

import csv
import io
import json
import os
from argparse import ArgumentParser
from pathlib import Path

try:
    from mcp.server.fastmcp import Context, FastMCP
except ImportError as e:  # pragma: no cover - depends on optional extra
    raise ImportError(
        "The 'mcp' package is required for the MCP server. "
        "Install the mcp extra (pip install 'yomitoku-tpu[mcp]')."
    ) from e

from ..data.functions import load_image, load_pdf
from ..document_analyzer import DocumentAnalyzer
from ..export import convert_csv, convert_html, convert_json, convert_markdown

try:
    RESOURCE_DIR = os.environ["RESOURCE_DIR"]
except KeyError:
    raise ValueError("Environment variable 'RESOURCE_DIR' is not set.")

analyzer = None


async def load_analyzer(ctx: Context) -> DocumentAnalyzer:
    global analyzer
    if analyzer is None:
        await ctx.info("Load document analyzer")
        analyzer = DocumentAnalyzer(visualize=False, device="cuda")
    return analyzer


mcp = FastMCP("yomitoku")


@mcp.tool()
async def process_ocr(ctx: Context, filename: str, output_format: str) -> str:
    """Perform OCR on a file in the resource directory and return the
    result in the requested format (json, markdown, html, or csv)."""
    analyzer = await load_analyzer(ctx)
    await ctx.info("Start ocr processing")

    file_path = os.path.join(RESOURCE_DIR, filename)
    if Path(file_path).suffix[1:].lower() == "pdf":
        imgs = load_pdf(file_path)
    else:
        imgs = load_image(file_path)

    results = []
    img = None
    for page, img in enumerate(imgs):
        result, _, _ = await analyzer.run(img)
        results.append(result)
        await ctx.report_progress(page + 1, len(imgs))

    if output_format == "json":
        return json.dumps(
            [
                convert_json(
                    result, out_path=None, ignore_line_break=True, img=img,
                    export_figure=False, figure_dir=None,
                ).model_dump()
                for result in results
            ],
            ensure_ascii=False,
            sort_keys=True,
            separators=(",", ": "),
        )
    elif output_format == "markdown":
        return "\n".join(
            convert_markdown(
                result, out_path=None, ignore_line_break=True, img=img,
                export_figure=False,
            )[0]
            for result in results
        )
    elif output_format == "html":
        return "\n".join(
            convert_html(
                result, out_path=None, ignore_line_break=True, img=img,
                export_figure=False, export_figure_letter="",
            )[0]
            for result in results
        )
    elif output_format == "csv":
        output = io.StringIO()
        writer = csv.writer(output, quoting=csv.QUOTE_MINIMAL)
        for result in results:
            elements = convert_csv(
                result, out_path=None, ignore_line_break=True, img=img,
                export_figure=False,
            )
            for element in elements:
                if element["type"] == "table":
                    writer.writerows(element["element"])
                else:
                    writer.writerow([element["element"]])
                writer.writerow([""])
        return output.getvalue()
    raise ValueError(
        f"Unsupported output format: {output_format}. "
        "Supported formats are json, markdown, html or csv."
    )


@mcp.resource("file://list")
async def get_file_list() -> list:
    """List files in the resource directory."""
    return os.listdir(RESOURCE_DIR)


def run_mcp_server(transport="stdio", mount_path=None):
    if transport == "stdio":
        mcp.run()
    elif transport == "sse":
        mcp.run(transport=transport, mount_path=mount_path)


def main():
    parser = ArgumentParser(description="Run the MCP server.")
    parser.add_argument(
        "--transport", "-t", type=str, default="stdio",
        choices=["stdio", "sse"],
    )
    parser.add_argument("--mount_path", "-m", type=str, default=None)
    args = parser.parse_args()
    run_mcp_server(transport=args.transport, mount_path=args.mount_path)


if __name__ == "__main__":
    main()
