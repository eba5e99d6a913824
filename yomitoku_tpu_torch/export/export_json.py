"""JSON exporter (the port's copy of yomitoku_tpu/export/export_json.py):
``model_dump`` with ensure_ascii=False, indent 4, sorted keys.
"""

import json

from .figures import crop_figures


def _strip_line_breaks_inplace(inputs):
    for table in getattr(inputs, "tables", []):
        for cell in table.cells:
            if cell.contents is not None:
                cell.contents = cell.contents.replace("\n", "")
    for paragraph in getattr(inputs, "paragraphs", []):
        if paragraph.contents is not None:
            paragraph.contents = paragraph.contents.replace("\n", "")


def convert_json(
    inputs, out_path, ignore_line_break=False, img=None, export_figure=False,
    figure_dir="figures",
):
    from ..schemas import DocumentAnalyzerSchema

    if isinstance(inputs, DocumentAnalyzerSchema):
        if ignore_line_break:
            _strip_line_breaks_inplace(inputs)
        if export_figure:
            crop_figures(inputs.figures, img, out_path, figure_dir=figure_dir)
    return inputs


def export_json(
    inputs,
    out_path,
    ignore_line_break=False,
    encoding: str = "utf-8",
    img=None,
    export_figure=False,
    figure_dir="figures",
):
    inputs = convert_json(
        inputs, out_path, ignore_line_break, img, export_figure, figure_dir
    )
    save_json(inputs.model_dump(), out_path, encoding)
    return inputs


def save_json(data, out_path, encoding):
    with open(out_path, "w", encoding=encoding, errors="ignore") as f:
        json.dump(
            data,
            f,
            ensure_ascii=False,
            indent=4,
            sort_keys=True,
            separators=(",", ": "),
        )
