"""CSV exporter (the port's copy of yomitoku_tpu/export/export_csv.py):
tables as grids (merged cells written once at their anchor), then
paragraphs, all sorted by reading order and separated by blank lines.  The
element-dict shape returned by ``convert_csv`` is part of the public API.
"""

import csv

from .figures import crop_figures


def _plain(raw, ignore_line_break):
    if ignore_line_break and raw is not None:
        return raw.replace("\n", "")
    return raw


def table_to_csv(table, ignore_line_break):
    grid = [["" for _ in range(table.n_col)] for _ in range(table.n_row)]
    for cell in table.cells:
        grid[cell.row - 1][cell.col - 1] = _plain(
            cell.contents, ignore_line_break
        )
    return grid


def paragraph_to_csv(paragraph, ignore_line_break):
    return _plain(paragraph.contents, ignore_line_break)


def _entry(kind, box, payload, order):
    return {"type": kind, "box": box, "element": payload, "order": order}


def convert_csv(
    inputs,
    out_path,
    ignore_line_break,
    img=None,
    export_figure: bool = True,
    export_figure_letter: bool = False,
    figure_dir="figures",
):
    entries = [
        _entry("table", t.box, table_to_csv(t, ignore_line_break), t.order)
        for t in inputs.tables
    ]
    entries += [
        _entry(
            "paragraph", p.box, paragraph_to_csv(p, ignore_line_break),
            p.order,
        )
        for p in inputs.paragraphs
    ]
    if export_figure_letter:
        # in-figure paragraphs ride their figure's reading order
        entries += [
            _entry(
                "paragraph", p.box,
                paragraph_to_csv(p, ignore_line_break), figure.order,
            )
            for figure in inputs.figures
            for p in sorted(figure.paragraphs, key=lambda x: x.order)
        ]
    entries.sort(key=lambda e: e["order"])

    if export_figure:
        crop_figures(inputs.figures, img, out_path, figure_dir=figure_dir)
    return entries


def export_csv(
    inputs,
    out_path: str,
    ignore_line_break: bool = False,
    encoding: str = "utf-8",
    img=None,
    export_figure: bool = True,
    export_figure_letter: bool = False,
    figure_dir="figures",
):
    entries = convert_csv(
        inputs,
        out_path,
        ignore_line_break,
        img,
        export_figure,
        export_figure_letter,
        figure_dir,
    )
    save_csv(entries, out_path, encoding)
    return entries


def save_csv(elements, out_path, encoding):
    with open(out_path, "w", newline="", encoding=encoding, errors="ignore") as f:
        writer = csv.writer(f, quoting=csv.QUOTE_MINIMAL)
        for element in elements:
            rows = (
                element["element"]
                if element["type"] == "table"
                else [[element["element"]]]
            )
            writer.writerows(rows)
            writer.writerow([""])
