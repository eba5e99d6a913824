"""Markdown exporter (the port's copy of
yomitoku_tpu/export/export_markdown.py): markdown specials escaped, ``#``
for section headings, ``<br>`` (or strip) for line breaks, tables as pipe
grids with a dash separator after the first row, figure crops saved with
optional in-figure text.  Every element renders to an ``{"order", "md",
...}`` fragment; the document is the order-sorted join of all fragments.
"""

import re

from .figures import crop_figures

_SPECIAL_CHARS = re.compile(r"([`*{}[\]()#+!~|-])")


def escape_markdown_special_chars(text):
    return _SPECIAL_CHARS.sub(r"\\\1", text)


def _md_text(raw, ignore_line_break):
    """Escape specials, then strip or <br>-encode newlines."""
    newline = "" if ignore_line_break else "<br>"
    return escape_markdown_special_chars(raw).replace("\n", newline)


def paragraph_to_md(paragraph, ignore_line_break):
    text = _md_text(paragraph.contents, ignore_line_break)
    if paragraph.role == "section_headings":
        text = f"# {text}"
    return {"order": paragraph.order, "box": paragraph.box, "md": text + "\n"}


def table_to_md(table, ignore_line_break):
    grid = [["" for _ in range(table.n_col)] for _ in range(table.n_row)]
    for cell in table.cells:
        grid[cell.row - 1][cell.col - 1] = _md_text(
            cell.contents, ignore_line_break
        )
    rows = [f"|{'|'.join(row)}|" for row in grid]
    if rows:  # dash separator right after the header row
        rows[1:1] = [f"|{'|'.join('-' * table.n_col)}|"]
    return {
        "order": table.order,
        "box": table.box,
        "md": "".join(r + "\n" for r in rows),
    }


def figure_to_md(
    figures,
    img,
    out_path,
    export_figure_letter=False,
    ignore_line_break=False,
    width=200,
    figure_dir="figures",
):
    fragments = []
    paths = crop_figures(figures, img, out_path, figure_dir=figure_dir)
    for figure, rel_path in zip(figures, paths):
        fragments.append(
            {
                "order": figure.order,
                "md": f'<img src="{rel_path}" width="{width}px"><br>',
            }
        )
        if export_figure_letter:
            fragments += [
                {
                    "order": figure.order,
                    "md": paragraph_to_md(p, ignore_line_break)["md"],
                }
                for p in sorted(figure.paragraphs, key=lambda x: x.order)
            ]
    return fragments


def convert_markdown(
    inputs,
    out_path,
    ignore_line_break=False,
    img=None,
    export_figure_letter=False,
    export_figure=True,
    figure_width=200,
    figure_dir="figures",
):
    fragments = [table_to_md(t, ignore_line_break) for t in inputs.tables]
    fragments += [
        paragraph_to_md(p, ignore_line_break) for p in inputs.paragraphs
    ]
    if export_figure:
        fragments += figure_to_md(
            inputs.figures,
            img,
            out_path,
            export_figure_letter,
            ignore_line_break,
            figure_width,
            figure_dir=figure_dir,
        )
    fragments.sort(key=lambda f: f["order"])
    return "\n".join(f["md"] for f in fragments), fragments


def export_markdown(
    inputs,
    out_path: str,
    ignore_line_break: bool = False,
    img=None,
    export_figure_letter=False,
    export_figure=True,
    figure_width=200,
    figure_dir="figures",
    encoding: str = "utf-8",
):
    markdown, _ = convert_markdown(
        inputs,
        out_path,
        ignore_line_break,
        img,
        export_figure_letter,
        export_figure,
        figure_width,
        figure_dir,
    )
    save_markdown(markdown, out_path, encoding)
    return markdown


def save_markdown(markdown, out_path, encoding):
    with open(out_path, "w", encoding=encoding, errors="ignore") as f:
        f.write(markdown)
