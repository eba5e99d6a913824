"""HTML exporter (the port's copy of yomitoku_tpu/export/export_html.py):
escaped contents, ``<table border="1">`` with row/colspan, ``<h1>`` section
headings, lxml pretty-printing of the final document fragment.  Elements
render to ``{"order", "html", ...}`` fragments with inline f-string markup;
table rows come from grouping the (already row-sorted) cell list by
consecutive row numbers.

lxml is imported where the document is pretty-printed, so the package
imports on a machine without it; only the HTML export needs it.
"""

import re
from html import escape
from itertools import groupby


from .figures import crop_figures

_URL_RE = re.compile(r"https?://[^\s<>]")


def convert_text_to_html(text):
    """HTML-escape text (URLs kept as plain escaped text, not linkified)."""
    return _URL_RE.sub(lambda m: escape(m.group(0)), escape(text))


def _html_text(raw, ignore_line_break):
    newline = "" if ignore_line_break else "<br>"
    return convert_text_to_html(raw).replace("\n", newline)


def table_to_html(table, ignore_line_break):
    def td(cell):
        text = _html_text(cell.contents or "", ignore_line_break)
        return (
            f'<td rowspan="{cell.row_span}" colspan="{cell.col_span}">'
            f"{text}</td>"
        )

    rows = [
        f"<tr>{''.join(td(c) for c in run)}</tr>"
        for _, run in groupby(table.cells, key=lambda c: c.row)
    ] or ["<tr></tr>"]
    if table.cells and table.cells[0].row != 1:
        # byte contract: the reference's row accumulator starts at row 1,
        # so a table whose first cell sits below row 1 emits one leading
        # empty row before the first populated one
        rows.insert(0, "<tr></tr>")
    return {
        "box": table.box,
        "order": table.order,
        "html": (
            '<table border="1" style="border-collapse: collapse">'
            f"{''.join(rows)}</table>"
        ),
    }


def paragraph_to_html(paragraph, ignore_line_break):
    text = _html_text(paragraph.contents, ignore_line_break)
    if paragraph.role == "section_headings":
        text = f"<h1>{text}</h1>"
    # always <p>-wrapped — for headings lxml splits the (invalid)
    # <p><h1> nesting into an empty <p/> sibling, and that quirk is part
    # of the reference's byte-level output
    return {
        "box": paragraph.box,
        "order": paragraph.order,
        "html": f"<p>{text}</p>",
    }


def figure_to_html(
    figures,
    img,
    out_path,
    export_figure_letter=False,
    ignore_line_break=False,
    figure_dir="figures",
    width=200,
):
    fragments = []
    paths = crop_figures(figures, img, out_path, figure_dir=figure_dir)
    for figure, rel_path in zip(figures, paths):
        fragments.append(
            {
                "order": figure.order,
                "html": f'<img src="{rel_path}" width="{width}"><br>',
            }
        )
        if export_figure_letter:
            fragments += [
                {
                    "order": figure.order,
                    "html": paragraph_to_html(p, ignore_line_break)["html"],
                }
                for p in sorted(figure.paragraphs, key=lambda x: x.order)
            ]
    return fragments


def convert_html(
    inputs,
    out_path,
    ignore_line_break,
    export_figure,
    export_figure_letter,
    img=None,
    figure_width=200,
    figure_dir="figures",
):
    fragments = [table_to_html(t, ignore_line_break) for t in inputs.tables]
    fragments += [
        paragraph_to_html(p, ignore_line_break) for p in inputs.paragraphs
    ]
    if export_figure:
        fragments += figure_to_html(
            inputs.figures,
            img,
            out_path,
            export_figure_letter,
            ignore_line_break,
            width=figure_width,
            figure_dir=figure_dir,
        )
    fragments.sort(key=lambda f: f["order"])

    joined = "".join(f["html"] for f in fragments)
    if not joined:
        return "", fragments
    from lxml import etree, html as lxml_html

    parsed = lxml_html.fromstring(joined)
    return (
        etree.tostring(parsed, pretty_print=True, encoding="unicode"),
        fragments,
    )


def export_html(
    inputs,
    out_path: str,
    ignore_line_break: bool = False,
    export_figure: bool = True,
    export_figure_letter: bool = False,
    img=None,
    figure_width=200,
    figure_dir="figures",
    encoding: str = "utf-8",
):
    formatted_html, _ = convert_html(
        inputs,
        out_path,
        ignore_line_break,
        export_figure,
        export_figure_letter,
        img,
        figure_width,
        figure_dir,
    )
    save_html(formatted_html, out_path, encoding)
    return formatted_html


def save_html(html, out_path, encoding):
    with open(out_path, "w", encoding=encoding, errors="ignore") as f:
        f.write(html)
