"""The port's reading order and its JSON, Markdown, CSV and HTML exporters
against the JAX package's, on the same inputs: the cases of
tests/test_reading_order.py (random layouts, every direction) and of
tests/test_export.py and tests/test_export_edge_cases.py (escaping, span
holes, line breaks, headings, figures with and without their text, the
in-place JSON strip, encodings), parametrised.  Each document is built
from one dict in both packages' schemas; the files written, the figure
crops and the values returned must be equal byte for byte."""

import copy
import json
from importlib import import_module

import numpy as np
import pytest

from test_reading_order import _Para, _random_boxes
from yomitoku_tpu import export as jax_export
from yomitoku_tpu import schemas as jax_schemas
from yomitoku_tpu.reading_order import prediction_reading_order as jax_order
from yomitoku_tpu_torch import export as port_export
from yomitoku_tpu_torch import schemas as port_schemas
from yomitoku_tpu_torch.reading_order import prediction_reading_order as port_order

# the modules themselves: each package's export/__init__ binds their names
# to the export functions
jax_csv, jax_html, jax_md, port_csv, port_html, port_md = (
    import_module(f"{pkg}.export.{mod}")
    for pkg in ("yomitoku_tpu", "yomitoku_tpu_torch")
    for mod in ("export_csv", "export_html", "export_markdown"))

# ------------------------------------------------------------ reading order


@pytest.mark.parametrize("direction", ["top2bottom", "right2left", "left2right"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 2, 5, 12, 30])
def test_reading_order_matches_jax(direction, seed, n):
    boxes = _random_boxes(np.random.RandomState(seed * 100 + n), n)
    got, want = [_Para(b) for b in boxes], [_Para(b) for b in boxes]
    assert port_order(got, direction) is got
    jax_order(want, direction)
    assert [e.order for e in got] == [e.order for e in want]


def test_reading_order_rejects_unknown_direction():
    boxes = [[0, 0, 10, 10], [0, 20, 10, 30]]
    for order in (port_order, jax_order):
        with pytest.raises(ValueError, match="Invalid direction"):
            order([_Para(b) for b in boxes], "bottom2top")


# ---------------------------------------------------------------- documents


def _cell(row, col, box, contents, row_span=1, col_span=1):
    return dict(row=row, col=col, row_span=row_span, col_span=col_span,
                box=box, contents=contents)


def _line(box):
    return dict(box=box, score=0.9)


def _table(box, n_row, n_col, cells, order):
    return dict(box=box, n_row=n_row, n_col=n_col, rows=[_line(box)],
                cols=[_line(box)], spans=[], cells=cells, order=order)


def _para(box, contents, order, role=None, direction="horizontal"):
    return dict(box=box, contents=contents, direction=direction, order=order,
                role=role)


def _word(points, content):
    return dict(points=points, content=content, direction="horizontal",
                det_score=0.98, rec_score=0.99)


#: tests/test_export.py's document: a 2x2 table with a merged cell, a
#: paragraph with markdown specials, a section heading
MAKE_DOC = dict(
    paragraphs=[_para([0, 30, 50, 40], "hello *world*", 0),
                _para([0, 50, 50, 60], "Heading", 2, "section_headings")],
    tables=[_table([0, 0, 20, 20], 2, 2, [
        _cell(1, 1, [0, 0, 10, 10], "h1"),
        _cell(1, 2, [10, 0, 20, 10], "h2"),
        _cell(2, 1, [0, 10, 20, 20], "wide\ncell", col_span=2),
    ], 1)],
    words=[_word([[0, 30], [50, 30], [50, 40], [0, 40]], "hello")],
    figures=[],
)

#: tests/test_export_edge_cases.py's row-span table: (1, 1) spans two rows,
#: (2, 1) is the hole
ROWSPAN = _table([0, 0, 100, 100], 2, 2, [
    _cell(1, 1, [0, 0, 10, 10], "dummy\n", row_span=2),
    _cell(1, 2, [0, 0, 10, 10], "dummy\n"),
    _cell(2, 2, [0, 0, 10, 10], "a|b\n"),
], 0)

ESCAPES = [
    "これはテストです。<p>がんばりましょう。</p>",
    "これはテストです。https://www.google.com",
    "これはテストです。<a href='https://www.google.com'>Google</a>\n",
    "![image](https://www.google.com)",
    "**これはテストです**",
    "- これはテストです",
    "1. これはテストです",
    "| これはテストです",
    "```python\nprint('Hello, World!')\n```",
    "テスト☃\n",
]

FIGURE_PARAS = [_para([12, 12, 40, 20], "図の\n説明", 1),
                _para([12, 24, 40, 32], "<b>two</b>", 0, direction="vertical")]

DOCS = {
    "make_doc": MAKE_DOC,
    "rowspan": dict(paragraphs=[_para([0, 0, 10, 10], "dummy\n", 0)],
                    tables=[ROWSPAN], words=[], figures=[]),
    "escapes": dict(
        paragraphs=[_para([0, 10 * i, 40, 10 * i + 8], text, i,
                          "section_headings" if i % 3 == 0 else None)
                    for i, text in enumerate(ESCAPES)],
        tables=[], words=[], figures=[]),
    # a table whose first cell sits below row 1, and an empty table
    "late_rows": dict(paragraphs=[], words=[], figures=[], tables=[
        _table([0, 0, 40, 40], 3, 1, [_cell(2, 1, [0, 10, 40, 20], "x"),
                                      _cell(3, 1, [0, 20, 40, 30], "")], 0),
        _table([0, 50, 40, 60], 0, 0, [], 1)]),
    "figures": dict(
        paragraphs=[_para([0, 60, 50, 70], "after", 2)],
        tables=[_table([0, 75, 30, 95], 1, 1, [_cell(1, 1, [0, 75, 30, 95], "c")], 0)],
        words=[],
        figures=[dict(box=[10, 10, 45, 35], order=1, direction="horizontal",
                      paragraphs=FIGURE_PARAS),
                 dict(box=[2, 40, 20, 58], order=3, direction="vertical",
                      paragraphs=[])]),
    "empty": dict(paragraphs=[], tables=[], words=[], figures=[]),
}


def _pair(name):
    """The document in the JAX package's schema and in the port's."""
    d = DOCS[name]
    return (jax_schemas.DocumentAnalyzerSchema.model_validate(copy.deepcopy(d)),
            port_schemas.DocumentAnalyzerSchema.model_validate(copy.deepcopy(d)))


def _page():
    return np.random.default_rng(0).integers(0, 255, (100, 60, 3), dtype=np.uint8)


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


FORMATS = {"json": "to_json", "markdown": "to_markdown", "csv": "to_csv",
           "html": "to_html"}


@pytest.mark.parametrize("ignore_line_break", [False, True])
@pytest.mark.parametrize("export_figure", [False, True])
@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("doc", list(DOCS))
def test_exporter_matches_jax(tmp_path, doc, fmt, export_figure, ignore_line_break):
    """The written file, the figure crops and the returned value."""
    method = FORMATS[fmt]
    kwargs = dict(ignore_line_break=ignore_line_break, export_figure=export_figure,
                  img=_page())
    results = []
    for side, schema in zip(("jax", "port"), _pair(doc)):
        out = tmp_path / side / f"page.{fmt}"
        out.parent.mkdir()
        ret = getattr(schema, method)(str(out), **kwargs)
        results.append((_tree(out.parent), ret.model_dump() if fmt == "json" else ret))
    (want_files, want_ret), (got_files, got_ret) = results
    assert got_files == want_files
    assert got_ret == want_ret
    if export_figure and DOCS[doc]["figures"]:
        assert any(k.startswith("figures/") for k in got_files)


@pytest.mark.parametrize("fmt", ["markdown", "csv", "html"])
def test_figure_letter_matches_jax(tmp_path, fmt):
    """The figures' own paragraphs written in reading order after each
    figure (export_figure_letter), with a narrower figure width where the
    format takes one."""
    module = {"markdown": (jax_md.export_markdown, port_md.export_markdown),
              "csv": (jax_csv.export_csv, port_csv.export_csv),
              "html": (jax_html.export_html, port_html.export_html)}[fmt]
    extra = {} if fmt == "csv" else {"figure_width": 120}
    files = []
    for side, export, schema in zip(("jax", "port"), module, _pair("figures")):
        out = tmp_path / side / f"page.{fmt}"
        out.parent.mkdir()
        export(schema, str(out), img=_page(), export_figure_letter=True,
               figure_dir="figs", **extra)
        files.append(_tree(out.parent))
    assert files[1] == files[0]
    assert "figs/page_figure_1.png" in files[1]


@pytest.mark.parametrize("encoding", ["utf-8", "cp932"])
@pytest.mark.parametrize("fmt", ["json", "markdown", "csv", "html"])
def test_encoding_matches_jax(tmp_path, fmt, encoding):
    """Characters the encoding cannot hold are dropped, as the JAX
    writers drop them."""
    name = {"json": "export_json", "markdown": "export_markdown",
            "csv": "export_csv", "html": "export_html"}[fmt]
    files = []
    for side, module, schema in zip(("jax", "port"), (jax_export, port_export),
                                    _pair("escapes")):
        out = tmp_path / side / f"page.{fmt}"
        out.parent.mkdir()
        getattr(module, name)(schema, str(out), encoding=encoding)
        files.append(_tree(out.parent))
    assert files[1] == files[0]


SCHEMAS = {
    # name -> (schema class name, fields)
    "ocr": ("OCRSchema", dict(words=MAKE_DOC["words"])),
    "element": ("Element", dict(id=None, box=[0, 0, 10, 10], score=0.9, role=None,
                                contents=None)),
    "tsr": ("TableStructureRecognizerSchema", ROWSPAN),
    "paragraph": ("ParagraphSchema", _para([0, 0, 10, 10], "dummy\n", 0)),
    "figure": ("FigureSchema", DOCS["figures"]["figures"][0]),
    "document_analyzer": ("DocumentAnalyzerSchema", MAKE_DOC),
}


@pytest.mark.parametrize("name", list(SCHEMAS))
def test_schema_to_json_matches_jax(tmp_path, name):
    """Every schema writes itself as JSON, as the JAX package's do; the file
    reads back as ``model_dump``."""
    cls, fields = SCHEMAS[name]
    files = []
    for side, schemas in (("jax", jax_schemas), ("port", port_schemas)):
        obj = getattr(schemas, cls).model_validate(copy.deepcopy(fields))
        out = tmp_path / f"{side}.json"
        obj.to_json(str(out))
        files.append(out.read_bytes())
    assert files[1] == files[0]
    assert json.loads(files[1]) == obj.model_dump()


def test_convert_json_strips_in_place_as_jax():
    (want, got), = [_pair("rowspan")]
    for ignore in (False, True):
        jax_export.convert_json(want, None, ignore_line_break=ignore)
        port_export.convert_json(got, None, ignore_line_break=ignore)
        assert got.model_dump() == want.model_dump()
    assert got.paragraphs[0].contents == "dummy"


def test_figures_need_the_page(tmp_path):
    """Saving figures without the page raises (the JAX package asserts)."""
    _, doc = _pair("figures")
    with pytest.raises(ValueError, match="img is required"):
        doc.to_markdown(str(tmp_path / "page.md"))


# ------------------------------------------------------ element renderers


@pytest.mark.parametrize("text", ESCAPES)
def test_text_escapes_match_jax(text):
    assert port_html.convert_text_to_html(text) == jax_html.convert_text_to_html(text)
    assert (port_md.escape_markdown_special_chars(text)
            == jax_md.escape_markdown_special_chars(text))


@pytest.mark.parametrize("ignore_line_break", [False, True])
@pytest.mark.parametrize("role", [None, "section_headings"])
@pytest.mark.parametrize("text", ESCAPES)
def test_paragraph_renderers_match_jax(text, role, ignore_line_break):
    want = jax_schemas.ParagraphSchema.model_validate(_para([0, 0, 10, 10], text, 0, role))
    got = port_schemas.ParagraphSchema.model_validate(_para([0, 0, 10, 10], text, 0, role))
    for port_fn, jax_fn in ((port_html.paragraph_to_html, jax_html.paragraph_to_html),
                            (port_md.paragraph_to_md, jax_md.paragraph_to_md),
                            (port_csv.paragraph_to_csv, jax_csv.paragraph_to_csv)):
        assert port_fn(got, ignore_line_break) == jax_fn(want, ignore_line_break)


@pytest.mark.parametrize("ignore_line_break", [False, True])
@pytest.mark.parametrize("table", ["make_doc", "rowspan", "late_rows"])
def test_table_renderers_match_jax(table, ignore_line_break):
    want, got = _pair(table)
    for port_fn, jax_fn in ((port_html.table_to_html, jax_html.table_to_html),
                            (port_md.table_to_md, jax_md.table_to_md),
                            (port_csv.table_to_csv, jax_csv.table_to_csv)):
        for g, w in zip(got.tables, want.tables):
            assert port_fn(g, ignore_line_break) == jax_fn(w, ignore_line_break)
