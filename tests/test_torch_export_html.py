"""The port's HTML printer (``export/html_tree.py``) against lxml, which the
JAX package prints its HTML with.  ``convert_html`` byte-equal to the JAX
package's on the documents of tests/test_torch_export.py under every flag;
lxml's quirks on hand-written markup, one case each; documents generated
by hypothesis (paragraphs and cells drawn from the recognizer's charsets
joined with line breaks, headings, empty and whitespace-only contents,
tables with spans and late first rows, figures with their text and figure
directories whose names hold spaces, ``&`` and non-ASCII), and fragments
of its tag set nested and closed in any order; markup outside the
exporter's set raising; and a process where ``import lxml`` fails, in
which ``convert_html`` and the CLI's ``-f html`` (the small yaml configs,
``-d cpu``) give the bytes that this process computes with lxml."""

import copy
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from lxml import etree
from lxml import html as lxml_html

from test_torch_export import DOCS, _page, _pair, jax_html, port_html
from yomitoku_tpu import schemas as jax_schemas
from yomitoku_tpu_torch import schemas as port_schemas
from yomitoku_tpu_torch.export.html_tree import pretty_print

ROOT = Path(__file__).resolve().parents[1]
RESOURCE = ROOT / "yomitoku_tpu_torch" / "resource"


def lxml_print(markup):
    return etree.tostring(lxml_html.fromstring(markup), pretty_print=True,
                          encoding="unicode")


def _convert(schema, module, out_dir, **flags):
    out_dir.mkdir(parents=True, exist_ok=True)
    return module.convert_html(schema, str(out_dir / "page.html"), **flags)


# ---------------------------------------------------------------- documents


@pytest.mark.parametrize("export_figure_letter", [False, True])
@pytest.mark.parametrize("ignore_line_break", [False, True])
@pytest.mark.parametrize("export_figure", [False, True])
@pytest.mark.parametrize("doc", list(DOCS))
def test_convert_html_matches_jax(tmp_path, doc, export_figure, ignore_line_break,
                                  export_figure_letter):
    """The printed document and the fragments, on each document of the
    exporter tests."""
    flags = dict(ignore_line_break=ignore_line_break, export_figure=export_figure,
                 export_figure_letter=export_figure_letter, img=_page())
    want_doc, got_doc = _pair(doc)
    want = _convert(want_doc, jax_html, tmp_path / "jax", **flags)
    got = _convert(got_doc, port_html, tmp_path / "port", **flags)
    assert got == want


# ------------------------------------------------------------------- quirks

_TABLE = '<table border="1" style="border-collapse: collapse">'
_TD = '<td rowspan="1" colspan="1">'

#: markup -> what lxml prints for it, as the exporter can write it
QUIRKS = {
    # the wrapper: one element alone, several in a div (a span where none
    # is a block element), a closing newline
    "one_element": ("<p>a</p>", "<p>a</p>\n"),
    "two_elements": ("<p>a</p><p>b</p>", "<div>\n  <p>a</p>\n  <p>b</p>\n</div>\n"),
    "figures_only": ('<img src="f/p.png" width="200"><br>',
                     '<span>\n  <img src="f/p.png" width="200"/>\n  <br/>\n</span>\n'),
    "figure_then_table": ('<img src="f/p.png" width="200"><br>' + _TABLE + "<tr></tr></table>",
                          None),
    # serialised as XML: empty elements close themselves
    "empty_p": ("<p></p>", "<p/>\n"),
    "empty_td": (_TABLE + "<tr>" + _TD + "</td></tr></table>", None),
    "empty_table": (_TABLE + "<tr></tr></table>", None),
    "empty_heading": ("<p><h1></h1></p>", "<div>\n  <p/>\n  <h1/>\n</div>\n"),
    # headings: <p><h1> splits, the </p> is dropped
    "heading": ("<p><h1>x</h1></p>", "<div>\n  <p/>\n  <h1>x</h1>\n</div>\n"),
    "heading_between": ("<p>a</p><p><h1>x<br>y</h1></p><p>b</p>", None),
    "heading_line_breaks_only": ("<p><h1><br><br></h1></p>", None),
    # escapes decoded, then written again: only &, < and > in text
    "text_escapes": ("<p>&quot;&#x27;&amp;&lt;&gt;</p>", "<p>\"'&amp;&lt;&gt;</p>\n"),
    "url_double_escape": ("<p>http://&amp;amp;x</p>", None),
    "soft_hyphen": ("<p>a\xadb</p>", "<p>a\xadb</p>\n"),
    "raw_ampersand_in_src": ('<img src="a&b/p.png" width="200"><br>', None),
    "entity_name_in_src": ('<img src="a&not/p.png" width="200"><br>', None),
    "entity_prefix_in_src": ('<img src="a&notx/p.png" width="200"><br>', None),
    "entity_before_equals": ('<img src="a&not=/p.png" width="200"><br>', None),
    "entity_with_semicolon": ('<img src="a&amp;b&lt;/p.png" width="200"><br>', None),
    "markup_signs_in_src": ('<img src="a<b>\'c/p.png" width="200"><br>', None),
    "space_non_ascii_src": ('<img src="図 の&dir/p.png" width="200"><br>', None),
    "tab_in_src": ('<img src="a\tb/p.png" width="200"><br>', None),
    # indentation: only where all of an element's content is elements
    "text_and_break": ("<p>a<br>b</p>", "<p>a<br/>b</p>\n"),
    "only_space": ("<p> </p>", "<p> </p>\n"),
    "only_a_break": ("<p><br></p>", "<p>\n  <br/>\n</p>\n"),
    "break_then_space": ("<p><br> </p>", "<p><br/> </p>\n"),
    "space_between_breaks": ("<p>a<br> <br>b</p>", None),
    "td_only_a_break": (_TABLE + "<tr>" + _TD + "<br></td></tr></table>", None),
    "td_only_space": (_TABLE + "<tr>" + _TD + " </td>" + _TD + "<br><br></td></tr></table>",
                      None),
    "nested_in_wrapper": ("<p>a</p>" + _TABLE + "<tr>" + _TD + "<br></td></tr></table>", None),
    # tables: spans, and the leading empty row of a late first row
    "leading_empty_row": (_TABLE + '<tr></tr><tr><td rowspan="2" colspan="3">x</td></tr>'
                          "</table>", None),
    "ideographic_space": ("<p>　</p>", None),
    # libxml2 indents at most 30 levels
    "deep_nesting": ("<p>x</p>" + "<table><tr><td>" * 12 + "<br>" + "</td></tr></table>" * 12,
                     None),
    # lxml counts table parts as blocks too (not written at the top level
    # by the exporter, but read the same way)
    "table_part_at_top": ('<img src="a" width="200"><tr></tr>', None),
    "tab_in_text": ("<p>a\tb</p>", None),
}


@pytest.mark.parametrize("case", list(QUIRKS))
def test_quirks_match_lxml(case):
    markup, literal = QUIRKS[case]
    want = lxml_print(markup)
    if literal is not None:
        assert want == literal
    assert pretty_print(markup) == want


#: markup the exporter never writes: the reader refuses it
OUTSIDE = {
    "other_tag": "<div>a</div>",
    "upper_case": "<P>a</P>",
    "single_quotes": "<p class='a'>x</p>",
    "bare_attribute": '<td rowspan=1 colspan="1">x</td>',
    "repeated_attribute": '<img src="a" src="b">',
    "other_entity": "<p>&nbsp;</p>",
    "numeric_entity": "<p>&#38;</p>",
    "raw_ampersand_in_text": "<p>a & b</p>",
    "numeric_reference_in_src": '<img src="a&#38;b">',
    "quote_in_src": '<img src="a"b" width="200">',
    "carriage_return": "<p>a\rb</p>",
    "form_feed": "<p>a\x0cb</p>",
    "text_outside": "a<p>b</p>",
    "end_of_void": "<p>a</br></p>",
    "comment": "<p><!-- a --></p>",
    "unclosed_tag": "<p",
    "only_end_tags": "</p></td>",
    "too_deep": "<table><tr><td>" * 40 + "x",
}


@pytest.mark.parametrize("case", list(OUTSIDE))
def test_markup_outside_the_set_raises(case):
    with pytest.raises(ValueError):
        pretty_print(OUTSIDE[case])


# --------------------------------------------------------------- hypothesis


def _charset():
    chars = set()
    for name in ("charset.txt", "charsetv2.txt"):
        chars.update((RESOURCE / name).read_text(encoding="utf-8"))
    return sorted(chars)


CHARSET = _charset()
#: drawn as often as the whole charset: the characters the printer treats
#: apart, line breaks, URL prefixes (escaped twice)
SPECIAL = [" ", '"', "&", "'", "<", ">", "\xad", "\n", "\n", "https://", "http://", "　"]
text = st.lists(st.one_of(st.sampled_from(SPECIAL), st.sampled_from(CHARSET)),
                max_size=12).map("".join)
box = st.just([1, 1, 30, 20])
order = st.integers(0, 6)
role = st.sampled_from([None, None, "section_headings", "page_header"])


@st.composite
def paragraph(draw):
    return dict(box=draw(box), contents=draw(text), direction="horizontal",
                order=draw(order), role=draw(role))


@st.composite
def table(draw):
    first = draw(st.integers(1, 3))
    rows = draw(st.lists(st.integers(1, 3), max_size=4))  # cells per row
    cells = [dict(row=first + r, col=c + 1, row_span=draw(st.integers(1, 3)),
                  col_span=draw(st.integers(1, 3)), box=[0, 0, 10, 10],
                  contents=draw(st.one_of(st.none(), text)))
             for r, n in enumerate(rows) for c in range(n)]
    n_row = first + len(rows) - 1 if rows else 0
    line = dict(box=[0, 0, 10, 10], score=0.9)
    return dict(box=[0, 0, 40, 40], n_row=n_row, n_col=max(rows, default=0), rows=[line],
                cols=[line], spans=[], cells=cells, order=draw(order))


@st.composite
def figure(draw):
    x, y = draw(st.integers(0, 40)), draw(st.integers(0, 40))
    return dict(box=[x, y, x + draw(st.integers(1, 20)), y + draw(st.integers(1, 20))],
                order=draw(order), direction="horizontal",
                paragraphs=draw(st.lists(paragraph(), max_size=2)))


document = st.fixed_dictionaries(dict(
    paragraphs=st.lists(paragraph(), max_size=5),
    tables=st.lists(table(), max_size=2),
    words=st.just([]),
    figures=st.lists(figure(), max_size=2),
))
figure_dir = st.lists(st.sampled_from([" ", "&", "a", "é", "図", "amp", ";", "not", "lt", "x",
                                       "=", "1"]),
                      min_size=1, max_size=5).map("".join)


@settings(max_examples=250, derandomize=True, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
@given(doc=document, figure_dir=figure_dir, ignore_line_break=st.booleans(),
       export_figure=st.booleans(), export_figure_letter=st.booleans(),
       figure_width=st.sampled_from([200, 120]))
def test_generated_documents_match_jax(doc, figure_dir, ignore_line_break, export_figure,
                                       export_figure_letter, figure_width):
    img = np.random.default_rng(1).integers(0, 255, (64, 64, 3), dtype=np.uint8)
    flags = dict(ignore_line_break=ignore_line_break, export_figure=export_figure,
                 export_figure_letter=export_figure_letter, img=img,
                 figure_width=figure_width, figure_dir=figure_dir)
    want_doc = jax_schemas.DocumentAnalyzerSchema.model_validate(copy.deepcopy(doc))
    got_doc = port_schemas.DocumentAnalyzerSchema.model_validate(copy.deepcopy(doc))
    with tempfile.TemporaryDirectory() as tmp:
        want = _convert(want_doc, jax_html, Path(tmp) / "jax", **flags)
        got = _convert(got_doc, port_html, Path(tmp) / "port", **flags)
    assert got == want


#: pieces of generated fragments: text as the exporter escapes it, and
#: attribute values with entity names, ``;`` and ``=`` around a raw ``&``
FRAGMENT_TEXT = [" ", "a", "\t", "&amp;", "&lt;", "&gt;", "&quot;", "&#x27;", "\xad", "あ",
                 "　", "\xa0"]
ATTR_PIECES = ["&", ";", "=", "a", "x", "1", " ", "/", "é", "<", ">", "'", "not", "notin",
               "amp", "AMP", "lt", "copy", "Eacute"]
PAIRED = ["p", "h1", "table", "tr", "td"]


@st.composite
def start_tag(draw, tag):
    names = draw(st.lists(st.sampled_from(["src", "width", "border", "rowspan", "colspan"]),
                          unique=True, max_size=2))
    values = [draw(st.lists(st.sampled_from(ATTR_PIECES), max_size=5).map("".join))
              for _ in names]
    return f"<{tag}" + "".join(f' {k}="{v}"' for k, v in zip(names, values)) + ">"


@st.composite
def element(draw, depth=0):
    """An element of the tag set, its content text, void tags and
    elements, its end tag sometimes missing and sometimes after a stray
    one."""
    tag = draw(st.sampled_from(PAIRED + ["br", "img"]))
    if tag in ("br", "img"):
        return draw(start_tag(tag))
    kinds = ["text", "br", "img"] + (["element"] if depth < 3 else [])
    parts = []
    for kind in draw(st.lists(st.sampled_from(kinds), max_size=4)):
        if kind == "text":
            parts.append(draw(st.lists(st.sampled_from(FRAGMENT_TEXT), min_size=1,
                                       max_size=3).map("".join)))
        elif kind == "element":
            parts.append(draw(element(depth + 1)))
        else:
            parts.append(draw(start_tag(kind)))
    stray = draw(st.one_of(st.just(""), st.sampled_from(PAIRED).map(lambda t: f"</{t}>")))
    close = draw(st.sampled_from([f"</{tag}>", f"</{tag}>", ""]))
    return draw(start_tag(tag)) + "".join(parts) + stray + close


@settings(max_examples=300, derandomize=True, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
@given(parts=st.lists(element(), min_size=1, max_size=4))
def test_generated_fragments_match_lxml(parts):
    """Fragments of the tag set nested and closed in any order: where the
    reader takes them (text left outside every element raises), the
    print is lxml's."""
    markup = "".join(parts)
    try:
        got = pretty_print(markup)
    except ValueError:
        return
    assert got == lxml_print(markup)


# ----------------------------------------------------------- without lxml

SMALL = ["--td_cfg", "tests/yaml/det_small.yaml", "--tr_cfg", "tests/yaml/rec_small.yaml",
         "--lp_cfg", "tests/yaml/layout_small.yaml", "--tsr_cfg", "tests/yaml/layout_small.yaml"]


def test_html_without_lxml(tmp_path):
    """In a process where ``import lxml`` fails: ``convert_html`` on the
    exporter tests' documents equals the JAX package's here, and the CLI's
    ``-f html`` (per page and ``--combine``) on demo/sample.pdf at 72 dpi
    equals JAX's ``convert_html`` of the same CLI's ``-f json`` pages; lxml
    is never loaded there."""
    docs = {name: copy.deepcopy(d) for name, d in DOCS.items() if not d["figures"]}
    script = f"""
import json, sys
sys.modules["lxml"] = None  # import lxml raises ImportError
sys.path.insert(0, {str(ROOT)!r})
from yomitoku_tpu_torch.cli import main
from yomitoku_tpu_torch.export import convert_html
from yomitoku_tpu_torch.schemas import DocumentAnalyzerSchema
docs = json.loads({json.dumps(docs)!r})
printed = {{name: [convert_html(DocumentAnalyzerSchema.model_validate(d), None, flag,
                                False, False)[0] for flag in (False, True)]
           for name, d in docs.items()}}
for fmt, extra in (("json", []), ("html", []), ("html", ["--combine"])):
    sys.argv = ["yomitoku_torch", "demo/sample.pdf", "-f", fmt, *extra, "--dpi", "72",
                "-d", "cpu", "-o", {str(tmp_path)!r} + "/" + fmt + "".join(extra),
                *{SMALL!r}]
    main.main()
print(json.dumps({{"printed": printed,
                  "lxml": sorted(m for m, v in sys.modules.items()
                                 if m.split(".")[0] == "lxml" and v is not None)}}))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["lxml"] == []
    for name, d in docs.items():
        doc = jax_schemas.DocumentAnalyzerSchema.model_validate(copy.deepcopy(d))
        assert got["printed"][name] == [
            jax_html.convert_html(doc, None, flag, False, False)[0] for flag in (False, True)]
    pages = []
    for i in (1, 2):
        doc = jax_schemas.DocumentAnalyzerSchema.model_validate(json.loads(
            (tmp_path / "json" / f"demo_sample_p{i}.json").read_text(encoding="utf-8")))
        want = jax_html.convert_html(doc, None, False, False, False)[0]
        html = tmp_path / "html" / f"demo_sample_p{i}.html"
        assert html.read_bytes() == want.encode("utf-8")
        pages.append(want)
    assert any(pages), "the small pipeline found nothing to print"
    combined = (tmp_path / "html--combine" / "demo_sample.html").read_bytes()
    assert combined == "\n".join(pages).encode("utf-8")
