"""The port's DocumentAnalyzer against the JAX package's unfused route
(YOMITOKU_TPU_NO_FUSED_PAGE=1), on the same weights and page, CPU, f32,
on the host route and on the page route (YOMITOKU_TPU_DEVICE_CROPS=1 on
both sides); the aggregation and its helpers against the JAX functions on
the same inputs; and ``batch``, whose pages share the recognizer's AR
loop state, against one ``__call__`` per page.

Models: the small configs of tests/test_torch_ocr.py (detector head scaled
by 10, the JAX recognizer's seeded init given to the port) and
tests/test_torch_layout.py (the score heads calibrated from one port pass,
given to JAX), on a 120x180 page whose detector finds eleven words, the
layout parser tables, paragraphs and a figure, and the table recognizer
cells.  Held: word quads, strings and directions equal, scores to rtol
1e-4; paragraphs and figures equal in box, direction, role, order and
contents; tables equal in box and order, their cells in row, column and
spans, boxes within 1 px, contents equal; the visualisations equal pixel
for pixel."""

import ast
import inspect
import threading
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from test_torch_layout import LAYOUT_TARGETS, TSR_TARGETS, calibrate, share
from test_torch_ocr import _NO_DEFAULT, _params
from yomitoku_tpu import document_analyzer as jax_da
from yomitoku_tpu import schemas as jax_schemas
from yomitoku_tpu.models.weights_convert import convert_dbnet
from yomitoku_tpu_torch import document_analyzer as port_da
from yomitoku_tpu_torch import schemas as port_schemas
from yomitoku_tpu_torch.models import parseq
from yomitoku_tpu_torch.models.parseq import PARSeq
from yomitoku_tpu_torch.ops import device_crop as dc
from yomitoku_tpu_torch.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
YAML = ROOT / "tests" / "yaml"
CONFIGS = {
    "ocr": {
        "text_detector": {"path_cfg": str(YAML / "det_small.yaml"),
                          "from_pretrained": False},
        "text_recognizer": {"path_cfg": str(YAML / "rec_small.yaml"),
                            "from_pretrained": False},
    },
    "layout_analyzer": {
        "layout_parser": {"path_cfg": str(YAML / "layout_small.yaml"),
                          "from_pretrained": False},
        "table_structure_recognizer": {"path_cfg": str(YAML / "layout_small.yaml"),
                                       "from_pretrained": False},
    },
}


def text_page(n=4, h=120, w=180):
    """``n`` lines of two words each."""
    img = np.full((h, w, 3), 255, np.uint8)
    for i in range(n):
        y = int(h / (n + 1) * (i + 1))
        cv2.putText(img, f"L{i} AB", (8, y), cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 0, 0), 2)
        cv2.putText(img, f"Z{i}", (int(w * 0.6), y), cv2.FONT_HERSHEY_SIMPLEX, 0.8,
                    (0, 0, 0), 2)
    return img


@pytest.fixture(scope="module")
def analyzers():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YOMITOKU_TPU_INT8_KV", "0")
        jax = jax_da.DocumentAnalyzer(configs=CONFIGS, device="cpu")
        port = port_da.DocumentAnalyzer(configs=CONFIGS, device="cpu")
    page = text_page()
    det = port.text_detector.model
    with torch.no_grad():
        det.decoder.binarize[6].weight.mul_(10.0)
    sd = {k: v.numpy() for k, v in det.state_dict().items()}
    jax.text_detector.model.params = convert_dbnet(sd, jax.text_detector.model)
    rec = jax.text_recognizer.model
    assert not rec.int8_kv and not port.text_recognizer.model.int8_kv
    rec.params = rec.init_params(0)
    port.text_recognizer.model.load_state_dict(
        state_dict_from_jax(rec.params, port.text_recognizer.model))
    lp, tsr = port.layout.layout_parser, port.layout.table_structure_recognizer
    calibrate(lp.model, lp.preprocess(page), LAYOUT_TARGETS)
    share(lp.model, jax.layout.layout_parser.model)
    tables = [t.box for t in lp(page)[0].tables]
    calibrate(tsr.model, np.stack([d["array"] for d in tsr.preprocess(page, tables)]),
              TSR_TARGETS)
    share(tsr.model, jax.layout.table_structure_recognizer.model)
    return jax, port, page


@pytest.fixture(autouse=True)
def unfused(monkeypatch):
    """The JAX package's unfused route, which the port takes."""
    monkeypatch.setenv("YOMITOKU_TPU_NO_FUSED_PAGE", "1")
    monkeypatch.delenv("YOMITOKU_TPU_HOST_CROPS", raising=False)
    monkeypatch.delenv("YOMITOKU_TPU_DEVICE_CROPS", raising=False)
    monkeypatch.delenv("YOMITOKU_TPU_REC_WIDTH_BUCKETS", raising=False)


@pytest.fixture(params=["host", "page"])
def route(request, monkeypatch):
    if request.param == "page":
        monkeypatch.setenv("YOMITOKU_TPU_DEVICE_CROPS", "1")
    return request.param


def _same_paragraphs(got, want):
    assert [(p.box, p.direction, p.role, p.order, p.contents) for p in got] == \
        [(p.box, p.direction, p.role, p.order, p.contents) for p in want]


def _same_document(got, want):
    assert len(got.words) == len(want.words)
    for g, w in zip(got.words, want.words):
        assert (g.points, g.content, g.direction) == (w.points, w.content, w.direction)
        np.testing.assert_allclose([g.det_score, g.rec_score],
                                   [w.det_score, w.rec_score], rtol=1e-4)
    _same_paragraphs(got.paragraphs, want.paragraphs)
    assert len(got.figures) == len(want.figures)
    for g, w in zip(got.figures, want.figures):
        assert (g.box, g.order, g.direction) == (w.box, w.order, w.direction)
        _same_paragraphs(g.paragraphs, w.paragraphs)
    assert len(got.tables) == len(want.tables)
    for g, w in zip(got.tables, want.tables):
        assert (g.box, g.order, g.n_row, g.n_col, len(g.cells)) == \
            (w.box, w.order, w.n_row, w.n_col, len(w.cells))
        for a, b in zip(g.cells, w.cells):
            assert (a.row, a.col, a.row_span, a.col_span, a.contents) == \
                (b.row, b.col, b.row_span, b.col_span, b.contents)
            assert np.abs(np.subtract(a.box, b.box)).max() <= 1, (a.box, b.box)


def test_document_analyzer_matches_jax(analyzers, route):
    jax, port, page = analyzers
    want, _, _ = jax(page)
    got, ocr_vis, layout_vis = port(page)
    assert ocr_vis is None and layout_vis is None
    assert len(got.words) >= 8
    assert got.tables and got.figures and got.paragraphs
    assert any(t.cells for t in got.tables)
    _same_document(got, want)


def test_page_route_uploads_one_page(analyzers, route, monkeypatch):
    """The page route uploads the page once, for the detector, both layout
    modules and the recognizer; the host route uploads none."""
    _, port, page = analyzers
    made = []
    init = dc.DevicePage.__init__
    monkeypatch.setattr(dc.DevicePage, "__init__",
                        lambda self, *a, **k: made.append(self) or init(self, *a, **k))
    port(page)
    assert len(made) == (1 if route == "page" else 0)


def test_detector_and_layout_keep_their_threads(analyzers, monkeypatch):
    """The detector and the layout analyzer run on the analyzer's two
    worker threads, the same ones from call to call (a new thread costs a
    CUDA model's first call there; the JAX package makes two per page)."""
    _, port, page = analyzers
    seen = []
    for module in (port.text_detector, port.layout.layout_parser):
        post = module.postprocess
        monkeypatch.setattr(module, "postprocess",
                            lambda *a, _post=post: seen.append(threading.get_ident())
                            or _post(*a))
    for _ in range(3):
        port(page)
    assert len(seen) == 6 and threading.get_ident() not in seen
    assert set(seen) <= {t.ident for t in port._workers._threads} and len(set(seen)) <= 2


OPTIONS = {
    "split_text_across_cells": True,
    "ignore_ruby": True,
    "reading_order": "right2left",
    "ignore_meta": True,
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_matches_jax(analyzers, route, option, monkeypatch):
    jax, port, page = analyzers
    for analyzer in (jax, port):
        monkeypatch.setattr(analyzer, option, OPTIONS[option])
    want, _, _ = jax(page)
    got, _, _ = port(page)
    _same_document(got, want)


def test_split_text_moves_words(analyzers, monkeypatch):
    """Splitting at the cells changes the words on this page (so the
    option's parity case above compares a real split)."""
    _, port, page = analyzers
    unsplit, _, _ = port(page)
    monkeypatch.setattr(port, "split_text_across_cells", True)
    split, _, _ = port(page)
    assert [w.points for w in split.words] != [w.points for w in unsplit.words]


def _visualize(monkeypatch, analyzer):
    monkeypatch.setattr(analyzer, "visualize", True)
    for module in (analyzer.text_detector, analyzer.text_recognizer,
                   analyzer.layout.layout_parser,
                   analyzer.layout.table_structure_recognizer):
        monkeypatch.setattr(module, "visualize", True)


def test_visualize_matches_jax(analyzers, route, monkeypatch):
    """The OCR picture (quads and recognized text) and the layout picture
    (boxes, table cells and the reading-order arrows), pixel for pixel."""
    jax, port, page = analyzers
    _visualize(monkeypatch, jax)
    _visualize(monkeypatch, port)
    _, want_ocr, want_layout = jax(page)
    _, got_ocr, got_layout = port(page)
    for got, want in ((got_ocr, want_ocr), (got_layout, want_layout)):
        assert got.shape == page.shape and not np.array_equal(got, page)
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- the call API


def test_call_api_matches_jax():
    """__init__, __call__ and batch take the JAX package's parameters in
    its order with its defaults, but for the device (CUDA here)."""
    for method in ("__init__", "__call__", "batch", "aggregate"):
        got = _params(port_da.DocumentAnalyzer, method)
        want = _params(jax_da.DocumentAnalyzer, method)
        assert list(got) == list(want), method
        for name, default in want.items():
            assert got[name] == ("cuda" if name == "device" else default), name
    assert _params(port_da.DocumentAnalyzer, "__init__")["device"] == "cuda"
    assert _params(port_da.DocumentAnalyzer, "batch")["max_in_flight"] == 4
    assert _NO_DEFAULT not in (_params(port_da.DocumentAnalyzer, "__init__").values())
    assert inspect.iscoroutinefunction(port_da.DocumentAnalyzer.run)
    tree = ast.parse(inspect.getsource(port_da))
    defined = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    # the fused page route and the page-batched data-parallel routes
    assert {"_run_fused", "_fused_host_postwire", "_ensure_fused_program",
            "_fused_page_enabled", "_batch_dp", "_batch_dp_fused",
            "_batch_dp_host"} <= defined


def test_num_devices_above_one_raises():
    """``num_devices`` 2 builds, as in the JAX package, and a page gives
    the result of ``num_devices=None`` (one CPU: no replica)."""
    page = text_page()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YOMITOKU_TPU_INT8_KV", "0")
        two = port_da.DocumentAnalyzer(configs=CONFIGS, device="cpu", num_devices=2)
        one = port_da.DocumentAnalyzer(configs=CONFIGS, device="cpu")
    assert two.num_devices == 2
    assert two(page)[0].model_dump() == one(page)[0].model_dump()


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        port_da.DocumentAnalyzer(configs=CONFIGS)


def test_configs_must_be_a_dict():
    for da in (port_da, jax_da):
        with pytest.raises(ValueError, match="configs must be a dict"):
            da.DocumentAnalyzer(configs=[], device="cpu")


# ------------------------------------------------------------- aggregation

def _quad(x1, y1, x2, y2):
    return [[x1, y1], [x2, y1], [x2, y2], [x1, y2]]


def _w(box, content, direction="horizontal"):
    return dict(points=_quad(*box), content=content, direction=direction,
                det_score=0.9, rec_score=0.8)


def _el(box, role=None):
    return dict(id=None, box=box, score=0.9, role=role, contents=None)


def _cell(row, col, box, row_span=1, col_span=1):
    return dict(row=row, col=col, row_span=row_span, col_span=col_span, box=box,
                contents=None)


#: a 300x400 page: a page header and footer, a paragraph with furigana
#: (small kana-only words over larger ones), a section heading, a 2x2
#: table with a merged row, a figure holding one paragraph of its own,
#: vertical words to the right and words claimed by nothing
WORDS = [
    _w([10, 2, 120, 22], "ヘッダ"), _w([150, 4, 280, 24], "ページ1"),
    _w([12, 40, 100, 70], "漢字本文"), _w([20, 32, 40, 38], "かん"),
    _w([50, 32, 70, 38], "じ"), _w([110, 40, 190, 70], "文章"),
    _w([12, 80, 180, 110], "二行目の本文"), _w([120, 32, 140, 38], "ぶん"),
    _w([14, 122, 160, 140], "見出し"),
    _w([20, 160, 130, 180], "セル一"), _w([160, 160, 270, 180], "セル二"),
    _w([20, 230, 260, 250], "結合セル"), _w([20, 255, 120, 275], "二行"),
    _w([205, 50, 280, 70], "図の文字"),
    _w([240, 300, 260, 360], "縦書き", "vertical"),
    _w([265, 300, 285, 350], "縦二", "vertical"),
    _w([10, 300, 60, 315], "孤立"), _w([100, 330, 150, 345], "もう一つ"),
    _w([10, 372, 140, 392], "フッタ"),
]
LAYOUT = dict(
    paragraphs=[_el([5, 0, 295, 28], "page_header"), _el([5, 28, 195, 115]),
                _el([5, 118, 195, 145], "section_headings"),
                _el([200, 45, 290, 75]), _el([5, 368, 295, 398], "page_footer")],
    tables=[dict(box=[10, 150, 290, 290], n_row=2, n_col=2,
                 rows=[dict(box=[10, 150, 290, 220], score=0.9),
                       dict(box=[10, 220, 290, 290], score=0.9)],
                 cols=[dict(box=[10, 150, 150, 290], score=0.9),
                       dict(box=[150, 150, 290, 290], score=0.9)],
                 spans=[], order=0,
                 cells=[_cell(1, 1, [10, 150, 150, 220]),
                        _cell(1, 2, [150, 150, 290, 220]),
                        _cell(2, 1, [10, 220, 290, 290], col_span=2)])],
    figures=[_el([198, 40, 295, 80])],
)


def _inputs(schemas, words=WORDS, layout=LAYOUT):
    return (schemas.OCRSchema.model_validate({"words": words}),
            schemas.LayoutAnalyzerSchema.model_validate(layout))


def _bare(module, **options):
    """A DocumentAnalyzer without models, for ``aggregate`` alone."""
    analyzer = object.__new__(module.DocumentAnalyzer)
    analyzer.reading_order, analyzer.ignore_meta = "auto", False
    analyzer.ignore_ruby, analyzer.ruby_threshold = False, 2.0
    vars(analyzer).update(options)
    return analyzer


def _dump(outputs):
    return {k: [e.model_dump() for e in v] for k, v in outputs.items()}


@pytest.mark.parametrize("vertical", [False, True])
@pytest.mark.parametrize("ignore_meta", [False, True])
@pytest.mark.parametrize("reading_order", ["auto", "top2bottom", "right2left",
                                           "left2right"])
@pytest.mark.parametrize("ignore_ruby", [False, True])
def test_aggregate_matches_jax(ignore_ruby, reading_order, ignore_meta, vertical):
    """The whole of ``aggregate`` on one page of every element kind, under
    each option; ``vertical`` turns most words vertical, so that "auto"
    reads right to left."""
    words = WORDS
    if vertical:
        words = [dict(w, direction="vertical") for w in WORDS[:12]] + WORDS[12:]
    options = dict(ignore_ruby=ignore_ruby, reading_order=reading_order,
                   ignore_meta=ignore_meta)
    want = _bare(jax_da, **options).aggregate(*_inputs(jax_schemas, words))
    got = _bare(port_da, **options).aggregate(*_inputs(port_schemas, words))
    assert _dump(got) == _dump(want)
    port_schemas.DocumentAnalyzerSchema(**got)


def test_aggregate_options_change_the_page():
    """Each option moves something on the page above, so the cases above
    hold the port to the JAX package where it matters: furigana dropped,
    the header and footer dropped, another order, the figure holding its
    paragraph, the cells filled."""
    def run(**options):
        return _dump(_bare(port_da, **options).aggregate(*_inputs(port_schemas)))

    base = run()
    texts = [p["contents"] for p in base["paragraphs"]]
    assert any("かん" in t for t in texts)
    assert not any("かん" in t for t in (p["contents"] for p in run(ignore_ruby=True)
                                          ["paragraphs"]))
    roles = {p["role"] for p in base["paragraphs"]}
    assert {"page_header", "page_footer", "section_headings"} <= roles
    assert not {"page_header", "page_footer"} & {
        p["role"] for p in run(ignore_meta=True)["paragraphs"]}
    assert run(reading_order="right2left") != base
    assert [p["contents"] for p in base["figures"][0]["paragraphs"]] == ["図の文字"]
    assert [c["contents"] for c in base["tables"][0]["cells"]] == \
        ["セル一", "セル二", "結合セル\n二行"]


# ----------------------------------------------------------------- helpers

class _Box:
    def __init__(self, box):
        self.box = box


def _paras(schemas, specs):
    return [schemas.ParagraphSchema(box=b, contents="t", direction=d, order=0, role=None)
            for b, d in specs]


def _words(schemas, specs):
    return [schemas.WordPrediction(points=p, content=c, direction="horizontal",
                                   det_score=0.9, rec_score=0.9) for p, c in specs]


def _split_case(module, schemas):
    """tests/test_document_analyzer.py's table of two rows, with a word in
    row 1, one across both rows, a vertical one across both columns of a
    second table and one outside."""
    tables = [
        schemas.TableStructureRecognizerSchema.model_validate(LAYOUT["tables"][0]),
        schemas.TableStructureRecognizerSchema(
            box=[0, 0, 200, 100], n_row=2, n_col=1,
            rows=[schemas.TableLineSchema(box=[0, 0, 200, 50], score=0.9),
                  schemas.TableLineSchema(box=[0, 50, 200, 100], score=0.9)],
            cols=[schemas.TableLineSchema(box=[0, 0, 200, 100], score=0.9)],
            spans=[], order=0,
            cells=[schemas.TableCellSchema(**_cell(1, 1, [0, 0, 200, 50])),
                   schemas.TableCellSchema(**_cell(2, 1, [0, 50, 200, 100]))]),
    ]
    det = schemas.TextDetectorSchema(
        points=[_quad(10, 10, 190, 40), _quad(10, 20, 190, 90),
                _quad(100, 160, 120, 280), _quad(20, 160, 280, 200),
                _quad(300, 300, 400, 330)],
        scores=[0.9, 0.8, 0.7, 0.6, 0.5])
    out = module._split_text_across_cells(det, type("Layout", (), {"tables": tables})())
    return out.points, out.scores


HELPER_CASES = {
    "judge_page_direction_horizontal": lambda m, s: m.judge_page_direction(
        _paras(s, [([0, 0, 100, 10], "horizontal"), ([0, 20, 100, 30], "horizontal")])),
    "judge_page_direction_vertical": lambda m, s: m.judge_page_direction(
        _paras(s, [([0, 0, 10, 100], "vertical"), ([20, 0, 30, 100], "vertical"),
                   ([50, 0, 60, 10], "horizontal")])),
    "judge_page_direction_tie": lambda m, s: m.judge_page_direction(
        _paras(s, [([0, 0, 10, 10], "vertical"), ([20, 0, 30, 10], "horizontal")])),
    "combine_flags": lambda m, s: m.combine_flags([True, False, False],
                                                  [False, False, True]),
    "recursive_update": lambda m, s: m.recursive_update(
        {"a": {"b": 1, "c": 2}, "d": 3}, {"a": {"b": 10}, "e": 4, "d": {"x": 1}}),
    "extract_paragraph_within_figure": lambda m, s: m.extract_paragraph_within_figure(
        _paras(s, [([10, 10, 50, 20], "horizontal"), ([200, 200, 250, 210], "vertical"),
                   ([10, 30, 20, 90], "vertical")]),
        [_Box([0, 0, 100, 100]), _Box([150, 150, 300, 300])]),
    "extract_words_within_element": lambda m, s: m.extract_words_within_element(
        _words(s, [(_quad(10, 60, 100, 80), "second"), (_quad(10, 10, 100, 30), "first"),
                   (_quad(500, 500, 600, 520), "outside")]), _Box([0, 0, 200, 100])),
    "extract_words_within_element_empty": lambda m, s: m.extract_words_within_element(
        _words(s, [(_quad(500, 500, 600, 520), "w")]), _Box([0, 0, 10, 10])),
    "extract_words_within_element_no_words": lambda m, s: m.extract_words_within_element(
        [], _Box([0, 0, 10, 10])),
    "extract_words_within_element_ruby": lambda m, s: m.extract_words_within_element(
        _inputs(s)[0].words, _Box([5, 28, 195, 115]), ignore_ruby=True),
    "split_text_across_cells": _split_case,
    "is_vertical": lambda m, s: [m.is_vertical(q) for q in (_quad(0, 0, 10, 50),
                                                            _quad(0, 0, 50, 10))],
    "is_noise": lambda m, s: [m.is_noise(q) for q in (_quad(0, 0, 10, 50),
                                                      _quad(0, 0, 50, 20))],
}


def _plain(value):
    """Schemas to dicts, tuples to lists, numpy scalars to Python."""
    if hasattr(value, "model_dump"):
        return value.model_dump()
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return value.item() if isinstance(value, np.generic) else value


@pytest.mark.parametrize("case", list(HELPER_CASES))
def test_helper_matches_jax(case):
    fn = HELPER_CASES[case]
    assert _plain(fn(port_da, port_schemas)) == _plain(fn(jax_da, jax_schemas))


# ------------------------------------------------------------------- batch


def _pages():
    """Four pages of 2-5 lines: the first two decode the same number of
    lines, so they share one AR loop."""
    return [text_page(n) for n in (4, 4, 2, 5)]


def test_batch_equals_calls(analyzers):
    """batch(max_in_flight=4) gives each page what its own __call__ gives."""
    _, port, _ = analyzers
    pages = _pages()
    want = [port(p)[0].model_dump() for p in pages]
    got = port.batch(pages, max_in_flight=4)
    assert [g[0].model_dump() for g in got] == want
    assert port.batch([]) == []


def _ar_model(port):
    model = PARSeq(port.text_recognizer.model.cfg, device="cpu")
    model.load_state_dict(port.text_recognizer.model.state_dict())
    return model


def test_ar_loop_decodes_take_turns(analyzers, monkeypatch):
    """Two threads decode batches of the same shape, so the same AR loop,
    at once.  Each step of a decode waits (up to 2 s) at a barrier for the
    other thread's: without the model's lock both would be inside their
    decodes together, writing one loop's buffers.  With it the decodes
    never overlap, the barrier times out once, and each result equals a
    fresh model's."""
    _, port, _ = analyzers
    model = _ar_model(port)
    h, w = model.img_size
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 255, (3, h, w, 3), dtype=np.uint8) for _ in range(2)]
    want = [_ar_model(port).forward_tokens(b) for b in batches]

    barrier = threading.Barrier(2, timeout=2.0)
    count = threading.Lock()
    inside, most = [0], [0]
    step = parseq._CachedARLoop.step

    def met_step(self):
        with count:
            inside[0] += 1
            most[0] = max(most[0], inside[0])
        try:
            barrier.wait()
        except threading.BrokenBarrierError:
            pass
        try:
            step(self)
        finally:
            with count:
                inside[0] -= 1

    monkeypatch.setattr(parseq._CachedARLoop, "step", met_step)
    got = [None, None]

    def decode(i):
        got[i] = model.forward_tokens(batches[i])

    threads = [threading.Thread(target=decode, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(model._ar_loops) == 1
    assert most[0] == 1, "two decodes ran in one AR loop at once"
    for (ids, probs), (want_ids, want_probs) in zip(got, want):
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(probs, want_probs)
