"""Table semantics in the port against the JAX package's unfused route
(YOMITOKU_TPU_NO_FUSED_PAGE=1, YOMITOKU_TPU_INT8_KV=0), CPU, f32, on the
same weights: the CellDetector, its host filters and hole mining, the
grid and key-value parsers with the rest of ``_finalize`` (clustering,
ids, aggregation), the TableSemanticParser on the host route, its
options, a template round trip, the visualisations, ``batch``, its kept
worker threads, and the schema facades.  The page route
(YOMITOKU_TPU_DEVICE_CROPS=1 on both sides) is held by
tests/test_torch_table_semantic_page.py with this file's fixtures and
checks.

Models: the small configs (tests/yaml/layout_small.yaml for the layout
parser and the cell detector, det_small.yaml, rec_small.yaml), the
detector head scaled by 10 and the JAX recognizer's seeded init given to
the port, as in tests/test_torch_document_analyzer.py; the layout and
cell score heads calibrated from one port pass and given to JAX.  The
page is that test's text page scaled to 1440x960, where the layout
parser finds three tables, the cell detector tens of cells in each, and
the detector eight words.  Where the semantic parser runs whole, both
sides' cell filters are pinned after the real call to the same grid and
key-value detections (``utils.synthetic_heads.pinned_filter_packed``),
so that each page holds grids and key-value items.  Held: the schemas
equal field by field, the scores (words' and paragraphs') within rtol
1e-4; the pictures pixel for pixel."""

import json
import threading
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import _first_difference
from test_torch_document_analyzer import text_page
from test_torch_layout import LAYOUT_TARGETS, calibrate, share
from yomitoku_tpu import table_cell_detector as jax_cd
from yomitoku_tpu import table_semantic_parser as jax_tsp
from yomitoku_tpu.models.weights_convert import convert_dbnet
from yomitoku_tpu import schemas as jax_schemas
from yomitoku_tpu.ops import device_crop as jax_dc
from yomitoku_tpu.schemas import table_semantic_parser as jax_schema
from yomitoku_tpu.utils import visualizer as jax_vis
from yomitoku_tpu_torch import table_cell_detector as port_cd
from yomitoku_tpu_torch import table_semantic_parser as port_tsp
from yomitoku_tpu_torch import schemas as port_schemas
from yomitoku_tpu_torch.ops import device_crop as port_dc
from yomitoku_tpu_torch.schemas import table_semantic_parser as port_schema
from yomitoku_tpu_torch.utils import visualizer as port_vis
from yomitoku_tpu_torch.utils.synthetic_heads import pinned_filter_packed
from yomitoku_tpu_torch.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
YAML = ROOT / "tests" / "yaml"
CONFIGS = {
    "table_detector": {"path_cfg": str(YAML / "layout_small.yaml"),
                       "from_pretrained": False},
    "table_cell_parser": {"path_cfg": str(YAML / "layout_small.yaml"),
                          "from_pretrained": False},
    "text_detector": {"path_cfg": str(YAML / "det_small.yaml"),
                      "from_pretrained": False},
    "text_recognizer": {"path_cfg": str(YAML / "rec_small.yaml"),
                        "from_pretrained": False},
}
#: the layout score-head targets with fewer tables (three on the page)
TABLE_LAYOUT_TARGETS = [0.2] + LAYOUT_TARGETS[1:]
#: cell-detector score-head targets: table, cell, form, header, check,
#: select, group, empty
CELL_TARGETS = [-2.0, 0.4, -2.0, 0.2, -2.0, -2.0, -0.5, 0.1]


def semantic_page():
    return cv2.resize(text_page(), (1440, 960), interpolation=cv2.INTER_LINEAR)


@pytest.fixture(scope="module")
def parsers():
    """(JAX parser, port parser, page, the layout's tables), visualize on."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YOMITOKU_TPU_INT8_KV", "0")
        jax = jax_tsp.TableSemanticParser(configs=CONFIGS, device="cpu")
        port = port_tsp.TableSemanticParser(configs=CONFIGS, device="cpu")
    page = semantic_page()
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
    lp, cd = port.layout_parser, port.cell_detector
    calibrate(lp.model, lp.preprocess(page), TABLE_LAYOUT_TARGETS)
    share(lp.model, jax.layout_parser.model)
    tables = list(lp(page)[0].tables)
    calibrate(cd.model, np.stack([d["array"] for d in cd.preprocess(page, tables)]),
              CELL_TARGETS)
    share(cd.model, jax.cell_detector.model)
    return jax, port, page, tables


@pytest.fixture(autouse=True)
def unfused(monkeypatch):
    """The JAX package's unfused route, which the port takes."""
    monkeypatch.setenv("YOMITOKU_TPU_NO_FUSED_PAGE", "1")
    monkeypatch.delenv("YOMITOKU_TPU_HOST_CROPS", raising=False)
    monkeypatch.delenv("YOMITOKU_TPU_DEVICE_CROPS", raising=False)
    monkeypatch.delenv("YOMITOKU_TPU_REC_WIDTH_BUCKETS", raising=False)


@pytest.fixture
def pinned(parsers, monkeypatch):
    """Both sides' cell filters pinned to the same grid and key-value
    detections after the real call."""
    jax, port, _, _ = parsers
    for parser in (jax, port):
        cd = parser.cell_detector
        monkeypatch.setattr(cd.postprocessor, "filter_packed", pinned_filter_packed(cd))


def _scores_apart(dump):
    """The dump without its scores, and the scores, in order."""
    scores = []
    for word in dump["words"]:
        scores += [word.pop("det_score"), word.pop("rec_score")]
    for paragraph in dump["paragraphs"]:
        scores.append(paragraph.pop("score"))
    return dump, scores


def _same_semantic(got, want):
    g, g_scores = _scores_apart(got.model_dump())
    w, w_scores = _scores_apart(want.model_dump())
    assert g == w, _first_difference(g, w)
    np.testing.assert_allclose(g_scores, w_scores, rtol=1e-4)


# ---------------------------------------------------------------- CellDetector


def _pages_for(route, page):
    if route == "host":
        return None, None
    return jax_dc.DevicePage(page), port_dc.DevicePage(page, "cpu")


def _recorded_filter(cd, seen, monkeypatch):
    """Keep what the real host filter returns, per call."""
    real = cd.postprocessor.filter_packed

    def filter_packed(packed, orig_sizes, threshold):
        seen.append((np.asarray(packed), real(packed, orig_sizes, threshold)))
        return seen[-1][1]

    monkeypatch.setattr(cd.postprocessor, "filter_packed", filter_packed)


def check_cell_detector(parsers, route, n_tables, monkeypatch):
    """The filtered detections (labels, boxes, scores) and the cells of
    each table, once no score of the top-k lies within 1e-4 of the
    threshold (the k-th gap check: the kept set is then the same)."""
    jax, port, page, tables = parsers
    tables = tables[:n_tables]
    assert len(tables) == n_tables
    seen = {"jax": [], "port": []}
    _recorded_filter(jax.cell_detector, seen["jax"], monkeypatch)
    _recorded_filter(port.cell_detector, seen["port"], monkeypatch)
    jax_page, port_page = _pages_for(route, page)
    want = jax.cell_detector(page, tables, page=jax_page)
    got = port.cell_detector(page, tables, page=port_page)

    (packed_j, filt_j), = seen["jax"]
    (packed_p, filt_p), = seen["port"]
    thresh = port.cell_detector.thresh_score
    scores = packed_p[:n_tables, :, 1]
    assert np.abs(scores - thresh).min() > 1e-4, "a score lies at the threshold"
    assert len(filt_p) == n_tables and len(filt_j) >= n_tables  # JAX pads to its bucket
    for g, w in zip(filt_p, filt_j):
        order_g, order_w = np.argsort(-g["scores"]), np.argsort(-w["scores"])
        np.testing.assert_array_equal(g["labels"][order_g], w["labels"][order_w])
        np.testing.assert_allclose(g["scores"][order_g], w["scores"][order_w], rtol=1e-4)
        np.testing.assert_allclose(g["boxes"][order_g], w["boxes"][order_w], atol=1e-2)

    assert sum(len(t.cells) for t in got) > 10 * n_tables
    assert [t.model_dump() for t in got] == [t.model_dump() for t in want]


@pytest.mark.parametrize("n_tables", [1, 3])
def test_cell_detector_matches_jax(parsers, n_tables, monkeypatch):
    check_cell_detector(parsers, "host", n_tables, monkeypatch)


def _boxes(rng, n, w=400, h=300):
    x1 = rng.integers(0, w - 40, n)
    y1 = rng.integers(0, h - 30, n)
    return np.stack([x1, y1, x1 + rng.integers(12, 160, n),
                     y1 + rng.integers(10, 120, n)], 1).tolist()


def _elements(rng):
    """Per-category host elements: overlapping and nested boxes, groups
    inside groups, duplicates."""
    out = {}
    for category in ("cell", "header", "empty", "group"):
        boxes = _boxes(rng, int(rng.integers(2, 14)))
        boxes += [[b[0] + 2, b[1] + 2, b[2] - 2, b[3] - 2] for b in boxes[:2]]
        boxes.append(list(boxes[0]))
        out[category] = [{"box": list(map(int, b)), "score": 0.9, "role": category}
                         for b in boxes]
    return out


def _copy(elements):
    return {k: [dict(e, box=list(e["box"])) for e in v] for k, v in elements.items()}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_host_filters_match_jax(seed):
    """The containment filters, hole mining and the holes' roles on
    generated box sets."""
    rng = np.random.default_rng(seed)
    elements = _elements(rng)
    results = []
    for mod in (jax_cd, port_cd):
        e = mod.filter_contained_rectangles_with_category(
            _copy(elements), ignore_categories=["group"])
        e = mod.filter_contained_groups(e)
        e = mod.filter_contained_rectangles_across_categories(e, "cell", "header")
        e = mod.filter_contained_rectangles_across_categories(e, "cell", "empty")
        cells = e["cell"] + e["header"] + e["empty"]
        holes = [{"box": b, "score": 1.0, "role": "hole"}
                 for b in mod.find_holes_as_rects((300, 400), [c["box"] for c in cells])]
        kept = mod.calc_adjacent_holes_to_cells(holes, cells)
        results.append((e, holes, kept))
    assert results[0] == results[1]


@pytest.mark.parametrize("seed", [0, 1])
def test_find_holes_matches_jax(seed):
    """Hole mining alone on a grid with cells taken out, under each
    argument."""
    rng = np.random.default_rng(10 + seed)
    boxes = [[c * 60 + 1, r * 40 + 1, c * 60 + 58, r * 40 + 38]
             for r in range(6) for c in range(6) if rng.random() > 0.25]
    for kwargs in ({}, {"pad": 0, "close_ksize": 1, "min_area": 50},
                   {"close_ksize": 9, "min_area": 1000}):
        want = jax_cd.find_holes_as_rects((240, 360), boxes, **kwargs)
        assert port_cd.find_holes_as_rects((240, 360), boxes, **kwargs) == want
        assert want or kwargs, "no hole found"
    roles = [{"cell": 2, "header": 2, "empty": 0}, {"cell": 0, "header": 3, "empty": 3},
             {"cell": 0, "header": 0, "empty": 1}, {}]
    assert [port_cd.choose_role(r) for r in roles] == [jax_cd.choose_role(r) for r in roles]


def test_cell_postprocess_matches_jax(parsers):
    """``postprocess`` on hand-made detections, with the whole-table
    fallbacks (no group; then no cell either) and noise cells."""
    jax, port, _, _ = parsers
    rng = np.random.default_rng(3)
    table = type("T", (), {"box": [100, 50, 500, 350], "role": None})()
    data = {"size": (300, 400), "offset": (100, 50)}
    cases = []
    boxes = np.asarray(_boxes(rng, 30), np.float32)
    labels = rng.choice([1, 3, 6, 7, 0], size=30)
    cases.append(dict(labels=labels, boxes=boxes, scores=rng.random(30).astype("float32")))
    cases.append(dict(labels=np.asarray([1, 1]), boxes=np.asarray(
        [[0, 0, 400, 300], [10, 10, 15, 15]], np.float32), scores=np.ones(2, np.float32)))
    cases.append(dict(labels=np.zeros(0, int), boxes=np.zeros((0, 4), np.float32),
                      scores=np.zeros(0, np.float32)))
    for preds in cases:
        want = jax.cell_detector.postprocess(preds, data, table.box)
        got = port.cell_detector.postprocess(preds, data, table.box)
        assert [c.model_dump() for c in got] == [c.model_dump() for c in want]


# ------------------------------------------------- grid and key-value parsing


def _grid(rng, rows, cols, jitter=0, span=False, header_rows=1, empty=0.0):
    """rows x cols cells, ``header_rows`` of headers (nested when 2), a
    2-row span, empty cells at share ``empty``."""
    cw, ch = 80, 30
    out, occupied = [], set()
    if span and rows > 2 and cols > 2:
        r0, c0 = int(rng.integers(header_rows, rows - 1)), int(rng.integers(0, cols))
        occupied = {(r0, c0), (r0 + 1, c0)}
        out.append(("cell", [c0 * cw, r0 * ch, (c0 + 1) * cw - 2, (r0 + 2) * ch - 2]))
    for r in range(rows):
        for c in range(cols):
            if (r, c) in occupied:
                continue
            if header_rows == 2 and r == 0 and c % 2 == 1:
                continue  # the nested header's top spans two columns
            jx, jy = (rng.integers(-jitter, jitter + 1, 2) if jitter else (0, 0))
            x2 = (c + 2 if header_rows == 2 and r == 0 else c + 1) * cw - 2
            role = ("header" if r < header_rows else
                    "empty" if rng.random() < empty else "cell")
            out.append((role, [c * cw + jx, r * ch + jy, x2 + jx, (r + 1) * ch - 2 + jy]))
    return out


def _kv(rng, n, x0=0, y0=0):
    """(header | value) pairs stacked with gaps, one key column."""
    out = []
    for i in range(n):
        y = y0 + i * 44
        out.append(("header", [x0, y, x0 + 98, y + 36]))
        out.append(("cell", [x0 + 100, y, x0 + 260, y + 36]))
    return out


def _scattered(rng, n):
    return [(str(rng.choice(["cell", "header", "empty"])), b) for b in _boxes(rng, n)]


LAYOUTS = {
    "grid": lambda rng: _grid(rng, 4, 5),
    "jitter": lambda rng: _grid(rng, 5, 4, jitter=3),
    "span": lambda rng: _grid(rng, 6, 4, span=True),
    "empty_cells": lambda rng: _grid(rng, 5, 5, empty=0.3),
    "nested_headers": lambda rng: _grid(rng, 5, 4, header_rows=2),
    "kv": lambda rng: _kv(rng, 5),
    "kv_columns": lambda rng: _kv(rng, 4) + _kv(rng, 4, x0=300),
    "grid_and_kv": lambda rng: _grid(rng, 4, 4) + _kv(rng, 3, y0=200),
    "scattered": lambda rng: _scattered(rng, 12),
}


def _table_inputs(schemas, layout, rng_seed, with_group=True):
    """One page of two tables built from ``layout`` (the second shifted
    down), their cells with a word in most of them, and a paragraph:
    (results_ocr, results_table, paragraphs) in ``schemas``' classes."""
    sch, doc = schemas
    rng = np.random.default_rng(rng_seed)
    cells_in = LAYOUTS[layout](rng)
    tables, words = [], []
    for t, dy in enumerate((0, 400)):
        cells = []
        for i, (role, (x1, y1, x2, y2)) in enumerate(cells_in):
            box = [int(x1), int(y1 + dy), int(x2), int(y2 + dy)]
            cells.append(sch.CellSchema(id=f"c{i}", box=box, role=role, contents=None,
                                        row=None, col=None, row_span=None, col_span=None))
            if role != "empty" and (i + t) % 5:
                pad = 3
                words.append(dict(points=[[box[0] + pad, box[1] + pad], [box[2] - pad, box[1] + pad],
                                          [box[2] - pad, box[3] - pad], [box[0] + pad, box[3] - pad]],
                                  content=f"{role[0]}{t}_{i}", direction="horizontal",
                                  det_score=0.9, rec_score=0.8))
        if with_group:
            xs = [c.box for c in cells]
            cells.append(sch.CellSchema(
                id=f"c{len(cells)}", role="group", contents=None, row=None, col=None,
                row_span=None, col_span=None,
                box=[min(b[0] for b in xs), min(b[1] for b in xs),
                     max(b[2] for b in xs), max(b[3] for b in xs)]))
        tables.append(sch.TableDetectorSchema(
            id=None, role=None, cells=cells,
            box=[0, dy, 700, dy + 380]))
    words.append(dict(points=[[720, 10], [800, 10], [800, 40], [720, 40]], content="para",
                      direction="horizontal", det_score=0.9, rec_score=0.8))
    paragraphs = [doc.Element(id=None, box=[710, 0, 900, 60], score=0.7, role=None,
                              contents=None)]
    return doc.OCRSchema(words=words), tables, paragraphs


def _bare(cls):
    parser = object.__new__(cls)
    parser.visualize = False
    parser.merge_same_column_values = False
    return parser


_JAX_SCHEMAS = (jax_schema, jax_schemas)
_PORT_SCHEMAS = (port_schema, port_schemas)


def _finalized(layout, seed, **kwargs):
    out = []
    for cls, schemas in ((jax_tsp.TableSemanticParser, _JAX_SCHEMAS),
                         (port_tsp.TableSemanticParser, _PORT_SCHEMAS)):
        ocr, tables, paragraphs = _table_inputs(schemas, layout, seed)
        out.append(_bare(cls)._finalize(None, ocr, tables, paragraphs, **kwargs)[0])
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_grid_and_kv_parsers_match_jax(layout, seed):
    """``_finalize`` on generated cell layouts (clustering, the grid and
    key-value parsers, ids, the words' aggregation): the schemas equal."""
    want, got = _finalized(layout, seed)
    assert got.model_dump() == want.model_dump(), _first_difference(
        got.model_dump(), want.model_dump())
    if layout in ("grid", "span", "nested_headers"):
        assert all(t.grids for t in got.tables)
    if layout in ("kv", "kv_columns"):
        assert all(t.kv_items for t in got.tables)


@pytest.mark.parametrize("option", ["grid_only", "kv_only"])
@pytest.mark.parametrize("layout", ["grid_and_kv", "span", "kv_columns"])
def test_finalize_options_match_jax(layout, option):
    want, got = _finalized(layout, 0, **{option: True})
    assert got.model_dump() == want.model_dump(), _first_difference(
        got.model_dump(), want.model_dump())


def test_merged_column_values_match_jax():
    out = []
    for cls, schemas in ((jax_tsp.TableSemanticParser, _JAX_SCHEMAS),
                         (port_tsp.TableSemanticParser, _PORT_SCHEMAS)):
        parser = _bare(cls)
        parser.merge_same_column_values = True
        out.append(parser._finalize(None, *_table_inputs(schemas, "nested_headers", 0))[0])
    assert out[1].model_dump() == out[0].model_dump()


# ------------------------------------------------------ TableSemanticParser


def check_semantic_parser(parsers):
    jax, port, page, _ = parsers
    want, _, _ = jax(page)
    got, _, _ = port(page)
    assert len(got.tables) >= 2 and len(got.words) >= 6
    assert any(t.grids for t in got.tables) and any(t.kv_items for t in got.tables)
    assert [t.id for t in got.tables] == [f"t{i}" for i in range(len(got.tables))]
    assert [p.id for p in got.paragraphs] == [f"p{i}" for i in range(len(got.paragraphs))]
    _same_semantic(got, want)


def test_semantic_parser_matches_jax(parsers, pinned):
    check_semantic_parser(parsers)


def test_semantic_parser_unpinned_matches_jax(parsers):
    """The real cell detections, where the tables keep only their
    cells."""
    jax, port, page, _ = parsers
    want, _, _ = jax(page)
    got, _, _ = port(page)
    assert sum(len(t.cells) for t in got.tables) > 20
    _same_semantic(got, want)


@pytest.mark.parametrize("option", ["grid_only", "kv_only"])
def test_semantic_options_match_jax(parsers, pinned, option):
    jax, port, page, _ = parsers
    want, _, _ = jax(page, **{option: True})
    got, _, _ = port(page, **{option: True})
    _same_semantic(got, want)
    if option == "kv_only":
        assert not any(t.grids for t in got.tables)


def test_template_round_trip(parsers, pinned, tmp_path):
    """A template saved from the port's parse and applied on both sides."""
    jax, port, page, _ = parsers
    first, _, _ = port(page)
    path = tmp_path / "template.json"
    first.save_template_json(str(path))
    want, _, _ = jax(page, template=str(path))
    got, _, _ = port(page, template=str(path))
    _same_semantic(got, want)
    assert got.model_dump() != first.model_dump()  # the template was applied


def test_visualizations_match_jax(parsers, pinned):
    jax, port, page, _ = parsers
    _, want_layout, want_ocr = jax(page)
    _, got_layout, got_ocr = port(page)
    assert got_layout.shape == page.shape and (got_layout != page).any()
    np.testing.assert_array_equal(got_layout, want_layout)
    np.testing.assert_array_equal(got_ocr, want_ocr)


def test_cell_detector_visualizer_matches_jax(parsers, pinned):
    _, port, page, _ = parsers
    got, _, _ = port(page)
    cells = [c for t in got.tables for c in t.cells.values()]
    want = jax_vis.cell_detector_visualizer(page, page, cells)
    for g, w in zip(port_vis.cell_detector_visualizer(page, page, cells), want):
        np.testing.assert_array_equal(g, w)


def test_batch_matches_call(parsers, pinned):
    """``batch`` at max_in_flight 4 on pages that share the recognizer's AR
    loop: each page equal to its own ``__call__``."""
    _, port, page, _ = parsers
    pages = [page, page[:700], page[:, :1000], page]
    want = [port(p)[0].model_dump() for p in pages]
    got = port.batch(pages, max_in_flight=4)
    assert [g[0].model_dump() for g in got] == want
    assert port.batch([]) == []


def check_uploads(parsers, route, monkeypatch):
    """The page route uploads the page once, for the detector, the layout
    parser, the cell detector and the recognizer; the host route uploads
    none."""
    _, port, page, _ = parsers
    made = []
    init = port_dc.DevicePage.__init__
    monkeypatch.setattr(port_dc.DevicePage, "__init__",
                        lambda self, *a, **k: made.append(self) or init(self, *a, **k))
    port(page)
    assert len(made) == (1 if route == "page" else 0)


def test_host_route_uploads_no_page(parsers, monkeypatch):
    check_uploads(parsers, "host", monkeypatch)


def test_detector_and_layout_keep_their_threads(parsers, monkeypatch):
    """The detector and the layout parser run on the parser's two worker
    threads, the same ones from call to call (the JAX package makes two
    per page)."""
    _, port, page, _ = parsers
    seen = []
    for module in (port.text_detector, port.layout_parser):
        post = module.postprocess
        monkeypatch.setattr(module, "postprocess",
                            lambda *a, _post=post: seen.append(threading.get_ident())
                            or _post(*a))
    for _ in range(3):
        port(page)
    assert len(seen) == 6 and threading.get_ident() not in seen
    assert set(seen) <= {t.ident for t in port._workers._threads} and len(set(seen)) <= 2


def test_devices_raise():
    """``num_devices`` above 1, and CUDA without a card, raise: the port
    neither spreads pages over cards nor falls back to the CPU."""
    with pytest.raises(NotImplementedError):
        port_tsp.TableSemanticParser(configs=CONFIGS, device="cpu", num_devices=2)
    with pytest.raises(NotImplementedError):
        port_cd.CellDetector(path_cfg=CONFIGS["table_cell_parser"]["path_cfg"],
                             from_pretrained=False, device="cpu", num_devices=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            port_cd.CellDetector(path_cfg=CONFIGS["table_cell_parser"]["path_cfg"],
                                 from_pretrained=False)
        with pytest.raises(RuntimeError, match="is_available"):
            port_tsp.TableSemanticParser(configs=CONFIGS)


def test_constructor_arguments_match_jax():
    """The same parameters and defaults as the JAX classes, but the
    device, which defaults to CUDA."""
    import inspect

    for jax_cls, port_cls in ((jax_tsp.TableSemanticParser, port_tsp.TableSemanticParser),
                              (jax_cd.CellDetector, port_cd.CellDetector)):
        want = dict(inspect.signature(jax_cls.__init__).parameters)
        got = dict(inspect.signature(port_cls.__init__).parameters)
        assert want.pop("device").default == "tpu"
        assert got.pop("device").default == "cuda"
        got.pop("dtype", None)
        assert {k: v.default for k, v in got.items()} == {k: v.default for k, v in want.items()}
    for name in ("__call__", "batch", "_finalize", "aggregate"):
        assert (inspect.signature(getattr(port_tsp.TableSemanticParser, name)).parameters.keys()
                == inspect.signature(getattr(jax_tsp.TableSemanticParser, name)).parameters.keys())


# ----------------------------------------------------------- schema facades


@pytest.fixture(scope="module")
def facade_schemas():
    """The same semantic parse (a grid and key-value items with readable
    contents) as each package's TableSemanticParserSchema."""
    want, _ = _finalized("grid_and_kv", 0)
    data = json.loads(json.dumps(want.model_dump()))
    return (jax_schema.TableSemanticParserSchema.model_validate(data),
            port_schema.TableSemanticParserSchema.model_validate(data))


def _dumped(value):
    if isinstance(value, list):
        return [_dumped(v) for v in value]
    if isinstance(value, dict):
        return {k: _dumped(v) for k, v in value.items()}
    if hasattr(value, "model_dump"):
        return value.model_dump()
    return value


def test_schema_facades_match_jax(facade_schemas, tmp_path):
    results = []
    for schema, side in zip(facade_schemas, ("jax", "port")):
        out = tmp_path / side
        out.mkdir()
        table = schema.tables[0]
        key = next(c.contents for c in table.cells.values() if c.role == "header" and c.contents)
        value = next(c.contents for c in table.cells.values() if c.role == "cell" and c.contents)
        r = {
            "kv": table.view.kv_items_to_dict(),
            "kv_merged": table.view.kv_items_to_dict(merge_values=True, separator="|"),
            "grids": table.view.grids_to_dict(),
            "grids_spaced": table.view.grids_to_dict(ignore_space=False),
            "by_bbox": table.search_cells_by_bbox([0, 0, 200, 100]),
            "by_query": table.search_cells_by_query(value),
            "below": table.search_cells_below_key_text(key),
            "upper": table.search_cells_upper_key_text(value),
            "right": table.search_cells_right_of_key_text(key),
            "left": table.search_cells_left_of_key_text(value),
            "kv_by_key": table.search_kv_items_by_key(key),
            "by_column": table.find_table_by_column_name([key]),
            "safe": table.safe_contents(next(iter(table.cells))),
            "words": schema.search_words_by_position([0, 0, 300, 200]),
            "to_dict": schema.to_dict(),
            "to_dict_merged": schema.to_dict(merge_values=True),
            "table_by_id": schema.find_table_by_id("t1"),
            "table_by_position": schema.find_table_by_position([0, 390, 700, 790]),
            "all_kv_by_key": schema.search_kv_items_by_key(key),
        }
        table.export.to_json(str(out / "table.json"))
        table.export.to_json(str(out / "table_merged.json"), merge_values=True)
        table.export.grids_to_csv(str(out / "grids.csv"))
        table.export.grids_to_csv(str(out / "grids_key.csv"), columns=[key])
        table.export.grids_to_json(str(out / "grids.json"))
        table.export.kv_items_to_json(str(out / "kv.json"))
        schema.to_csv(str(out))
        schema.to_json(str(out / "schema.json"))
        schema.save_template_json(str(out / "template.json"))
        r["files"] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
        r["load_json"] = type(schema).load_json(str(out / "schema.json")).model_dump()
        results.append(_dumped(r))
    want, got = results
    assert want["kv"] and want["grids"] and want["by_query"] and len(want["files"]) >= 10
    assert got == want, _first_difference(got, want)
