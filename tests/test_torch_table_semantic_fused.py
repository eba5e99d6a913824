"""The port's TableSemanticParser on its fused page route
(ops/fused_page.py with the cell detector in the region slot) against its
own unfused route, CPU, f32, on the page route
(YOMITOKU_TPU_DEVICE_CROPS=1): tests/test_torch_table_semantic_page.py
holds the unfused route against the JAX package's.

Models: the small configs and calibrated heads of
tests/test_torch_table_semantic.py on its 1440x960 page (two tables on
the page route, one pinned as a grid and one as key-value rows), with the
port's own recognizer init.  Held as that file holds them: the
schemas equal field by field, scores within rtol 1e-4.  Cases: the real
cell detections and the pinned ones (``pinned_filter_packed``, keyed by a
crop's size, so that the unfused route's one call for all tables and the
fused route's call per slot pin the same layouts); five tables (the
layout's output pinned) taking four slots and the chunked route;
``batch``; one program from four racing threads; the threads each leg
runs on; which route each case takes."""

import threading

import numpy as np
import pytest
import torch

from test_torch_document_analyzer_fused import pinned_tables, slots  # noqa: F401
from test_torch_layout import calibrate
from test_torch_table_semantic import (
    CELL_TARGETS,
    CONFIGS,
    TABLE_LAYOUT_TARGETS,
    _same_semantic,
    semantic_page,
)
from yomitoku_tpu_torch import table_semantic_parser as port_tsp
from yomitoku_tpu_torch.ops import fused_page
from yomitoku_tpu_torch.ops.device_crop import DevicePage
from yomitoku_tpu_torch.utils.synthetic_heads import pinned_filter_packed


@pytest.fixture(scope="module")
def parser():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YOMITOKU_TPU_INT8_KV", "0")
        tsp = port_tsp.TableSemanticParser(configs=CONFIGS, device="cpu", visualize=False)
    page = semantic_page()
    with torch.no_grad():
        tsp.text_detector.model.decoder.binarize[6].weight.mul_(10.0)
    lp, cd = tsp.layout_parser, tsp.cell_detector
    calibrate(lp.model, lp.preprocess(page), TABLE_LAYOUT_TARGETS)
    tables = list(lp(page)[0].tables)
    calibrate(cd.model, np.stack([d["array"] for d in cd.preprocess(page, tables)]),
              CELL_TARGETS)
    return tsp, page


@pytest.fixture(autouse=True)
def page_route(monkeypatch):
    monkeypatch.setenv("YOMITOKU_TPU_DEVICE_CROPS", "1")
    for name in ("YOMITOKU_TPU_NO_FUSED_PAGE", "YOMITOKU_TPU_HOST_CROPS",
                 "YOMITOKU_TPU_REC_WIDTH_BUCKETS", "YOMITOKU_TPU_FUSED_REGION_TOPK"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture
def pinned(parser, monkeypatch):
    cd = parser[0].cell_detector
    monkeypatch.setattr(cd.postprocessor, "filter_packed", pinned_filter_packed(cd))


def both_routes(tsp, img, monkeypatch, **kwargs):
    fused = tsp(img, **kwargs)
    monkeypatch.setenv("YOMITOKU_TPU_NO_FUSED_PAGE", "1")
    unfused = tsp(img, **kwargs)
    monkeypatch.delenv("YOMITOKU_TPU_NO_FUSED_PAGE")
    return fused[0], unfused[0]


def test_fused_route_matches_unfused(parser, slots):  # noqa: F811
    """The real cell detections: tens of cells a table."""
    tsp, page = parser
    with pytest.MonkeyPatch.context() as mp:
        got, want = both_routes(tsp, page, mp)
    assert sum(len(t.cells) for t in got.tables) > 20
    _same_semantic(got, want)
    assert slots == [(2, 2, 0)]


@pytest.mark.parametrize("option", [{}, {"kv_only": True}])
def test_pinned_fused_route_matches_unfused(parser, pinned, slots, option,  # noqa: F811
                                            monkeypatch):
    tsp, page = parser
    got, want = both_routes(tsp, page, monkeypatch, **option)
    assert len(got.tables) == 2 and any(t.kv_items for t in got.tables)
    assert bool(option) != any(t.grids for t in got.tables)
    _same_semantic(got, want)


#: five table boxes (cxcywh in [0, 1]) with their logits, apart
FIVE_TABLES = [((0.2, 0.2, 0.3, 0.3), 6.0), ((0.6, 0.2, 0.35, 0.3), 5.0),
               ((0.2, 0.7, 0.3, 0.35), 4.0), ((0.55, 0.7, 0.25, 0.3), 3.5),
               ((0.85, 0.65, 0.2, 0.4), 3.0)]


def test_five_tables_pin_the_same_layouts(parser, pinned, slots, pinned_tables,  # noqa: F811
                                          monkeypatch):
    """Five tables: four slots, one on the chunked route; each table's
    pinned layout the same on both routes, grids and key-value items on
    the page."""
    tsp, page = parser
    pinned_tables(tsp.layout_parser, FIVE_TABLES)
    got, want = both_routes(tsp, page, monkeypatch)
    assert slots == [(5, 4, 1)]
    assert len(got.tables) == 5
    assert any(t.grids for t in got.tables) and any(t.kv_items for t in got.tables)
    _same_semantic(got, want)


def test_pins_keyed_by_size(parser):
    """A crop's pinned layout depends on its size alone, not on the other
    crops of its call."""
    cd = parser[0].cell_detector
    pin = pinned_filter_packed(cd)
    sizes = [[287, 154], [269, 239], [232, 218], [100, 101], [100, 100]]
    packed = np.zeros((len(sizes), cd.postprocessor.num_top_queries, 6), np.float32)
    together = pin(packed, sizes, cd.thresh_score)
    alone = [pin(packed[i:i + 1], [s], cd.thresh_score)[0] for i, s in enumerate(sizes)]
    backwards = pin(packed[::-1], sizes[::-1], cd.thresh_score)[::-1]
    for a, b, c in zip(together, alone, backwards):
        for key in ("labels", "boxes", "scores"):
            np.testing.assert_array_equal(a[key], b[key])
            np.testing.assert_array_equal(a[key], c[key])
    assert len({len(t["labels"]) for t in together}) == 2  # both layouts


def test_batch_matches_call(parser, pinned):
    tsp, page = parser
    pages = [page, page[:700], page[:, :1000], page]
    want = [tsp(p)[0].model_dump() for p in pages]
    got = tsp.batch(pages, max_in_flight=4)
    assert [g[0].model_dump() for g in got] == want


def test_one_program_from_racing_threads(parser, monkeypatch):
    tsp, _ = parser
    monkeypatch.setattr(tsp, "_fused_page_program", None)
    barrier = threading.Barrier(4)
    got = []

    def race():
        barrier.wait()
        got.append(tsp._ensure_fused_program())

    threads = [threading.Thread(target=race) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 4 and all(g is got[0] for g in got)
    assert got[0].trace_label == "det+layout+cell" and got[0].tsr is tsp.cell_detector.model


def test_threads(parser, monkeypatch):
    """The legs on the parser's two kept workers, the recognizer on its
    kept pool of eight."""
    tsp, page = parser
    seen = {"det": [], "lay": [], "rec": []}
    for key, model in (("det", tsp.text_detector.model), ("lay", tsp.layout_parser.model),
                       ("rec", tsp.text_recognizer.model)):
        name = "forward_tokens_from_page" if key == "rec" else "forward_from_page"
        real = getattr(model, name)
        monkeypatch.setattr(model, name, lambda *a, _k=key, _r=real, **k: seen[_k].append(
            threading.current_thread().name) or _r(*a, **k))
    tsp(page)
    tsp(page)
    assert len(seen["det"]) == len(seen["lay"]) == 2
    assert all(n.startswith("TableSemanticParser") for n in seen["det"] + seen["lay"])
    assert seen["rec"] and all(n.startswith("tsp-rec") for n in seen["rec"])
    assert len(tsp._rec_executor()._threads) <= 8


def test_routes(parser, monkeypatch):
    tsp, page = parser
    dev_page = DevicePage(page, "cpu")
    assert tsp._takes_fused_route(dev_page) and not tsp._takes_fused_route(None)
    for module in (tsp.text_detector, tsp.layout_parser, tsp.cell_detector):
        with monkeypatch.context() as mp:
            mp.setattr(module, "device", torch.device("meta"))
            assert not tsp._takes_fused_route(dev_page)
    monkeypatch.setenv("YOMITOKU_TPU_NO_FUSED_PAGE", "1")
    assert not tsp._takes_fused_route(dev_page)
    calls = []
    real = fused_page.FusedPageAnalysis.__call__
    monkeypatch.setattr(fused_page.FusedPageAnalysis, "__call__",
                        lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    tsp(page)
    monkeypatch.delenv("YOMITOKU_TPU_NO_FUSED_PAGE")
    tsp(page)
    assert len(calls) == 1
