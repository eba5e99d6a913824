"""The port's DocumentAnalyzer on its fused page route
(ops/fused_page.py) against its own unfused route, CPU, f32, on the page
route (YOMITOKU_TPU_DEVICE_CROPS=1): tests/test_torch_document_analyzer.py
holds the unfused route against the JAX package's, and the JAX package's
slow tests/test_fused_page.py holds its two routes equal.

Models: that file's small configs and calibrated heads, on its 120x180
text page, with the port's own recognizer init.  Held: words, paragraphs,
figures and tables as that file holds them (quads, strings and directions
equal, scores to rtol 1e-4, cell boxes within 1 px); the pictures pixel
for pixel.  Also: six tables (the layout's output pinned) take four slots
and the chunked route for the other two, with a tie at the slots' edge;
``batch`` against ``__call__``; one program from four racing threads; the
legs on the analyzer's kept threads; which route each case takes.  The
port's fused route against the JAX package's is the one ``slow`` test
here: the JAX fused route takes minutes on the CPU."""

import threading
import time

import numpy as np
import pytest
import torch

from test_torch_document_analyzer import (  # noqa: F401  (analyzers: a fixture)
    CONFIGS,
    _same_document,
    _visualize,
    analyzers,
    text_page,
)
from test_torch_layout import LAYOUT_TARGETS, TSR_TARGETS, calibrate
from yomitoku_tpu_torch import document_analyzer as port_da
from yomitoku_tpu_torch.ops import fused_page
from yomitoku_tpu_torch.ops.device_crop import DevicePage


@pytest.fixture(scope="module")
def analyzer():
    """The port's analyzer with the calibrated heads of
    test_torch_document_analyzer, and its page."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YOMITOKU_TPU_INT8_KV", "0")
        da = port_da.DocumentAnalyzer(configs=CONFIGS, device="cpu")
    page = text_page()
    with torch.no_grad():
        da.text_detector.model.decoder.binarize[6].weight.mul_(10.0)
    lp, tsr = da.layout.layout_parser, da.layout.table_structure_recognizer
    calibrate(lp.model, lp.preprocess(page), LAYOUT_TARGETS)
    tables = [t.box for t in lp(page)[0].tables]
    calibrate(tsr.model, np.stack([d["array"] for d in tsr.preprocess(page, tables)]),
              TSR_TARGETS)
    return da, page


@pytest.fixture(autouse=True)
def page_route(monkeypatch):
    monkeypatch.setenv("YOMITOKU_TPU_DEVICE_CROPS", "1")
    for name in ("YOMITOKU_TPU_NO_FUSED_PAGE", "YOMITOKU_TPU_HOST_CROPS",
                 "YOMITOKU_TPU_REC_WIDTH_BUCKETS", "YOMITOKU_TPU_FUSED_REGION_TOPK"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture
def slots(monkeypatch):
    """Per fused page: (tables the host kept, slot hits, tables on the
    chunked route), after checking that every kept table whose box a valid
    slot holds was a hit (the host's filter may drop a table the device
    selected: it drops boxes inside other tables, the device does not)."""
    seen = []
    real = fused_page.FusedPageAnalysis.consume_region_slots

    def spy(self, region_data, packed_t, sel, valid, *args):
        out = real(self, region_data, packed_t, sel, valid, *args)
        boxes = {(d["offset"][0], d["offset"][1], d["offset"][0] + d["size"][1],
                  d["offset"][1] + d["size"][0]) for d in region_data}
        held = boxes & {tuple(b) for b, v in zip(sel.tolist(), valid) if v}
        hits = len(region_data) - len(out[1])
        assert hits == len(held), (hits, held)
        seen.append((len(region_data), hits, len(out[1])))
        return out

    monkeypatch.setattr(fused_page.FusedPageAnalysis, "consume_region_slots", spy)
    return seen


def both_routes(da, img, monkeypatch):
    """(fused result, unfused result) of ``da(img)``."""
    fused = da(img)
    monkeypatch.setenv("YOMITOKU_TPU_NO_FUSED_PAGE", "1")
    unfused = da(img)
    monkeypatch.delenv("YOMITOKU_TPU_NO_FUSED_PAGE")
    return fused, unfused


@pytest.mark.parametrize("option", ["plain", "split_text_across_cells", "visualize"])
def test_fused_route_matches_unfused(analyzer, slots, option, monkeypatch):
    da, page = analyzer
    if option == "visualize":
        _visualize(monkeypatch, da)
    elif option != "plain":
        monkeypatch.setattr(da, option, True)
    (got, ocr_vis, layout_vis), (want, want_ocr, want_layout) = both_routes(
        da, page, monkeypatch)
    assert len(got.words) >= (8 if option == "plain" else 5)
    assert got.tables and any(t.cells for t in got.tables)
    _same_document(got, want)
    # five tables kept, of the device's four slots two hold a kept table's
    # box: its filter dropped the other two, inside kept tables
    assert slots == [(5, 2, 3)]
    if option == "visualize":
        assert not np.array_equal(layout_vis, page)
        np.testing.assert_array_equal(ocr_vis, want_ocr)
        np.testing.assert_array_equal(layout_vis, want_layout)


#: six table boxes (cx, cy, w, h in [0, 1]) and their logits: a tie at the
#: edge of the four slots, between the fourth and fifth
SIX_TABLES = [((0.18, 0.2, 0.3, 0.3), 6.0), ((0.5, 0.2, 0.3, 0.3), 5.0),
              ((0.82, 0.2, 0.3, 0.3), 4.0), ((0.18, 0.7, 0.3, 0.3), 3.0),
              ((0.5, 0.7, 0.3, 0.3), 3.0), ((0.82, 0.7, 0.3, 0.3), 2.0)]


@pytest.fixture
def pinned_tables():
    """``pin(module, tables)``: a layout model's output pinned after its
    real forward to ``tables`` [(cxcywh in [0, 1], table logit)], its other
    queries to no table, on every route."""
    handles = []

    def pin(module, tables):
        table = next(i for i, c in module.label_mapper.items() if c == "tables")

        def hook(mod, inputs, out):
            logits, boxes = out["pred_logits"].clone(), out["pred_boxes"].clone()
            logits[..., table] = -8.0
            for q, (box, logit) in enumerate(tables):
                logits[:, q] = -8.0
                logits[:, q, table] = logit
                boxes[:, q] = torch.tensor(box)
            return {**out, "pred_logits": logits, "pred_boxes": boxes}

        handles.append(module.model.decoder.register_forward_hook(hook))

    yield pin
    for h in handles:
        h.remove()


def test_six_tables_take_the_chunked_route(analyzer, slots, pinned_tables, monkeypatch):
    """Four tables take the slots, two the chunked route (enqueued before
    the contours, read back after them), merged into the unfused route's
    page."""
    da, page = analyzer
    pinned_tables(da.layout.layout_parser, SIX_TABLES)
    dispatched = []
    real = port_da.dispatch_regions_from_page
    monkeypatch.setattr(port_da, "dispatch_regions_from_page",
                        lambda model, pg, data, hw: dispatched.append(len(data))
                        or real(model, pg, data, hw))
    (got, _, _), (want, _, _) = both_routes(da, page, monkeypatch)
    assert slots == [(6, 4, 2)] and dispatched == [2]
    assert len(want.tables) >= 5
    _same_document(got, want)


def test_no_table_takes_no_slot(analyzer, slots, pinned_tables, monkeypatch):
    """A page without tables: every slot padded, none matched."""
    da, page = analyzer
    pinned_tables(da.layout.layout_parser, [])
    (got, _, _), (want, _, _) = both_routes(da, page, monkeypatch)
    assert slots == [(0, 0, 0)] and not got.tables
    _same_document(got, want)


def test_batch_matches_call(analyzer, slots):
    """``batch`` at four in flight on the fused route: each page equal to
    its own ``__call__``; the legs of four pages queue on two threads."""
    da, page = analyzer
    pages = [page, page[:90], page[:, :140], page]
    want = [da(p)[0].model_dump() for p in pages]
    got = da.batch(pages, max_in_flight=4)
    assert [g[0].model_dump() for g in got] == want
    assert len(slots) == 8


def test_one_program_from_racing_threads(analyzer, monkeypatch):
    da, _ = analyzer
    monkeypatch.setattr(da, "_fused_page_program", None)
    built = []
    init = fused_page.FusedPageAnalysis.__init__

    def slow_init(self, *args, **kwargs):
        built.append(self)
        time.sleep(0.05)
        init(self, *args, **kwargs)

    monkeypatch.setattr(fused_page.FusedPageAnalysis, "__init__", slow_init)
    barrier = threading.Barrier(4)
    got = []

    def race():
        barrier.wait()
        got.append(da._ensure_fused_program())

    threads = [threading.Thread(target=race) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(built) == 1 and all(g is built[0] for g in got) and len(got) == 4


def test_legs_run_on_the_kept_threads(analyzer, monkeypatch):
    """The detector's and the layout's legs on the analyzer's two worker
    threads, the same ones from call to call; the recognizer on the
    caller's."""
    da, page = analyzer
    seen = {"det": [], "lay": [], "rec": []}
    for key, model in (("det", da.text_detector.model),
                       ("lay", da.layout.layout_parser.model)):
        real = model.forward_from_page
        monkeypatch.setattr(model, "forward_from_page",
                            lambda *a, _k=key, _r=real: seen[_k].append(
                                threading.get_ident()) or _r(*a))
    rec = da.text_recognizer.model
    real_rec = rec.forward_tokens_from_page
    monkeypatch.setattr(rec, "forward_tokens_from_page",
                        lambda *a, **k: seen["rec"].append(threading.get_ident())
                        or real_rec(*a, **k))
    for _ in range(3):
        da(page)
    workers = {t.ident for t in da._workers._threads}
    assert len(seen["det"]) == len(seen["lay"]) == 3
    assert set(seen["det"]) | set(seen["lay"]) <= workers
    assert set(seen["rec"]) == {threading.get_ident()}


def test_routes(analyzer, monkeypatch):
    """The fused route with a DevicePage, the switch unset and the three
    models on the page's device; the unfused route otherwise (the switch,
    the host route, any of the three models on another device)."""
    da, page = analyzer
    calls = []
    real = fused_page.FusedPageAnalysis.__call__
    monkeypatch.setattr(fused_page.FusedPageAnalysis, "__call__",
                        lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    da(page)
    assert len(calls) == 1
    monkeypatch.setenv("YOMITOKU_TPU_NO_FUSED_PAGE", "1")
    da(page)
    monkeypatch.delenv("YOMITOKU_TPU_NO_FUSED_PAGE")
    monkeypatch.delenv("YOMITOKU_TPU_DEVICE_CROPS")
    da(page)
    assert len(calls) == 1

    dev_page = DevicePage(page, "cpu")
    assert da._takes_fused_route(dev_page) and not da._takes_fused_route(None)
    for module in (da.text_detector, da.layout.layout_parser,
                   da.layout.table_structure_recognizer):
        with monkeypatch.context() as mp:
            mp.setattr(module, "device", torch.device("meta"))
            assert not da._takes_fused_route(dev_page)


@pytest.mark.slow
def test_fused_route_matches_jax_fused(analyzers):  # noqa: F811
    """The port's fused route against the JAX package's on the same
    weights (the analyzers of test_torch_document_analyzer)."""
    jax_da, port, page = analyzers
    want, _, _ = jax_da(page)
    got, _, _ = port(page)
    _same_document(got, want)
