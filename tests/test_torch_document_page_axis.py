"""The page axis of the port's DocumentAnalyzer, CPU, f32:
``FusedPageAnalysis.batch_call`` against the program's per-page call, the
fused page-axis route (``_batch_dp_fused``) against ``__call__``, and the
stage-batched host route (``_batch_dp_host``) against the JAX package's
on the same weights.

Models: the small configs and calibrated heads of
tests/test_torch_document_analyzer.py.  Held: ``batch_call``'s u8 map
within one step of the per-page call's, the rest within rtol 1e-4, atol
1e-3 (the JAX package's test of its ``batch_call``); the page-axis
routes' schemas equal to ``__call__``'s with floats within 2/255 (the JAX
tests' ``_close``); the host route equal to JAX's in quads, boxes (cells
within 1 px) and strings, scores within rtol 1e-4.  The chunks a route
sends are counted with a spy on ``batch_call``: [1, 1] by default and [2]
at YOMITOKU_TPU_DP_CHUNK=2 for two pages (JAX
tests/test_fused_page.py:392-421), and one batch per stage on the host
route."""

import numpy as np
import pytest
import torch

from test_torch_document_analyzer import _same_document, analyzers, text_page  # noqa: F401
from test_torch_document_analyzer_fused import analyzer  # noqa: F401
from yomitoku_tpu_torch import document_analyzer as port_da
from yomitoku_tpu_torch.ops import fused_page
from yomitoku_tpu_torch.ops.device_crop import DevicePage, DevicePages
from yomitoku_tpu_torch.parallel import make_mesh, runner

#: three distinct pages, the last of another true size (one padded shape)
PAGES = [text_page(), text_page(3), text_page(5, 150, 210)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small models gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def page_route(monkeypatch):
    monkeypatch.setenv("YOMITOKU_TPU_DEVICE_CROPS", "1")
    for name in ("YOMITOKU_TPU_NO_FUSED_PAGE", "YOMITOKU_TPU_HOST_CROPS",
                 "YOMITOKU_TPU_REC_WIDTH_BUCKETS", "YOMITOKU_TPU_FUSED_REGION_TOPK",
                 "YOMITOKU_TPU_DP_CHUNK"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture
def host_route(monkeypatch):
    for name in ("YOMITOKU_TPU_DEVICE_CROPS", "YOMITOKU_TPU_HOST_CROPS",
                 "YOMITOKU_TPU_REC_WIDTH_BUCKETS", "YOMITOKU_TPU_DP_CHUNK"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture
def batch_calls(monkeypatch):
    """The page counts of every ``batch_call``."""
    seen = []
    real = fused_page.FusedPageAnalysis.batch_call

    def spy(self, pages_dev, page_hws, *args, **kwargs):
        seen.append(pages_dev.shape[0])
        return real(self, pages_dev, page_hws, *args, **kwargs)

    monkeypatch.setattr(fused_page.FusedPageAnalysis, "batch_call", spy)
    return seen


def close(want, got, path="schema"):
    """Structural equality, floats within 2/255."""
    if isinstance(want, dict):
        assert want.keys() == got.keys(), path
        for k in want:
            close(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            close(a, b, f"{path}[{i}]")
    elif isinstance(want, float) or isinstance(got, float):
        assert abs(float(want) - float(got)) <= 2.0 / 255.0, f"{path}: {want} != {got}"
    else:
        assert want == got, f"{path}: {want!r} != {got!r}"


def test_batch_call_matches_per_page(analyzer, page_route):
    da, _ = analyzer
    prog = da._ensure_fused_program()
    lp = da.layout.layout_parser
    det_hw, lay_hw = (64, 96), tuple(lp._cfg.data.img_size)
    tsr_hw = tuple(da.layout.table_structure_recognizer._cfg.data.img_size)
    pages = DevicePages(PAGES, "cpu")
    assert pages.dev.shape == (3, 512, 512, 3)
    assert pages.hws == [(120, 180), (120, 180), (150, 210)]
    batched = prog.batch_call(pages.dev, pages.hws, det_hw, lay_hw, tsr_hw,
                              executor=da._workers)
    assert len(batched) == 3
    tables = 0
    for img, got in zip(PAGES, batched):
        page = DevicePage(img, "cpu")
        want = prog(page, page.hw, det_hw, lay_hw, tsr_hw)
        for name, a, b in zip(("prob", "packed", "packed_t", "sel", "valid"), want, got):
            assert a.shape == b.shape and a.dtype == b.dtype, name
            if name == "prob":
                assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1
            else:
                np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-3, err_msg=name)
        tables += int(want[4].sum())
    assert tables > 0  # some slot held a table


def test_page_view_is_the_page(analyzer, page_route):
    pages = DevicePages(PAGES, "cpu")
    for i, img in enumerate(PAGES):
        view = pages.page(i)
        assert view.hw == img.shape[:2]
        np.testing.assert_array_equal(view.dev.numpy(), DevicePage(img, "cpu").dev.numpy())


def test_batch_dp_fused_chunks(analyzer, page_route, batch_calls, monkeypatch):
    """Two pages: one page a ``batch_call`` by default, both in one at
    YOMITOKU_TPU_DP_CHUNK=2; the schemas are ``__call__``'s, in input
    order."""
    da, _ = analyzer
    imgs = PAGES[:2]
    want = [da(img)[0].model_dump() for img in imgs]
    results = da._batch_dp_fused(imgs)
    assert batch_calls == [1, 1]
    for w, (got, ocr, lay) in zip(want, results):
        assert ocr is None and lay is None
        close(w, got.model_dump())
    batch_calls.clear()
    monkeypatch.setenv("YOMITOKU_TPU_DP_CHUNK", "2")
    results = da._batch_dp_fused(imgs)
    assert batch_calls == [2]
    for w, (got, _, _) in zip(want, results):
        close(w, got.model_dump())


def test_batch_dp_fused_pads_a_short_chunk(analyzer, page_route, batch_calls,
                                           monkeypatch):
    """Three pages at chunks of two: the second chunk repeats its page,
    whose padded lane is dropped; the third page's size differs, so it
    groups apart (another detector size)."""
    da, _ = analyzer
    imgs = [PAGES[0], PAGES[2], PAGES[1]]
    want = [da(img)[0].model_dump() for img in imgs]
    monkeypatch.setenv("YOMITOKU_TPU_DP_CHUNK", "2")
    results = da._batch_dp_fused(imgs)
    assert sorted(batch_calls) == [2, 2]
    assert len(results) == 3
    for w, (got, _, _) in zip(want, results):
        close(w, got.model_dump())


def test_batch_routes_to_the_page_axis(analyzer, page_route, batch_calls, monkeypatch):
    """``batch`` takes ``_batch_dp`` with ``num_devices`` above 1, two or
    more pages and no ``visualize``; it keeps its threads otherwise."""
    da, _ = analyzer
    imgs = PAGES[:2]
    want = [da(img)[0].model_dump() for img in imgs]
    monkeypatch.setattr(da, "num_devices", 2)
    results = da.batch(imgs)
    assert batch_calls == [1, 1]
    for w, (got, _, _) in zip(want, results):
        close(w, got.model_dump())
    batch_calls.clear()
    da.batch(imgs[:1])
    monkeypatch.setattr(da, "num_devices", -1)  # as in JAX: not above 1
    da.batch(imgs)
    monkeypatch.setattr(da, "num_devices", 2)
    monkeypatch.setattr(da, "visualize", True)
    monkeypatch.setattr(da, "_batch_dp", lambda imgs: pytest.fail("page axis taken"))
    assert len(da.batch(imgs)) == 2
    assert batch_calls == []


def test_batch_dp_fused_over_replicas(analyzer, page_route, batch_calls, monkeypatch):
    """Under a two-device mesh (the CPU named twice) a chunk is two pages,
    and each of its batches splits over the models' two replicas."""
    da, _ = analyzer
    imgs = PAGES[:2]
    want = [da(img)[0].model_dump() for img in imgs]
    mesh = make_mesh(devices=["cpu", "cpu"])
    monkeypatch.setattr(port_da, "dp_mesh", lambda *a, **k: mesh)
    models = [da.text_detector.model, da.layout.layout_parser.model,
              da.layout.table_structure_recognizer.model]
    runs = []
    real = runner.Replicas.run

    def spy(self, fn, chunks, *static):
        runs.append(self.models[0])
        return real(self, fn, chunks, *static)

    monkeypatch.setattr(runner.Replicas, "run", spy)
    try:
        for m in models:
            m.use_mesh(mesh)
        results = da._batch_dp_fused(imgs)
    finally:
        for m in models:
            m.use_mesh(None)
    assert batch_calls == [2]
    # the detector and the layout on two pages, the table recognizer on
    # eight slots: each batch split over the two replicas
    assert {id(m) for m in runs} == {id(m) for m in models}
    for w, (got, _, _) in zip(want, results):
        close(w, got.model_dump())


def test_batch_dp_host_matches_jax(analyzers, host_route, monkeypatch):  # noqa: F811
    """``batch`` with ``num_devices=2`` on the host route is the port's
    ``_batch_dp_host``: against the JAX package's on the same weights, and
    against the port's own ``__call__`` per page, in input order."""
    jax, port, _ = analyzers
    want = jax._batch_dp_host(PAGES)
    stages = []
    for name, model in (("det", port.text_detector.model),
                        ("layout", port.layout.layout_parser.model),
                        ("tsr", port.layout.table_structure_recognizer.model)):
        real = model.run_placed
        monkeypatch.setattr(model, "run_placed",
                            lambda fn, x, *s, _n=name, _r=real: stages.append(_n) or _r(fn, x, *s))
    monkeypatch.setattr(port, "num_devices", 2)
    got = port.batch(PAGES)
    # the two 120x180 pages in one detector forward, the third in another;
    # every page's tile in one layout forward; every table in one
    assert stages == ["det", "det", "layout", "tsr"]
    assert len(got) == 3
    assert sum(len(g[0].words) for g in got) > 10
    assert any(g[0].tables for g in got)
    for (g, _, _), (w, _, _) in zip(got, want):
        _same_document(g, w)
    monkeypatch.undo()
    for img, (g, _, _) in zip(PAGES, got):
        _same_document(g, port(img)[0])


@pytest.mark.slow
def test_batch_dp_fused_matches_jax(analyzers, page_route):  # noqa: F811
    """The port's fused page axis against the JAX package's (its
    ``_batch_dp_fused`` on one device: one page a chunk) on the same
    weights, two pages; slow, as the JAX fused route is on the CPU."""
    jax, port, _ = analyzers
    want = jax._batch_dp_fused(PAGES[:2])
    got = port._batch_dp_fused(PAGES[:2])
    for (g, _, _), (w, _, _) in zip(got, want):
        _same_document(g, w)
