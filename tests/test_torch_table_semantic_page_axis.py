"""The page axis of the port's TableSemanticParser (``_batch_dp_fused``,
the fused page program's ``batch_call`` with the cell detector in the
region slot) against its own ``__call__``, CPU, f32, on the page route
(YOMITOKU_TPU_DEVICE_CROPS=1).

Models and page: tests/test_torch_table_semantic_fused.py's (visualize
off), and the same page drawn with three lines, both 1440x960.  Held: the
schemas equal to ``__call__``'s with floats within 2/255 (the JAX tests'
``_close``), in input order, with the cells' real detections and pinned
(``pinned_filter_packed``: grids and key-value items); the chunks counted
with a spy on ``batch_call``: [1, 1] by default and [2] at
YOMITOKU_TPU_DP_CHUNK=2 (JAX tests/test_fused_semantic.py:149-190);
``batch`` routing there with ``num_devices`` above 1 and not otherwise."""

import cv2
import pytest
import torch

from test_torch_document_analyzer import text_page
from test_torch_document_page_axis import batch_calls, close  # noqa: F401
from test_torch_table_semantic import semantic_page
from test_torch_table_semantic_fused import page_route, parser, pinned  # noqa: F401

PAGES = [semantic_page(),
         cv2.resize(text_page(3), (1440, 960), interpolation=cv2.INTER_LINEAR)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small models gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def default_chunk(monkeypatch):
    monkeypatch.delenv("YOMITOKU_TPU_DP_CHUNK", raising=False)


def _check(tsp, results, want):
    assert len(results) == len(want)
    for w, (got, vis_layout, vis_ocr) in zip(want, results):
        assert vis_layout is None and vis_ocr is None
        close(w, got.model_dump())


@pytest.mark.parametrize("cells", ["real", "pinned"])
def test_batch_dp_fused_chunks(parser, batch_calls, cells, request,  # noqa: F811
                               monkeypatch):
    tsp, _ = parser
    if cells == "pinned":
        request.getfixturevalue("pinned")
    want = [tsp(img)[0].model_dump() for img in PAGES]
    assert any(w["tables"] for w in want)
    if cells == "pinned":
        assert any(t["grids"] for w in want for t in w["tables"])
        assert any(t["kv_items"] for w in want for t in w["tables"])
    _check(tsp, tsp._batch_dp_fused(PAGES), want)
    assert batch_calls == [1, 1]
    batch_calls.clear()
    monkeypatch.setenv("YOMITOKU_TPU_DP_CHUNK", "2")
    _check(tsp, tsp._batch_dp_fused(PAGES), want)
    assert batch_calls == [2]


def test_batch_dp_fused_options(parser, pinned, batch_calls, monkeypatch):  # noqa: F811
    """``grid_only`` / ``kv_only`` reach each page's ``_finalize``."""
    tsp, _ = parser
    for option in ({"kv_only": True}, {"grid_only": True}):
        want = [tsp(img, **option)[0].model_dump() for img in PAGES]
        _check(tsp, tsp._batch_dp_fused(PAGES, **option), want)


def test_batch_routes_to_the_page_axis(parser, batch_calls, monkeypatch):  # noqa: F811
    tsp, _ = parser
    want = [tsp(img)[0].model_dump() for img in PAGES]
    monkeypatch.setattr(tsp, "num_devices", 2)
    _check(tsp, tsp.batch(PAGES), want)
    assert batch_calls == [1, 1]
    batch_calls.clear()
    tsp.batch(PAGES[:1])
    monkeypatch.setenv("YOMITOKU_TPU_NO_FUSED_PAGE", "1")
    _check(tsp, tsp.batch(PAGES), want)  # threads on the unfused route
    monkeypatch.delenv("YOMITOKU_TPU_NO_FUSED_PAGE")
    monkeypatch.setattr(tsp, "num_devices", None)
    tsp.batch(PAGES)
    assert batch_calls == []
