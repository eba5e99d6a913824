"""The port's stage records on the OCR path (``utils/stagetrace.py``): a
tiny OCR on the CPU (the small configs of tests/test_torch_ocr.py, random
weights, the detector's head scaled so that its map holds several quads)
on the host route and on the device-crop route.

With a collector: one ``page/call`` a call, the detector, the recognizer
and the aggregation its children under its page id, the AR loop's
``parseq/ar_wait`` and ``parseq/ar`` with one ``parseq/replay`` a step and
one ``parseq/done_wait`` a readback, the step and device-to-host counters
against counts taken by wrapping the code they count, pages on two
threads apart.  Without one: no record.  Under a CPU profiler: one range a record, named ``stage/kind``
and nested as the records are; with the profiler off, none."""

import sys
import threading
from collections import Counter
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from yomitoku_tpu_torch.models import parseq
from yomitoku_tpu_torch.ocr import OCR
from yomitoku_tpu_torch.utils import stagetrace

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {
    "text_detector": {"path_cfg": str(ROOT / "tests/yaml/det_small.yaml"),
                      "from_pretrained": False},
    "text_recognizer": {"path_cfg": str(ROOT / "tests/yaml/rec_small.yaml"),
                        "from_pretrained": False},
}
ROUTES = ["host", "device_crops"]


def synthetic_page():
    page = np.full((120, 180, 3), 255, np.uint8)
    for i, y in enumerate(range(18, 110, 25)):
        cv2.putText(page, f"line {i} ABC", (10, y), cv2.FONT_HERSHEY_SIMPLEX,
                    0.6, (0, 0, 0), 2)
    return page


@pytest.fixture(scope="module")
def ocr():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YOMITOKU_TPU_INT8_KV", "0")
        port = OCR(configs=CONFIGS, device="cpu")
    with torch.no_grad():
        port.detector.model.decoder.binarize[6].weight.mul_(10.0)
    port(synthetic_page())  # the AR loop's state made once
    return port


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    monkeypatch.delenv("YOMITOKU_TPU_HOST_CROPS", raising=False)
    if request.param == "device_crops":
        monkeypatch.setenv("YOMITOKU_TPU_DEVICE_CROPS", "1")
    else:
        monkeypatch.delenv("YOMITOKU_TPU_DEVICE_CROPS", raising=False)
    return request.param


@pytest.fixture
def early_eos(ocr):
    """The recognizer's head biased to EOS: every row ends at step 1."""
    head = ocr.recognizer.model.head
    kept = head.bias.detach().clone()
    with torch.no_grad():
        head.bias[0] = 1e4
    yield
    with torch.no_grad():
        head.bias.copy_(kept)


def _names(records):
    return Counter(r.name for r in records)


def _children(records, parent):
    return [r for r in records if r.parent == parent.id]


def _by_id(records):
    return {r.id: r for r in records}


def _grouped(records):
    out = {}
    for r in records:
        out.setdefault((r.stage, r.kind), []).append(r)
    return out


def test_one_page_call_per_call(ocr, route):
    with stagetrace.collect() as stats:
        for _ in range(2):
            ocr(synthetic_page())
    calls = [r for r in stats.records if r.name == "page/call"]
    assert len(calls) == 2 and stats.counts[("page", "call")] == 2
    assert all(r.parent is None for r in calls)
    assert calls[0].page != calls[1].page


def test_page_children_carry_its_page_id(ocr, route):
    with stagetrace.collect() as stats:
        ocr(synthetic_page())
    (call,) = [r for r in stats.records if r.name == "page/call"]
    assert _names(_children(stats.records, call)) == Counter(
        {"det/call": 1, "rec/call": 1, "page/aggregate": 1}
        | ({"page/upload": 1} if route == "device_crops" else {}))
    assert {r.page for r in stats.records} == {call.page}
    by_id = _by_id(stats.records)
    for r in stats.records:
        if r.parent is not None:
            up = by_id[r.parent]
            assert up.start_ns <= r.start_ns <= r.end_ns <= up.end_ns
            assert up.thread == r.thread
    det = next(r for r in stats.records if r.name == "det/call")
    assert _names(_children(stats.records, det)) == Counter(
        {"det/dispatch": 1, "det/sync": 1, "det/contours": 1})
    # the recognizer's batch: the crops (device route), the encoder, the
    # AR loop and the refine as leaves of its dispatch
    (dispatch,) = [r for r in stats.records if r.name == "rec/dispatch"]
    assert _names(_children(stats.records, dispatch)) == Counter(
        {"rec/encode": 1, "parseq/ar_wait": 1, "parseq/ar": 1, "rec/refine": 1}
        | ({"rec/crops": 1} if route == "device_crops" else {}))


@pytest.mark.parametrize("eos", [False, True], ids=["all_steps", "early_exit"])
def test_ar_loop_spans_and_step_counter(ocr, route, eos, request, monkeypatch):
    if eos:
        request.getfixturevalue("early_eos")
    steps = []
    real_step = parseq._CachedARLoop.step

    def counted_step(self):
        steps.append(self)
        return real_step(self)

    monkeypatch.setattr(parseq._CachedARLoop, "step", counted_step)
    with stagetrace.collect() as stats:
        ocr(synthetic_page())
    records = stats.records
    by_id = _by_id(records)
    loops = [r for r in records if r.name == "parseq/ar"]
    waits = [r for r in records if r.name == "parseq/ar_wait"]
    assert len(loops) == len(waits) >= 1
    assert {by_id[r.parent].name for r in loops + waits} == {"rec/dispatch"}
    L = ocr.recognizer.model.max_label_length + 1
    for loop in loops:
        kids = _names(_children(records, loop))
        assert set(kids) == {"parseq/reset", "parseq/replay", "parseq/done_wait"}
        assert kids["parseq/reset"] == 1
        run = kids["parseq/replay"]
        # a readback before every step but the first, and one more that
        # ends the loop early
        assert kids["parseq/done_wait"] == (run - 1 if run == L else run)
        assert run == (1 if eos else L)
    assert stats.counts[("parseq", "steps")] == len(steps) == sum(
        _names(_children(records, loop))["parseq/replay"] for loop in loops)
    assert stats.counts[("parseq", "ar")] == len(loops)


def test_d2h_counter_counts_the_readbacks(ocr, route):
    """Every ``.cpu()`` and every tensor read as a bool inside the call,
    counted by wrapping them, against ``d2h/copies``."""
    seen = Counter()
    real_cpu, real_bool = torch.Tensor.cpu, torch.Tensor.__bool__

    def cpu(self, *args, **kwargs):
        seen["cpu"] += 1
        seen["bytes"] += self.nbytes
        return real_cpu(self, *args, **kwargs)

    def as_bool(self):
        seen["bool"] += 1
        seen["bytes"] += self.nbytes
        return real_bool(self)

    page = synthetic_page()
    with stagetrace.collect() as stats, pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "cpu", cpu)
        mp.setattr(torch.Tensor, "__bool__", as_bool)
        ocr(page)
    dones = sum(1 for r in stats.records if r.name == "parseq/done_wait")
    batches = stats.counts[("rec", "sync")]
    assert seen["cpu"] == 1 + 2 * batches and seen["bool"] == dones
    assert stats.counts[("d2h", "copies")] == seen["cpu"] + seen["bool"]
    assert stats.bytes[("d2h", "copies")] == seen["bytes"]


def test_sync_segments_carry_their_bytes(ocr, route):
    with stagetrace.collect() as stats:
        result, _ = ocr(synthetic_page())
    L = ocr.recognizer.model.max_label_length + 1
    rows = stats.bytes[("rec", "sync")] // (L * 8)  # int32 ids + float32 probs
    assert rows >= len(result.words) and stats.bytes[("rec", "sync")] == rows * L * 8
    assert stats.bytes[("det", "sync")] > 0
    assert stats.bytes[("parseq", "done_wait")] == stats.counts[("parseq", "done_wait")]


def test_threads_keep_their_pages_apart(ocr, route):
    """Four client threads, two pages each, with the interpreter switching
    threads every microsecond: disjoint page ids, every record under its
    own thread's page, every parent on the same thread and page, and no
    update of a counter lost."""
    n, pages = 4, 2
    barrier = threading.Barrier(n)
    idents = {}

    def client(k):
        barrier.wait()
        idents[k] = threading.get_ident()
        for _ in range(pages):
            ocr(synthetic_page())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with stagetrace.collect() as stats:
            threads = [threading.Thread(target=client, args=(k,)) for k in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    records = stats.records
    calls = [r for r in records if r.name == "page/call"]
    assert len(calls) == n * pages == len({r.page for r in calls})
    by_thread = {t: {r.page for r in calls if r.thread == t} for t in idents.values()}
    assert all(len(mine) == pages for mine in by_thread.values())
    by_id = _by_id(records)
    for r in records:
        assert r.page in by_thread[r.thread]
        if r.parent is not None:
            assert (by_id[r.parent].thread, by_id[r.parent].page) == (r.thread, r.page)
    assert dict(stats.counts) == {
        **{key: len(rs) for key, rs in _grouped(records).items()},
        ("parseq", "steps"): _names(records)["parseq/replay"],
        ("d2h", "copies"): (n * pages + 2 * stats.counts[("rec", "sync")]
                            + stats.counts[("parseq", "done_wait")])}


def test_no_collector_no_record(ocr, route, monkeypatch):
    """Without a collector no record is made (no record id drawn) and no
    counter moves; with one, the same call makes records."""
    made = []

    class Ids:
        def __next__(self):
            made.append(None)
            return len(made)

    monkeypatch.setattr(stagetrace, "_record_ids", Ids())
    assert stagetrace._active is None
    ocr(synthetic_page())
    assert made == []
    with stagetrace.collect() as stats:
        ocr(synthetic_page())
    assert made and len(stats.records) == len(made)


def test_private_profiler_names_resolved():
    """The two private torch names a segment's profiler range rests on
    exist in this torch: a release without them leaves segments with no
    range, and this test shows it."""
    from torch.autograd import profiler

    assert stagetrace._RANGES
    assert isinstance(profiler._is_profiler_enabled, bool)
    assert stagetrace._RecordFunctionFast is torch._C._profiler._RecordFunctionFast


def test_profiler_ranges_mirror_the_records(ocr, route):
    from torch.profiler import ProfilerActivity, profile

    with stagetrace.collect() as stats:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            ocr(synthetic_page())
    names, by_id = {r.name for r in stats.records}, _by_id(stats.records)
    ranges = [e for e in prof.events() if e.name in names]
    assert Counter(e.name for e in ranges) == _names(stats.records)

    def ranged_parent(e):
        p = e.cpu_parent
        while p is not None and p.name not in names:
            p = p.cpu_parent
        return p.name if p is not None else None

    assert Counter((e.name, ranged_parent(e)) for e in ranges) == Counter(
        (r.name, by_id[r.parent].name if r.parent else None) for r in stats.records)


def test_profiler_of_every_thread_holds_a_client_threads_ranges(ocr, route):
    """A profiler of every thread started on this thread (as the
    benchmark's traced stretch starts one) holds the ranges of a page run
    on another."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU],
                   experimental_config=torch.profiler._ExperimentalConfig(
                       profile_all_threads=True))
    with stagetrace.collect() as stats:
        prof.start()
        try:
            client = threading.Thread(target=ocr, args=(synthetic_page(),))
            client.start()
            client.join()
        finally:
            prof.stop()
    names = {r.name for r in stats.records}
    ranges = Counter(e.name() for e in prof.profiler.kineto_results.events()
                     if e.name() in names)
    assert ranges == _names(stats.records)


def test_profiler_off_enters_no_range(ocr, route, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range entered with the profiler off")

    monkeypatch.setattr(stagetrace, "_profiler_range", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with stagetrace.collect() as stats:
        ocr(synthetic_page())
    assert stats.counts[("page", "call")] == 1


def test_count_adds_no_seconds():
    with stagetrace.collect() as stats:
        stagetrace.count("d2h", "copies", 3, 12)
        stagetrace.count("d2h", "copies")
    assert stats.counts[("d2h", "copies")] == 4 and stats.bytes[("d2h", "copies")] == 12
    assert ("d2h", "copies") not in stats.seconds and stats.records == []
    stagetrace.count("d2h", "copies")  # no collector: nothing, no error


def test_segments_nest_and_pages_draw_fresh_ids():
    with stagetrace.collect() as stats:
        with stagetrace.page() as a, stagetrace.segment("x", "outer"):
            with stagetrace.segment("x", "inner", nbytes=5):
                pass
        with stagetrace.page() as b:
            with stagetrace.segment("x", "outer"):
                pass
        with stagetrace.segment("x", "loose"):
            pass
    inner, outer_a, outer_b, loose = stats.records
    assert (inner.name, inner.parent, inner.page) == ("x/inner", outer_a.id, a)
    assert (outer_a.parent, outer_a.page, outer_b.page, loose.page) == (None, a, b, None)
    assert b > a
    assert stats.bytes[("x", "inner")] == 5 and stats.counts[("x", "outer")] == 2
    assert stats.seconds[("x", "outer")] >= (outer_a.end_ns - outer_a.start_ns) * 1e-9
