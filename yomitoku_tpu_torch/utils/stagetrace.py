"""Per-stage accounting of host work, device syncs and transfers (the
port's copy of yomitoku_tpu/utils/stagetrace.py).

The task modules wrap their host work, sync points and host<->device
transfers in ``segment(stage, kind, nbytes=...)``.  Without an active
collector a segment is a no-op guard; ``collect()`` installs a
process-wide one for its duration and yields the accumulated stats.

With a collector, a segment also keeps a ``Record``: its span on the
host clock (``time.perf_counter_ns``), the id of the segment it opened
inside (per thread), the page id of the ``page()`` it ran in, and its
thread.  While a torch profiler records, each segment is also a profiler
range named ``<stage>/<kind>``, so the device trace holds the same spans
on the profiler's clock, with the kernels launched under them.
``count(stage, kind, n, nbytes)`` adds to a counter (calls and bytes, no
seconds).
"""

import contextvars
import itertools
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_active = None
_lock = threading.Lock()
#: the id of the innermost open segment, and the page id, of the running
#: thread
_open = contextvars.ContextVar("stagetrace_open", default=None)
_page = contextvars.ContextVar("stagetrace_page", default=None)
_page_ids = itertools.count(1)
_record_ids = itertools.count(1)


class Record(NamedTuple):
    """One segment: its ``id``, ``stage`` and ``kind``, ``start_ns`` /
    ``end_ns`` on the host clock, the ``parent`` segment's id (None at the
    top), the ``page`` id (or None) and the ``thread`` ident."""

    id: int
    stage: str
    kind: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    page: Optional[int]
    thread: int

    @property
    def name(self):
        return f"{self.stage}/{self.kind}"


class StageStats:
    """Accumulated per-(stage, kind) wall seconds / bytes / counts, and
    every segment's ``Record`` (``records``), kept as plain tuples, which
    the interpreter's collector stops tracking: a traced run keeps tens of
    thousands."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.bytes = defaultdict(int)
        self.counts = defaultdict(int)
        self._rows = []

    @property
    def records(self):
        """Every segment's ``Record``, in the order they closed."""
        return [Record._make(row) for row in self._rows]

    def add(self, stage, kind, dt, nbytes):
        key = (stage, kind)
        with _lock:
            self.seconds[key] += dt
            self.bytes[key] += nbytes
            self.counts[key] += 1

    def table(self, pages=1):
        """{stage: {kind: {ms, n[, mb]}}} averaged over ``pages``."""
        out = {}
        for (stage, kind), sec in sorted(self.seconds.items()):
            row = out.setdefault(stage, {})
            row[kind] = {
                "ms": round(sec * 1e3 / pages, 1),
                "n": round(self.counts[(stage, kind)] / pages, 1),
            }
            mb = self.bytes[(stage, kind)] / 1e6 / pages
            if mb:
                row[kind]["mb"] = round(mb, 3)
        return out


#: the function-scope profiler range and the profiler's process-wide
#: "recording" flag, both private to torch: resolved here once, and where
#: a torch release lacks either, segments open no profiler range
#: (tests/test_torch_spans.py pins both names)
_RecordFunctionFast = getattr(getattr(torch._C, "_profiler", None),
                              "_RecordFunctionFast", None)
_RANGES = (_RecordFunctionFast is not None
           and isinstance(getattr(_autograd_profiler, "_is_profiler_enabled", None), bool))


def _profiler_range(name):
    """A function-scope profiler range (``record_function`` opens a
    user-scope one).  Its kernels are linked to it in the device trace,
    through the op correlation, and it leaves no annotation on the device
    timeline, where a user range's would span every kernel launched under
    it and read as device work."""
    return _RecordFunctionFast(name)


@contextmanager
def collect():
    """Install a fresh collector for the duration; yields the stats."""
    global _active
    stats = StageStats()
    prev, _active = _active, stats
    try:
        yield stats
    finally:
        _active = prev


@contextmanager
def page():
    """A fresh page id (process-wide counter) for the records this thread
    makes inside; yields it."""
    token = _page.set(next(_page_ids))
    try:
        yield _page.get()
    finally:
        _page.reset(token)


@contextmanager
def segment(stage, kind, nbytes=0):
    """Attribute the enclosed wall time (and transferred bytes) to
    (stage, kind), as a record nested in the enclosing segment.  Free
    when no collector is active."""
    stats = _active
    if stats is None:
        yield
        return
    rid, parent = next(_record_ids), _open.get()
    token = _open.set(rid)
    ranged = None
    # the profiler's process-wide flag (a profiler of every thread leaves
    # the thread-local torch.autograd._profiler_enabled() False)
    if _RANGES and _autograd_profiler._is_profiler_enabled:
        ranged = _profiler_range(f"{stage}/{kind}")
        ranged.__enter__()
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        t1 = time.perf_counter_ns()
        stats.add(stage, kind, (t1 - t0) * 1e-9, nbytes)
        if ranged is not None:
            ranged.__exit__(None, None, None)
        _open.reset(token)
        stats._rows.append((rid, stage, kind, t0, t1, parent, _page.get(),
                            threading.get_ident()))


def count(stage, kind, n=1, nbytes=0):
    """Add ``n`` events and ``nbytes`` bytes to (stage, kind), no seconds."""
    stats = _active
    if stats is not None:
        key = (stage, kind)
        with _lock:
            stats.counts[key] += n
            stats.bytes[key] += nbytes


def note(stage, kind, seconds=0.0, nbytes=0):
    """Record an event measured elsewhere (CUDA events, a profiler)."""
    stats = _active
    if stats is not None:
        stats.add(stage, kind, seconds, nbytes)
