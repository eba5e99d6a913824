"""Per-stage accounting of host work, device syncs and transfers (the
port's copy of yomitoku_tpu/utils/stagetrace.py).

The task modules wrap their host work, sync points and host<->device
transfers in ``segment(stage, kind, nbytes=...)``.  Without an active
collector a segment is a no-op guard; ``collect()`` installs a
process-wide one for its duration and yields the accumulated stats.
"""

import threading
import time
from collections import defaultdict
from contextlib import contextmanager

_active = None
_lock = threading.Lock()


class StageStats:
    """Accumulated per-(stage, kind) wall seconds / bytes / counts."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.bytes = defaultdict(int)
        self.counts = defaultdict(int)

    def add(self, stage, kind, dt, nbytes):
        key = (stage, kind)
        with _lock:
            self.seconds[key] += dt
            self.bytes[key] += nbytes
            self.counts[key] += 1


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
def segment(stage, kind, nbytes=0):
    """Attribute the enclosed wall time (and transferred bytes) to
    (stage, kind).  Free when no collector is active."""
    stats = _active
    if stats is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stats.add(stage, kind, time.perf_counter() - t0, nbytes)
