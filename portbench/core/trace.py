"""What a traced run records, and its reduction to per-layer readings.

Spans come from the benchmark's own wrappers around calls into the
program (the detector's and the recognizer's calls per page, a timed lock
in place of the AR loop's lock, ``record_function`` ranges around the two
encoder kernels' entries) and from the program's stage accounting
(``utils/stagetrace.py``), whose segments are also kept as a timeline
here.  ``torch.profiler`` traces a short stretch of the window; the
device's busy time, the kernels' device time under each range and the
host segment at each idle gap come from that stretch alone."""

import bisect
import contextlib
import threading
import time
from collections import defaultdict

import torch


class TimedLock:
    """A lock that sums the seconds its holders waited for it and held it."""

    def __init__(self):
        self.lock, self.mu = threading.Lock(), threading.Lock()
        self.waited = self.held = 0.0
        self._since = {}

    def __enter__(self):
        t0 = time.perf_counter()
        self.lock.acquire()
        t1 = time.perf_counter()
        with self.mu:
            self.waited += t1 - t0
            self._since[threading.get_ident()] = t1
        return self

    def __exit__(self, *exc):
        with self.mu:
            self.held += time.perf_counter() - self._since.pop(threading.get_ident())
        self.lock.release()


def timeline_stats():
    """The program's StageStats, also keeping each segment's (start, end,
    stage, kind) on the host clock."""
    from yomitoku_tpu_torch.utils import stagetrace

    class Timeline(stagetrace.StageStats):
        def __init__(self):
            super().__init__()
            self.spans = []
            self.mu = threading.Lock()

        def add(self, stage, kind, dt, nbytes):
            super().add(stage, kind, dt, nbytes)
            end = time.perf_counter()
            with self.mu:
                self.spans.append((end - dt, end, stage, kind))

    return Timeline()


@contextlib.contextmanager
def stage_collector(stats):
    """``stats`` installed as the program's active stage collector (what
    ``stagetrace.collect`` does with a fresh one)."""
    from yomitoku_tpu_torch.utils import stagetrace

    prev, stagetrace._active = stagetrace._active, stats
    try:
        yield stats
    finally:
        stagetrace._active = prev


class TimedCall:
    """A module of the program with its calls' wall seconds kept in
    ``sink[name]``; every other attribute is the module's."""

    def __init__(self, module, name, sink):
        self.__dict__.update(_module=module, _name=name, _sink=sink)

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self._module(*args, **kwargs)
        finally:
            self._sink[self._name].append(time.perf_counter() - t0)

    def __getattr__(self, attr):
        return getattr(self._module, attr)


class OpRanges:
    """``record_function`` ranges around the encoder kernels' entries of
    the program's attention layer module, each call's logical shape kept
    while ``recording``.  An entry the module no longer has gets no range,
    and its roofline stays silent."""

    def __init__(self):
        self.recording = False
        self.shapes = defaultdict(list)
        self._undo = []

    def install(self):
        from yomitoku_tpu_torch.models.layers import attention

        for name, label, shape in (
            ("fused_attention_block_ln_packed", "attn_block_ln",
             lambda a, kw: tuple(a[0].shape) + (a[7],)),
            ("fused_mlp_ln", "mlp_ln",
             lambda a, kw: tuple(a[0].shape) + (a[3].shape[-1],)),
        ):
            real = getattr(attention, name, None)
            if real is None:
                continue
            setattr(attention, name, self._ranged(real, label, shape))
            self._undo.append((attention, name, real))

    def _ranged(self, real, label, shape):
        def ranged(*args, **kwargs):
            if self.recording:
                self.shapes[label].append(shape(args, kwargs))
            with torch.profiler.record_function(f"portbench.{label}"):
                return real(*args, **kwargs)
        return ranged

    def uninstall(self):
        for module, name, real in self._undo:
            setattr(module, name, real)
        self._undo = []


def profiler():
    """A torch profiler of the CPU (every thread) and the card."""
    from torch.profiler import ProfilerActivity, profile

    kwargs = {}
    try:
        kwargs["experimental_config"] = torch.profiler._ExperimentalConfig(
            profile_all_threads=True)
    except TypeError:
        pass  # an older torch: ranges on other threads may go unrecorded
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kwargs)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_stretch(prof, mark_host_s, spans, labels):
    """One profiled stretch -> dict: ``window_s``, ``busy_s``, per label
    of ``labels`` the device seconds of each ``portbench.<label>`` range
    (its kernels: those linked to the range or to an op inside it on its
    thread), ``device_ops`` and ``idle_gaps`` (the
    breakdown's two lists).  ``mark_host_s`` is the host clock at the
    ``portbench.mark`` range that opens the stretch; ``spans`` the stage
    timeline, named at each gap.  Reads the tracer's raw events."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    marks = sorted(e.start_ns() for e in events if e.name() == "portbench.mark")
    if len(marks) < 2:
        raise RuntimeError("the profiler lost the stretch's marks")
    w0, w1 = marks[0], marks[-1]
    offset_ns = w0 - mark_host_s * 1e9
    kernels, by_name, linked, by_corr = [], defaultdict(float), defaultdict(int), defaultdict(int)
    ranges, cpu_ops = [], defaultdict(list)
    for e in events:
        if e.device_type() == DeviceType.CUDA and not e.name().startswith("portbench."):
            # a range's kernels count whole, also where they ran past the
            # closing mark; busy time is clipped to the stretch
            linked[e.linked_correlation_id()] += e.duration_ns()
            by_corr[e.correlation_id()] += e.duration_ns()
            a, b = max(e.start_ns(), w0), min(e.end_ns(), w1)
            if b > a:
                kernels.append((a, b))
                by_name[e.name()] += (b - a) * 1e-9
            continue
        name = e.name()
        if e.device_type() == DeviceType.CUDA:  # a range's device-side annotation
            continue
        if name.startswith("portbench.") and name[10:] in labels:
            if w0 <= e.start_ns() and e.end_ns() <= w1:
                ranges.append((name[10:], e.start_thread_id(), e.start_ns(), e.end_ns(),
                               e.correlation_id()))
        else:
            # a launch (runtime or driver call) shares the kernel's CUDA
            # correlation id; an op is linked to its kernels by its own id
            launch = name.startswith(("cuda", "cu"))
            cpu_ops[e.start_thread_id()].append((e.start_ns(), e.end_ns(), e.correlation_id(),
                                                 launch))
    by_label = {label: [] for label in labels}
    starts = {}
    for thread, ops in cpu_ops.items():
        ops.sort()
        starts[thread] = [o[0] for o in ops]
    for label, thread, a, b, corr in ranges:
        ops, device_ns = cpu_ops[thread], linked[corr]
        for k in range(bisect.bisect_left(starts.get(thread, []), a), len(ops)):
            s0, s1, c, launch = ops[k]
            if s0 > b:
                break
            if s1 <= b:
                device_ns += by_corr[c] if launch else linked[c]
        by_label[label].append(device_ns * 1e-9)
    busy = _merge(kernels)
    gaps = [(x[1], y[0]) for x, y in zip(busy, busy[1:])]
    if busy:
        gaps = [(w0, busy[0][0])] + gaps + [(busy[-1][1], w1)]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2 - offset_ns
        inside = [(e - s, f"{st}/{k}") for s, e, st, k in spans if s * 1e9 <= mid <= e * 1e9]
        named.append([min(inside)[1] if inside else "no_stage", (b - a) * 1e-9])
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": sum(b - a for a, b in busy) * 1e-9,
        "ranges": by_label,
        "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": named,
    }
