"""One run of one cell: set-up, the measured window, the traced stretch,
the correctness comparison, the result line.

The program under test is ``yomitoku_tpu_torch.ocr.OCR``: a closed loop
of ``clients`` kept threads, each calling ``OCR.__call__`` on its next
page as soon as its last one returned, over a pool of pages made in
set-up.  The benchmark's wrappers around the program's calls keep what
the comparison needs: the recognizer's final ids of every page, and of
the pages the deep checks sample (drawn from the seed before the
window) the detector's real map (its output is then replaced by the
painted one) and the AR loop's ids."""

import gc
import json
import statistics
import threading
import time
from collections import defaultdict
from pathlib import Path

import torch

from portbench.core import judge, pages, peaks, trace, weights
from portbench.reference import dbnet as ref_dbnet
from portbench.reference import parseq as ref_parseq

ROOT = Path(__file__).resolve().parents[2]
#: whole pages a traced stretch has to hold, and the stretches tried
STRETCH_PAGES, STRETCH_TRIES = 3, 4


class SetupError(RuntimeError):
    pass


def load_cell(workload, root=ROOT):
    """(benchmark, workload entry, configuration, traffic) by name, from
    ``root``'s BENCHMARK.json and the files under ``root/portbench``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = {w["name"]: w for w in bench["workloads"]}[workload]
    entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{wl['traffic']}.json").read_text())
    return bench, wl, config, traffic


class PageRecord:
    """One page's call: its number, pool index, host times, output and the
    program's intermediate results the comparison reads; ``kept`` pages
    (the deep checks' sample) keep the device results too."""

    def __init__(self, number, pool_index, kept=False):
        self.number, self.pool, self.kept = number, pool_index, kept
        self.t0 = self.t1 = None
        self.words = None
        self.error = None
        self.real_map = None  # kept: the detector's own output, on the device
        self.ar = []          # kept: per batch, the AR loop's token ids (device)
        self.steps = []       # traced: per batch, each row's AR steps (device)
        self.final = []       # per batch: the final ids as the host got them


class Program:
    """The OCR under test with the benchmark's wrappers installed."""

    def __init__(self, config, device):
        import os

        from yomitoku_tpu_torch.ocr import OCR

        os.environ["YOMITOKU_TPU_INT8_KV"] = "1" if config["int8_kv"] else "0"
        dtype = getattr(torch, config["dtype"])
        det, rec = config["text_detector"], config["text_recognizer"]
        self.ocr = OCR(configs={
            name: {"model_name": c["model_name"], "path_cfg": c.get("path_cfg"),
                   "from_pretrained": False, "dtype": dtype}
            for name, c in (("text_detector", det), ("text_recognizer", rec))
        }, device=device)
        self.det_model = self.ocr.detector.model
        self.rec_model = self.ocr.recognizer.model
        check_widths(self.ocr, config)
        self.local = threading.local()
        self.maps = None
        self.count_steps = False  # traced runs: each batch's AR steps a row
        self.tamper = None  # tests: a fault planted in the timed path

    def load_weights(self, det_w, rec_w):
        self.det_model.load_state_dict(det_w, strict=True)
        self.rec_model.load_state_dict(rec_w, strict=True)

    def install(self, maps):
        """The wrappers: the painted detector map (``maps`` by pool index,
        pinned on CUDA) after the real forward, and the captures."""
        self.maps = maps
        det, rec = self.det_model, self.rec_model
        wanted = ((det, "forward_from_page"), (rec, "forward_tokens_from_page"),
                  (rec, "_ar_cached"))
        gone = [f"{type(m).__name__}.{name}" for m, name in wanted if not hasattr(m, name)]
        if gone:
            raise SetupError(f"the comparison reads the program's results at {gone}, which the "
                             "program no longer has: the benchmark needs a reader of the new ones")
        from_page, tokens, ar = det.forward_from_page, rec.forward_tokens_from_page, rec._ar_cached

        def painted(page, src_hw, out_hw):
            real = from_page(page, src_hw, out_hw)
            record = self.local.page
            if record.kept:
                record.real_map = real
            painted = self.maps[record.pool]
            if tuple(painted.shape) != tuple(real.shape):
                raise SetupError(f"painted map {tuple(painted.shape)} != {tuple(real.shape)}")
            return painted.to(real.device, non_blocking=True)

        def captured_tokens(*args, **kwargs):
            ids, probs = tokens(*args, **kwargs)
            if self.tamper is not None:
                ids, probs = self.tamper("final", ids, probs)
            self.local.page.final.append(ids)
            return ids, probs

        def captured_ar(*args, **kwargs):
            tgt, logits = ar(*args, **kwargs)
            if self.tamper is not None:
                tgt, logits = self.tamper("ar", tgt, logits)
            record = self.local.page
            if record.kept:
                record.ar.append(tgt)
            if self.count_steps:
                record.steps.append(row_steps(tgt))
            return tgt, logits

        det.forward_from_page = painted
        rec.forward_tokens_from_page = captured_tokens
        rec._ar_cached = captured_ar

    def __call__(self, record, image):
        self.local.page = record
        try:
            result, _ = self.ocr(image)
            record.words = result.words
        except Exception as e:  # a failed page counts against the run
            record.error = f"{type(e).__name__}: {e}"
        finally:
            self.local.page = None


def check_widths(ocr, config):
    """The program's catalog entries hold the configuration's published
    widths, thresholds and sizes."""
    d, r = ocr.detector._cfg, ocr.recognizer._cfg
    det, rec = config["text_detector"], config["text_recognizer"]
    have = {
        "in_channels": list(d.decoder.in_channels), "hidden_dim": d.decoder.hidden_dim,
        "shortest_size": d.data.shortest_size, "limit_size": d.data.limit_size,
        "thresh": d.post_process.thresh, "box_thresh": d.post_process.box_thresh,
        "unclip_ratio": d.post_process.unclip_ratio, "min_size": d.post_process.min_size,
        "max_candidates": d.post_process.max_candidates,
        "img_size": list(r.data.img_size), "patch_size": list(r.encoder.patch_size),
        "embed_dim": r.encoder.embed_dim, "depth": r.encoder.depth,
        "num_heads": r.encoder.num_heads, "mlp_ratio": r.encoder.mlp_ratio,
        "decoder_embed_dim": r.decoder.embed_dim, "decoder_depth": r.decoder.depth,
        "decoder_num_heads": r.decoder.num_heads, "decoder_mlp_ratio": r.decoder.mlp_ratio,
        "num_tokens": r.num_tokens, "max_label_length": r.max_label_length,
        "decode_ar": r.decode_ar, "refine_iters": r.refine_iters,
        "batch_size": r.data.batch_size,
    }
    want = {k: v for k, v in {**det, **rec}.items() if k in have}
    off = {k: (have[k], v) for k, v in want.items() if have[k] != v}
    if off or len(want) != len(have):
        raise SetupError(f"the program's models differ from the configuration: {off}")
    if ocr.recognizer.charset != (ROOT / config["charset"]).read_text(encoding="utf-8"):
        raise SetupError("the program reads another charset than the configuration's")
    if ocr.recognizer.model.int8_kv != config["int8_kv"]:
        raise SetupError("the AR loop's memory K/V is not as the configuration states")


class Clients:
    """``n`` kept threads, each with its own queue of jobs: a page to run
    (warm-up), a window to run until its deadline (pages taken in turn from
    a shared counter), or a traced stretch (client 0)."""

    def __init__(self, n, program, pool):
        self.program, self.pool = program, pool
        self.records = []
        self.mu = threading.Lock()
        self.next = 0
        self.deadline = None
        self.prof, self.mark, self.traced = None, None, []
        self.keep = frozenset()  # page numbers whose device results are kept
        self.failure = None  # what a job raised, raised again by the waiter
        self.jobs = [[] for _ in range(n)]
        self.ready = [threading.Condition() for _ in range(n)]
        self.done = threading.Semaphore(0)
        self.threads = [threading.Thread(target=self._serve, args=(k,), daemon=True)
                        for k in range(n)]
        for t in self.threads:
            t.start()

    def _serve(self, k):
        while True:
            with self.ready[k]:
                while not self.jobs[k]:
                    self.ready[k].wait()
                job = self.jobs[k].pop(0)
            if job is None:
                return
            kind, arg = job
            try:
                if kind == "page":
                    self._page(arg)
                elif kind == "trace":
                    self._trace(*arg)
                else:
                    while True:
                        with self.mu:
                            if time.perf_counter() >= self.deadline:
                                break
                            number = self.next
                            self.next += 1
                        self._page(number)
            except BaseException as e:
                self.failure = e
            finally:
                self.done.release()

    def _joined(self, jobs):
        """Wait for ``jobs`` jobs to end; raise what one of them raised."""
        for _ in range(jobs):
            self.done.acquire()
        if self.failure is not None:
            raise self.failure

    def _page(self, number, sink=None):
        record = PageRecord(number, number % len(self.pool), number in self.keep)
        record.t0 = time.perf_counter()
        self.program(record, self.pool[record.pool].image)
        record.t1 = time.perf_counter()
        with self.mu:
            (self.records if sink is None else sink).append(record)

    def _trace(self, pages, ops):
        """Profile ``pages`` whole pages on this thread (after the window)."""
        self.prof = trace.profiler()
        self.prof.start()
        self.mark = time.perf_counter()
        with torch.profiler.record_function("portbench.mark"):
            pass
        ops.recording = True
        self.traced = []
        for _ in range(pages):
            with self.mu:
                number = self.next
                self.next += 1
            self._page(number, self.traced)
        ops.recording = False
        with torch.profiler.record_function("portbench.mark"):
            pass
        torch.cuda.synchronize()
        self.prof.stop()

    def trace(self, pages, ops):
        """Client 0 profiles ``pages`` whole pages; -> once they are done."""
        self._send(0, ("trace", (pages, ops)))
        self._joined(1)

    def _send(self, k, job):
        with self.ready[k]:
            self.jobs[k].append(job)
            self.ready[k].notify()

    def warm(self, pages_each):
        """Each thread runs ``pages_each`` pages of the pool (its own cuDNN
        plans and the AR loop's graph are made here); -> the fastest warm
        page's seconds."""
        for k in range(len(self.threads)):
            for j in range(pages_each):
                self._send(k, ("page", k + j * len(self.threads)))
        self._joined(pages_each * len(self.threads))
        failed = [r.error for r in self.records if r.error]
        fastest = min(r.t1 - r.t0 for r in self.records)
        self.records.clear()
        if failed:
            raise SetupError(f"a warm-up page failed: {failed[0]}")
        return fastest

    def window(self, seconds):
        """Start every thread's window; -> the window's start on the host
        clock.  ``wait`` returns once each thread has finished its last
        page."""
        self.next = 0
        start = time.perf_counter()
        self.deadline = start + seconds
        for k in range(len(self.threads)):
            self._send(k, ("window", None))
        return start

    def wait(self):
        self._joined(len(self.threads))

    def close(self):
        for k in range(len(self.threads)):
            self._send(k, None)
        for t in self.threads:
            t.join()


def percentile(values, q):
    """The ``q``-th percentile by linear interpolation between order
    statistics (Python's ``statistics.quantiles``, inclusive method)."""
    if len(values) < 2:
        return float(values[0]) if values else float("nan")
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


class Session:
    """The program built once for a cell, and the seeded inputs of a run:
    the weights (made on the device, the same dicts for the program and the
    reference) and the page pool with its painted maps."""

    def __init__(self, config, traffic, device):
        self.config, self.traffic, self.device = config, traffic, device
        self.cuda = torch.device(device).type == "cuda"
        self.program = Program(config, device)
        self.det_w = self.rec_w = self.pool = None

    def seed(self, seed):
        """Load the weights and make the pages of ``seed``; set-up fails where
        the program's postprocessor finds another number of lines on a page
        of the pool than the mix planned."""
        config, program = self.config, self.program
        det_cfg, rec_cfg = config["text_detector"], config["text_recognizer"]
        dtype = getattr(torch, config["dtype"])
        self.det_w = weights.make(ref_dbnet.param_spec(det_cfg), seed, "det", self.device, dtype)
        self.rec_w = weights.make(ref_parseq.param_spec(rec_cfg), seed, "rec", self.device, dtype)
        program.load_weights(self.det_w, self.rec_w)
        self.pool = [pages.make_page(self.traffic, det_cfg, seed, k)
                     for k in range(self.traffic["pool"])]
        maps = []
        for page in self.pool:
            quads, _ = program.ocr.detector.postprocess({"binary": page.map},
                                                        page.image.shape[:2])
            if len(quads) != len(page.lines):
                raise SetupError(f"the postprocessor finds {len(quads)} lines on a page of "
                                 f"{len(page.lines)}")
            m = torch.from_numpy(page.map)
            maps.append(m.pin_memory() if self.cuda else m)
        if program.maps is None:
            program.install(maps)
        program.maps = maps


def run_cell(workload, seed, seconds, traced, t_process, device="cuda", root=ROOT,
             tamper=None, log=print):
    """One run -> (result dict of the last line, [(name, value, limit)]).
    ``t_process`` is the host clock when the process started; ``tamper``
    (tests) plants a fault in the timed path's outputs."""
    bench, wl, config, traffic = load_cell(workload, root)
    session = Session(config, traffic, device)
    session.seed(seed)
    program, pool, cuda = session.program, session.pool, session.cuda
    program.tamper = tamper

    spans = defaultdict(list)
    ops, timeline, lock = None, None, None
    if traced:
        program.ocr.detector = trace.TimedCall(program.ocr.detector, "det", spans)
        program.ocr.recognizer = trace.TimedCall(program.ocr.recognizer, "rec", spans)
        lock = program.rec_model._ar_lock = trace.TimedLock()
        ops = trace.OpRanges()
        ops.install()
        timeline = trace.timeline_stats()
        if cuda:  # the profiler's first start initialises its tracer: not in the window
            warm = trace.profiler()
            warm.start()
            warm.stop()

    clients = Clients(traffic["clients"], program, pool)
    program.count_steps = traced
    try:
        # the deep checks' pages, drawn from the seed among those that half
        # the warm pace completes in the window
        clients.keep = judge.sample_numbers(seed, int(0.5 * seconds / clients.warm(2)))
        if cuda:
            torch.cuda.synchronize()
        spans.clear()
        setup_s = time.perf_counter() - t_process
        readings = None
        if traced:
            lock.waited = lock.held = 0.0
            with trace.stage_collector(timeline):
                start = clients.window(seconds)
                clients.wait()
            window_pages = [r for r in clients.records
                            if r.t1 <= start + seconds and r.error is None]
            readings = Readings(config, pool, window_pages, seconds, spans, timeline, lock)
            readings.stretch = profile_stretch(clients, ops, cuda, log)
        else:
            start = clients.window(seconds)
            clients.wait()
        end = start + seconds
    finally:
        clients.close()
    records = sorted(clients.records, key=lambda r: r.number)
    inside = [r for r in records if r.t1 <= end and r.error is None]
    failed = [r for r in records if r.error is not None]
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    result = {"correct": False, "attempted": len(records), "failed": len(failed),
              "metrics": {}, "device": device_line(cuda, memory_peak)}
    if traced:
        stretch = readings.stretch
        result["metrics"] = read_per_layer(bench, readings, root)
        result["device"].update(busy_s=stretch["busy_s"], window_s=stretch["window_s"])
        result["breakdown"] = {"device_ops": stretch["device_ops"],
                               "idle_gaps": stretch["idle_gaps"]}
    else:
        lat = [(r.t1 - r.t0) * 1e3 for r in inside]
        values = {"pages_per_s": len(inside) / seconds,
                  "page_p90_ms": percentile(lat, 90), "setup_s": setup_s}
        for m in bench["end_to_end"]:
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    log(f"window: {len(inside)} pages in {seconds} s, {len(records)} attempted, "
        f"{len(failed)} failed{': ' + failed[0].error if failed else ''}")

    # the comparison runs once the program's state is gone
    if ops is not None:
        ops.uninstall()
    det_w, rec_w, clients_keep = session.det_w, session.rec_w, clients.keep
    del program, clients, session
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = judge.judge(config, traffic, pool, inside, clients_keep, det_w, rec_w, device)
    result["correct"] = bool(not failed and inside and all(v <= lim for _, v, lim in checks))
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result, checks


def device_line(cuda, memory_peak):
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(memory_peak)}


def profile_stretch(clients, ops, cuda, log=print):
    """Trace STRETCH_PAGES whole pages once the window has closed, on the
    program as the window left it; retried where the trace lost records."""
    if not cuda:
        return {"window_s": 0.0, "busy_s": 0.0, "ranges": {}, "device_ops": [],
                "idle_gaps": [], "shapes": {}}
    problem = None
    for _ in range(STRETCH_TRIES):
        ops.shapes.clear()
        timeline = trace.timeline_stats()
        with trace.stage_collector(timeline):
            clients.trace(STRETCH_PAGES, ops)
        t_stop = time.perf_counter()
        reduced = trace.reduce_stretch(clients.prof, clients.mark, timeline.spans,
                                       ("attn_block_ln", "mlp_ln"))
        problem = stretch_problem(reduced, ops, clients.traced)
        log(f"traced stretch: {len(clients.traced)} pages in {reduced['window_s']:.2f} s, "
            f"reduced in {time.perf_counter() - t_stop:.2f} s: {problem or 'sound'}")
        if problem is None:
            reduced["shapes"] = {k: list(v) for k, v in ops.shapes.items()}
            return reduced
    raise RuntimeError(f"no sound traced stretch in {STRETCH_TRIES} tries: {problem}")


def stretch_problem(reduced, ops, whole):
    """Why the stretch's records cannot be read, or None.  Lost records
    show as fewer ranges than calls made, or as a range with no kernels
    among ranges of one op that have some.  An op the program no longer
    calls leaves no range, and its metric silent."""
    if len(whole) < STRETCH_PAGES or any(r.error for r in whole):
        return f"{sum(r.error is None for r in whole)} sound whole pages traced"
    for label, times in reduced["ranges"].items():
        calls = len(ops.shapes.get(label, []))
        if len(times) != calls:
            return f"{len(times)} {label} ranges recorded for {calls} calls"
        empty = sum(t <= 0.0 for t in times)
        if 0 < empty < len(times):
            return f"{label}: {empty} of {len(times)} ranges lost their kernels"
    if reduced["busy_s"] <= 0.0:
        return "no device time"
    return None


class Readings:
    """What the per-layer metric readers read (``portbench/metrics``)."""

    def __init__(self, config, pool, pages_in, seconds, spans, timeline, lock):
        self.config = config
        self.pages = len(pages_in)
        self.seconds = seconds
        self.spans = {k: list(v) for k, v in spans.items()}
        self.stages = dict(timeline.seconds)
        self.lock = trace.TimedLock()
        self.lock.held, self.lock.waited = lock.held, lock.waited
        det_flops = {}  # DBNet's count per input size, counted once
        self.flops = sum(page_flops(config, pool[r.pool], r, det_flops) for r in pages_in)
        self.stretch = None  # the traced stretch's reduction, set after

    def op_roofline(self, label, cost):
        """100 x the summed bound of the stretch's calls of ``label`` over
        their kernels' device time, or None where none ran."""
        shapes = self.stretch["shapes"].get(label, [])
        device_s = sum(self.stretch["ranges"].get(label, []))
        if not shapes or device_s <= 0:
            return None
        return 100.0 * sum(peaks.bound_s(*cost(*s)) for s in shapes) / device_s


def page_flops(config, page, record, det_flops):
    """What one page's inputs need: DBNet at its input size (that of the
    page's map; ``det_flops`` keeps its count per size), and per real line
    the encoder, the AR steps its batch ran (up to the step after which
    every real line held an EOS, read from the AR ids) and the refine."""
    det, rec = config["text_detector"], config["text_recognizer"]
    hw = tuple(page.map.shape[-2:])
    if hw not in det_flops:
        det_flops[hw] = peaks.dbnet_flops(det, hw)
    total = det_flops[hw]
    n = len(record.words)
    bs = rec["batch_size"]
    for k, steps in enumerate(record.steps):
        lines = min(bs, n - k * bs)
        total += lines * peaks.parseq_line_flops(rec, int(steps[:lines].max()))
    return total


def row_steps(tgt):
    """Each row's AR steps from its ids (B, L), on their device: up to its
    first EOS (id 0) after position 0, else L.  A batch ran the most of its
    real rows' steps."""
    hit = tgt[:, 1:] == 0
    return torch.where(hit.any(1), hit.int().argmax(1) + 1, tgt.shape[1])


def read_per_layer(bench, readings, root=ROOT):
    """Each per-layer metric's reader (portbench/metrics/<name>.py); a
    reader that finds nothing returns None and the metric is left out."""
    import importlib.util

    out = {}
    for m in bench["per_layer"]:
        path = root / "portbench" / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{m['name']}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        value = module.read(readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
