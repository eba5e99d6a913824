#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``yomitoku_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. Card: name and power limit (nvidia-smi), and the kernel build time
   (the CUDA sources under yomitoku_tpu_torch/csrc compile here).
2. Kernels: each of the four kernels at the recognizer's shapes against its
   plain PyTorch version on the same CUDA inputs (f32 kernel vs f32
   reference at max|d| <= 1e-4 max|ref| + 1e-5 with TF32 off; bf16 kernel
   vs f32 reference at max|d| <= 2e-2 max|ref|; for the two residual
   sublayers also against the scale of their own delta ref - x), with the
   weights as the models pass them (torch Linear weights ``.t()``) and as
   row-major (in, out) tensors, then the median time of the kernel and of
   the plain version over 10 runs after warm-up.
3. The slice: ``OCR(device="cuda")`` (DBNet dbnetv2_1 + PARSeq
   parseq-large-v4_1, seed-0 random weights) on demo/sample_text.png, its
   recognizer on a synthetic page of 128+ lines (a full batch of 128), the
   four launch counters of that run, and two 16-line f32 recognizer runs
   on the card (the first captures the AR step's CUDA graph, the second
   replays it) against the same weights on the CPU (plain path).

Then one JSON line with the kernels, and the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Long outputs (the nvcc log, the OCR schema) go to build/chip_smoke/.
"""

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"

#: (kernel, route, main source, other sources, TPU kernel it replaces)
KERNELS = [
    ("fused_attention_block_ln", "cuda",
     "yomitoku_tpu_torch/csrc/attention.cu",
     ["yomitoku_tpu_torch/csrc/gemm.cu"],
     "yomitoku_tpu/ops/pallas/flash_attention.py:322"),
    ("fused_mlp_ln", "cuda", "yomitoku_tpu_torch/csrc/gemm.cu", [],
     "yomitoku_tpu/ops/pallas/fused_mlp.py:156"),
    ("fused_attention_heads", "cuda",
     "yomitoku_tpu_torch/csrc/attention.cu", [],
     "yomitoku_tpu/ops/pallas/flash_attention.py:117"),
    ("fused_mlp", "cuda", "yomitoku_tpu_torch/csrc/gemm.cu", [],
     "yomitoku_tpu/ops/pallas/fused_mlp.py:80"),
]

# Recognizer shapes (parseq-large-v4_1, batch 128, 32x800 canvas)
B, L, D, HEADS, HIDDEN, STEPS = 128, 400, 768, 8, 3072, 101


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------------ phase 1


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed no GPU")
    return out[0].strip()


def phase_card():
    import torch

    from yomitoku_tpu_torch.ops import _build

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {lib.build_seconds:.1f} s) -> {lib.path.name}")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "nvcc.log").write_text(lib.build_log)
    return card


# ------------------------------------------------------------------ phase 2


#: weight layouts held against the plain versions: the models' (their torch
#: Linear weights, row-major (out, in), passed ``.t()``) and row-major
#: (in, out).  The bf16 GEMM has one instantiation for each.
LAYOUTS = ("out_in.t", "in_out")


def _kernel_cases(rng):
    """name -> (plain version, stock bf16 torch ops, inputs): numpy args in
    the (in, out) layout, the indices of the weights among them, and the
    trailing non-tensor args."""
    import torch.nn.functional as F

    from yomitoku_tpu_torch import ops

    def nrm(shape, std=1.0):
        return (rng.standard_normal(shape) * std).astype("float32")

    def vec(n, center=0.0, std=0.02):
        return (center + rng.standard_normal(n) * std).astype("float32")

    ws = D ** -0.5
    block = dict(
        args=[nrm((B, L, D)), vec(D, 1.0, 0.1), vec(D),
              nrm((D, D), ws), vec(D), nrm((D, D), ws), vec(D),
              nrm((D, D), ws), vec(D), nrm((D, D), ws), vec(D)],
        weights={3, 5, 7, 9}, tail=(HEADS,),
    )
    mlp_ln = dict(
        args=[nrm((B * L, D)), vec(D, 1.0, 0.1), vec(D),
              nrm((D, HIDDEN), ws), vec(HIDDEN), nrm((HIDDEN, D),
                                                    HIDDEN ** -0.5), vec(D)],
        weights={3, 5}, tail=(),
    )
    heads = dict(
        args=[nrm((B, STEPS, D)), nrm((B, L, D)), nrm((B, L, D))],
        weights=set(), tail=(HEADS,),
    )
    mlp = dict(
        args=[nrm((B * STEPS, D)), nrm((D, HIDDEN), ws), vec(HIDDEN),
              nrm((HIDDEN, D), HIDDEN ** -0.5), vec(D)],
        weights={1, 3}, tail=(),
    )

    def stock_attn_heads(q, k, v, h):
        b, lq, d = q.shape
        split = lambda t: t.reshape(b, -1, h, d // h).transpose(1, 2)
        o = F.scaled_dot_product_attention(split(q), split(k), split(v))
        return o.transpose(1, 2).reshape(b, lq, d)

    def stock_block(x, g, bn, wq, bq, wk, bk, wv, bv, wo, bo, h):
        y = F.layer_norm(x, (x.shape[-1],), g, bn, 1e-6)
        a = stock_attn_heads(y @ wq + bq, y @ wk + bk, y @ wv + bv, h)
        return x + a @ wo + bo

    def stock_mlp(x, w1, b1, w2, b2):
        return F.gelu(x @ w1 + b1) @ w2 + b2

    def stock_mlp_ln(x, g, bn, w1, b1, w2, b2):
        return x + stock_mlp(F.layer_norm(x, (x.shape[-1],), g, bn, 1e-6),
                             w1, b1, w2, b2)

    return {
        "fused_attention_block_ln": (
            ops.fused_attention_block_ln_reference, stock_block, block),
        "fused_mlp_ln": (ops.fused_mlp_ln_reference, stock_mlp_ln, mlp_ln),
        "fused_attention_heads": (
            ops.fused_attention_heads_reference, stock_attn_heads, heads),
        "fused_mlp": (ops.fused_mlp_reference, stock_mlp, mlp),
    }


def _on_card(case, dtype, layout):
    """The case's inputs on the card; in the "out_in.t" layout each weight
    is the ``.t()`` view of a row-major (out, in) tensor."""
    import torch

    out = []
    for i, a in enumerate(case["args"]):
        t = torch.from_numpy(a).to("cuda", dtype)
        if i in case["weights"] and layout == "out_in.t":
            t = t.t().contiguous().t()
        out.append(t)
    return out


def _kernel_call(name, args, layout):
    """(function, args) of the kernel as the main path calls it.  In the
    models' layout the ViT hands ``fused_attention_block_ln_packed`` its
    packed (3D, D) qkv weight ``.t()``; row-major (in, out) weights go
    through the public ``fused_attention_block_ln``."""
    import torch

    from yomitoku_tpu_torch import ops

    if name == "fused_attention_block_ln" and layout == "out_in.t":
        x, g, bn, wq, bq, wk, bk, wv, bv, wo, bo = args
        w_in = torch.cat([wq.t(), wk.t(), wv.t()])  # (3D, D) row-major
        return ops.fused_attention_block_ln_packed, [
            x, g, bn, w_in.t(), torch.cat([bq, bk, bv]), wo, bo]
    return getattr(ops, name), args


def _held(got, want, x, rel, add, unit):
    """max|got - want| against rel * max|want| + add.  For the residual
    sublayers (x given) also the sublayer's own delta: after the output's
    rounding (``unit`` * |got|) is taken off, |got - want| must stay within
    rel * max|want - x| + add, the scale of what the sublayer adds to x
    rather than of the x it passes through.  -> (max|d|, ok, text)."""
    d = (got.float() - want).abs()
    err = d.max().item()
    limit = rel * want.abs().max().item() + add
    ok = err <= limit
    text = f"max|d| {err:.3e} (limit {limit:.3e})"
    if x is not None:
        excess = (d - unit * got.float().abs()).max().item()
        dlimit = rel * (want - x.float()).abs().max().item() + add
        ok = ok and excess <= dlimit
        text += f", delta {excess:.3e} (limit {dlimit:.3e})"
    return err, ok and math.isfinite(err), text


def median_ms(fn, runs=10, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_kernels():
    import numpy as np
    import torch

    from yomitoku_tpu_torch import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = _kernel_cases(np.random.default_rng(0))
    results = {}
    for name, (ref, stock, case) in cases.items():
        tail = case["tail"]
        res = {}
        layouts = LAYOUTS if case["weights"] else LAYOUTS[:1]
        for layout in layouts:
            f32 = _on_card(case, torch.float32, layout)
            bf = _on_card(case, torch.bfloat16, layout)
            x32, xb = (f32[0], bf[0]) if name.endswith("_ln") else (None, None)
            with torch.no_grad():
                kern, args32 = _kernel_call(name, f32, layout)
                err32, ok32, text32 = _held(
                    kern(*args32, *tail), ref(*f32, *tail), x32,
                    1e-4, 1e-5, 2.0 ** -24)
                kern, args16 = _kernel_call(name, bf, layout)
                err16, ok16, text16 = _held(
                    kern(*args16, *tail),
                    ref(*[a.float() for a in bf], *tail), xb, 2e-2, 0.0,
                    2.0 ** -8)
            torch.cuda.synchronize()
            log(f"kernel {name} [{layout}]: f32 {text32} "
                f"{'ok' if ok32 else 'FAIL'}; bf16 {text16} "
                f"{'ok' if ok16 else 'FAIL'}")
            check(ok32 and ok16,
                  f"{name} [{layout}] disagrees with its plain version")
            suffix = "" if layout == LAYOUTS[0] else "_" + layout
            res["max_abs_err" + suffix] = err16
            res["max_abs_err_f32" + suffix] = err32
            if layout == LAYOUTS[0]:  # timed in the main path's layout
                with torch.no_grad():
                    res["ms"] = median_ms(lambda: kern(*args16, *tail))
                    res["plain_ms"] = median_ms(lambda: ref(*bf, *tail))
                    res["stock_ms"] = median_ms(lambda: stock(*bf, *tail))
                log(f"kernel {name}: bf16 {res['ms']:.3f} ms, plain "
                    f"{res['plain_ms']:.3f} ms, stock bf16 torch "
                    f"{res['stock_ms']:.3f} ms (median of 10)")
            del f32, bf, args32, args16, x32, xb
            torch.cuda.empty_cache()
        results[name] = res
    ops.reset_launches()
    return results


# ------------------------------------------------------------------ phase 3


def synthetic_lines_page(n_lines=136, seed=0):
    """A white page of ``n_lines`` printed lines (numpy + cv2) and one quad
    per line: enough for a full recognizer batch of 128 whatever the
    random detector finds."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    alphabet = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"))
    pitch, width = 28, 900
    page = np.full((n_lines * pitch + 16, width, 3), 255, np.uint8)
    quads = []
    for i in range(n_lines):
        text = "".join(rng.choice(alphabet, rng.integers(8, 40)))
        y = 8 + i * pitch
        cv2.putText(page, text, (10, y + 20), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                    (0, 0, 0), 2)
        x1 = min(width - 1, 16 + 17 * len(text))
        quads.append([[6, y], [x1, y], [x1, y + pitch - 2], [6, y + pitch - 2]])
    return page, quads


def host_timed(fn, runs=3):
    """Median host wall time (s) of ``fn`` ending in a device sync."""
    import torch

    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _finite_schema(schema, what):
    import math

    check(all(math.isfinite(s) for s in schema.scores), f"{what}: scores not finite")


def phase_slice(card):
    import cv2
    import numpy as np
    import torch

    from yomitoku_tpu.data.dataset import ParseqDataset
    from yomitoku_tpu_torch import ops
    from yomitoku_tpu_torch.ocr import OCR
    from yomitoku_tpu_torch.text_recognizer import TextRecognizer

    t0 = time.perf_counter()
    ocr = OCR(device="cuda")  # dbnetv2_1 + parseq-large-v4_1, seed-0 weights
    det, rec = ocr.detector.model, ocr.recognizer.model
    log(f"slice: OCR(device='cuda') built in {time.perf_counter() - t0:.1f} s: "
        f"DBNet {det.param_count():,} params, PARSeq {rec.param_count():,} "
        f"params, {rec.dtype}, weights "
        f"{rec.pretrained_source or 'seed-0 random'}")
    sample = cv2.imread(str(ROOT / "demo" / "sample_text.png"))
    check(sample is not None, "demo/sample_text.png missing")
    lines_page, quads = synthetic_lines_page()

    # the main path, counted: OCR on the sample page, then the recognizer on
    # the synthetic page (one full batch of 128 + a bucket-8 remainder)
    ops.reset_launches()
    result = ocr(sample)
    lines = ocr.recognizer(lines_page, quads)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    log(f"slice: launches {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path was never launched: {launches}")
    check(len(result.words) > 0, "OCR schema holds no words")
    for w in result.words:
        check(np.isfinite([w.det_score, w.rec_score]).all(), "OCR score not finite")
    _finite_schema(lines, "recognizer")
    check(len(lines.contents) == len(quads),
          f"recognizer returned {len(lines.contents)} of {len(quads)} lines")
    log(f"slice: OCR on sample_text.png {sample.shape[1]}x{sample.shape[0]}: "
        f"{len(result.words)} words; recognizer on the synthetic page: "
        f"{len(lines.contents)} lines, first {lines.contents[0][:20]!r}")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "ocr_sample.json").write_text(result.model_dump_json(indent=1))

    # throughput (reported, not gated)
    page_s = host_timed(lambda: ocr(sample))
    det_s = host_timed(lambda: ocr.detector(sample))
    rec_s = host_timed(lambda: ocr.recognizer(lines_page, quads[:128]))
    def crop():
        return ParseqDataset(ocr.recognizer._cfg, lines_page, quads[:128]).as_u8_array()

    crop_s = host_timed(crop)
    crops = crop()
    rec._ar_loops.clear()  # the next call builds the batch-128 AR state anew
    first_s = host_timed(lambda: rec.forward_tokens(crops), runs=1)
    model_s = host_timed(lambda: rec.forward_tokens(crops))
    log(f"slice: OCR {page_s * 1e3:.1f} ms/page (detector {det_s * 1e3:.1f} ms) "
        f"on sample_text.png; recognizer bf16 batch 128: {128 / rec_s:.1f} "
        f"lines/s end to end ({rec_s * 1e3:.1f} ms, of which host crops "
        f"{crop_s * 1e3:.1f} ms), {128 / model_s:.1f} lines/s device decode "
        f"({model_s * 1e3:.1f} ms/batch; the first batch of a size, which "
        f"captures the AR step's CUDA graph, {first_s * 1e3:.1f} ms); "
        f"median of 3; card {card}")

    # f32 on the card against f32 on the CPU (plain path), same seed weights;
    # the first batch runs AR step 0 eagerly and captures the step's CUDA
    # graph, the second replays the graph from step 0 on reset buffers
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec32 = TextRecognizer(device="cuda", dtype=torch.float32, from_pretrained=False)
    cpu32 = TextRecognizer(device="cpu", from_pretrained=False)
    for what, x in (("capture", crops[:16]), ("replay", crops[16:32])):
        x = torch.from_numpy(x)
        n0 = dict(ops.launches)
        got = rec32.model.forward_logits(x).cpu()
        check(all(ops.launches[k] > n0[k] for k in n0),
              f"f32 run missed a kernel: {n0} -> {ops.launches}")
        want = cpu32.model.forward_logits(x)
        check(torch.isfinite(got).all().item(), "f32 card logits not finite")
        top2 = want.topk(2, dim=-1).values
        tie = (top2[..., 0] - top2[..., 1]) < 1e-4
        ids_g, ids_w = got.argmax(-1), want.argmax(-1)
        differ = ids_g != ids_w
        n_ties = int(tie.sum())
        check(not (differ & ~tie).any().item(),
              f"f32 greedy ids differ at {int((differ & ~tie).sum())} positions "
              "with a top-2 gap >= 1e-4")
        p_g = torch.exp(got.gather(-1, ids_w[..., None])[..., 0] - got.logsumexp(-1))
        p_w = torch.exp(want.gather(-1, ids_w[..., None])[..., 0] - want.logsumexp(-1))
        dp = (p_g - p_w).abs().max().item()
        check(dp <= 1e-3, f"f32 probs differ by {dp:.3e} > 1e-3")
        log(f"slice: f32 card vs CPU on 16 lines ({what}): ids equal at "
            f"{int((~differ).sum())}/{differ.numel()} positions, {n_ties} "
            f"near-tie positions (top-2 gap < 1e-4) exempt, "
            f"{int(differ.sum())} differ; max|d prob| {dp:.3e}; max|d logit| "
            f"{(got - want).abs().max().item():.3e}")
    return launches


# ------------------------------------------------------------------ main


def main():
    try:
        import torch
    except ImportError:
        log("FAIL: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false: no GPU to run on")
        return 1
    if not (ROOT / "yomitoku_tpu_torch" / "csrc").is_dir():
        log(f"FAIL: {ROOT} holds no yomitoku_tpu_torch checkout")
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        card = phase_card()
        kernels = phase_kernels()
        launches = phase_slice(card)
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        return 1
    log(card)  # as nvidia-smi prints it: name, power limit
    rows = []
    for name, route, src, more, replaces in KERNELS:
        rows.append(dict(
            name=name, route=route, source=src, sources=[src] + more,
            replaces=replaces, launches=launches[name], **kernels[name],
        ))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
