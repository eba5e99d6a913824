"""Transformer-MLP kernels of the port (replacing
``yomitoku_tpu/ops/pallas/fused_mlp.py``).

* ``fused_mlp``: fc2(gelu_erf(fc1(x))).
* ``fused_mlp_ln``: the pre-LN sublayer x + fc2(gelu_erf(fc1(LN(x)))).
* ``fused_mlp_ln_int8``: the same sublayer with W8A8 products (see below),
  with ``quantize_weight_int8`` for its weights.

Each is two launches of the GEMM kernel (csrc/gemm.cu): fc1 with the
exact-erf GELU in its epilogue (and the LayerNorm in its prologue for
``fused_mlp_ln``), then fc2 with its bias (and the residual) in the
epilogue.  The Pallas kernels kept the hidden activation in VMEM, chunked
over the hidden axis with an f32 accumulator; here it makes one round trip
through device memory in the input dtype, where the Pallas kernels also
rounded it before fc2.  GELU is erff, where the Pallas kernels use the
A&S 7.1.26 rational erf (|err| <= 1.5e-7): equal at f32 tolerance, not
bitwise.

``fused_mlp_ln_int8`` is four launches (csrc/gemm_int8.cu): the
row-quantize kernel with the LayerNorm prologue (int8 codes of LN(x) and
one f32 scale per row), the int8 GEMM for fc1 with the exact-erf GELU in
its epilogue, written in f32, the row-quantize kernel over each hidden
chunk of that, and the int8 GEMM for fc2, which folds each chunk's int32
sum into f32 with the chunk's row scale and adds the bias and the
residual.  Semantics of the Pallas kernel: activations quantize per row
(``s = max(max|a|, 1e-6) / 127``, ``q = clip(round(a / s), -127, 127)``,
round half to even), weights per output channel (``max(max|w|, 1e-8) /
127``); int32 products dequantize as ``i32 * s_row * s_col + bias`` in
f32; the LayerNorm output is quantized in f32, unrounded; the GELU output
quantizes per row and per hidden chunk of ``hidden_chunk(H)`` columns
(1024 at H=3072), so fc2 is one int32 partial sum per chunk, each folded
into the f32 accumulator with its own row scale.

Weights are in the JAX (in, out) layout; int8 weights as the transpose of
a row-major (out, in) tensor, as ``quantize_weight_int8`` returns them.
On CPU tensors each function runs its plain ``*_reference`` version; on
CUDA tensors it launches the kernels or raises.
"""

import torch
import torch.nn.functional as F

from ._common import (
    gemm,
    gemm_int8,
    launches,
    layer_norm,
    on_cpu,
    quantize_rows,
    require_cuda,
    vector,
)


def _mlp_reference(xn, w1, b1, w2, b2, dt):
    h = torch.matmul(xn.float(), w1.float()) + b1.float()
    g = F.gelu(h, approximate="none").to(dt)
    return torch.matmul(g.float(), w2.float()) + b2.float()


def fused_mlp_reference(x, w1, b1, w2, b2):
    """Plain PyTorch version of ``fused_mlp``."""
    return _mlp_reference(x, w1, b1, w2, b2, x.dtype).to(x.dtype)


def fused_mlp_ln_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=1e-6):
    """Plain PyTorch version of ``fused_mlp_ln``."""
    xn = layer_norm(x, ln_scale, ln_bias, eps, x.dtype)
    out = _mlp_reference(xn, w1, b1, w2, b2, x.dtype)
    return (x.float() + out).to(x.dtype)


def _launch_mlp(name, x, w1, b1, w2, b2, ln=None):
    """``ln`` = (scale, bias, eps) adds the LayerNorm prologue and the
    residual."""
    require_cuda(name, x, w1, w2)
    N, D = x.shape
    Hd, Do = w1.shape[1], w2.shape[1]
    if w1.shape[0] != D or w2.shape[0] != Hd:
        raise ValueError(f"{name}: w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if ln is not None:
        if Do != D:
            raise ValueError(f"{name}: residual needs out dim {Do} == {D}")
        ln = (vector(ln[0], D, x, name), vector(ln[1], D, x, name), ln[2])
    h = torch.empty((N, Hd), dtype=x.dtype, device=x.device)
    gemm(x, w1, vector(b1, Hd, x, name), h, ln=ln, gelu=True)
    out = torch.empty((N, Do), dtype=x.dtype, device=x.device)
    gemm(h, w2, vector(b2, Do, x, name), out,
         res=x if ln is not None else None)
    launches[name] += 1
    return out


def fused_mlp(x, w1, b1, w2, b2):
    """x (N, D); w1 (D, H); w2 (H, Do) -> (N, Do)."""
    if on_cpu(x, w1, b1, w2, b2):
        return fused_mlp_reference(x, w1, b1, w2, b2)
    return _launch_mlp("fused_mlp", x, w1, b1, w2, b2)


def fused_mlp_ln(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=1e-6):
    """x (N, D); ln_scale/ln_bias (D,); w1 (D, H); w2 (H, D) -> (N, D)."""
    if on_cpu(x, ln_scale, ln_bias, w1, b1, w2, b2):
        return fused_mlp_ln_reference(
            x, ln_scale, ln_bias, w1, b1, w2, b2, eps=eps
        )
    return _launch_mlp("fused_mlp_ln", x, w1, b1, w2, b2,
                       ln=(ln_scale, ln_bias, eps))


# ------------------------------------------------------------------ W8A8


def _pick(total, target, align):
    """Largest divisor of ``total`` that is <= target and % align == 0."""
    best = None
    for c in range(align, min(target, total) + 1, align):
        if total % c == 0:
            best = c
    return best


def hidden_chunk(hidden: int) -> int:
    """Columns of the GELU output that share one quantization scale per
    row: the Pallas kernel's hidden-axis block, ``_pick(H, 1024, 128) or
    H``."""
    return _pick(hidden, 1024, 128) or hidden


def quantize_weight_int8(w):
    """(K, N) float -> (int8 codes (K, N), float32 scales (N,)) per output
    channel, as the JAX package's: s = max(max|w[:, n]|, 1e-8) / 127.  The
    codes are the transpose of a row-major (N, K) tensor, the layout the
    int8 GEMM reads."""
    wt = w.t().float()  # (N, K)
    s = torch.clamp_min(wt.abs().amax(1), 1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(wt / s[:, None]), -127, 127).to(torch.int8)
    return q.contiguous().t(), s


def quantize_rows_reference(a, chunk=None):
    """Plain version of the row-quantize kernel: (M, K) float ->
    (int8 codes (M, K), float32 scales (M, K // chunk)), one scale per row
    and chunk of ``chunk`` columns (default: the whole row)."""
    af = a.float()
    M, K = af.shape
    chunk = chunk or K
    g = af.reshape(M, K // chunk, chunk)
    s = torch.clamp_min(g.abs().amax(-1, keepdim=True), 1e-6) * (1.0 / 127.0)
    q = torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)
    return q.reshape(M, K), s[..., 0]


def int_matmul(a, w):
    """Exact int32 product of int8 matrices, as float64 (every partial sum
    of 8-bit products is an integer well inside float64's 53 bits)."""
    return torch.matmul(a.double(), w.double())


def dequantize(i32, s_row, s_col, bias=None):
    """``i32 * s_row * s_col (+ bias)`` in float32, in the Pallas order."""
    out = i32.float() * s_row * s_col.float()
    return out if bias is None else out + bias.float()


def fused_mlp_ln_int8_reference(x, ln_scale, ln_bias, w1q, s1, b1, w2q, s2,
                                b2, eps=1e-6):
    """Plain PyTorch version of ``fused_mlp_ln_int8``."""
    chunk = hidden_chunk(w1q.shape[1])
    xn = layer_norm(x, ln_scale, ln_bias, eps, torch.float32)
    xq, sx = quantize_rows_reference(xn)
    h = dequantize(int_matmul(xq, w1q), sx, s1, b1)
    gq, sg = quantize_rows_reference(F.gelu(h, approximate="none"), chunk)
    acc = torch.zeros(x.shape[0], w2q.shape[1], device=x.device)
    for c in range(sg.shape[1]):
        sl = slice(c * chunk, (c + 1) * chunk)
        acc = acc + dequantize(int_matmul(gq[:, sl], w2q[sl]), sg[:, c:c + 1], s2)
    return (x.float() + acc + b2.float()).to(x.dtype)


def fused_mlp_ln_int8(x, ln_scale, ln_bias, w1q, s1, b1, w2q, s2, b2,
                      eps=1e-6):
    """Pre-LN MLP sublayer, W8A8: x + mlp_int8(LN(x)).  x (N, D); w1q
    (D, H) int8 + s1 (H,); w2q (H, D) int8 + s2 (D,), from
    ``quantize_weight_int8``."""
    args = (x, ln_scale, ln_bias, w1q, s1, b1, w2q, s2, b2)
    if on_cpu(*args):
        return fused_mlp_ln_int8_reference(*args, eps=eps)
    name = "fused_mlp_ln_int8"
    require_cuda(name, x)
    N, D = x.shape
    Hd = w1q.shape[1]
    if w1q.shape != (D, Hd) or w2q.shape != (Hd, D):
        raise ValueError(f"{name}: w1q {tuple(w1q.shape)}, w2q {tuple(w2q.shape)}")
    chunk = hidden_chunk(Hd)
    # the GEMM reads W as rows of (out, in): a copy only for other layouts
    w1q, w2q = w1q.t().contiguous().t(), w2q.t().contiguous().t()
    f32 = lambda v, n: vector(v, n, x, name, torch.float32)  # noqa: E731
    xq = torch.empty((N, D), dtype=torch.int8, device=x.device)
    sx = torch.empty((N, 1), dtype=torch.float32, device=x.device)
    quantize_rows(x, xq, sx, ln=(f32(ln_scale, D), f32(ln_bias, D), eps))
    h = torch.empty((N, Hd), dtype=torch.float32, device=x.device)
    gemm_int8(xq, sx, w1q, f32(s1, Hd), f32(b1, Hd), h, gelu=True)
    gq = torch.empty((N, Hd), dtype=torch.int8, device=x.device)
    sg = torch.empty((N, Hd // chunk), dtype=torch.float32, device=x.device)
    quantize_rows(h, gq, sg)
    out = torch.empty_like(x)
    gemm_int8(gq, sg, w2q, f32(s2, D), f32(b2, D), out, res=x)
    launches[name] += 1
    return out
