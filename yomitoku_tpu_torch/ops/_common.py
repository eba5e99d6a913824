"""What the kernel wrappers share: launch counts, the LayerNorm formula,
argument checks and the launchers of the C interface."""

import torch

from ._build import DTYPE_CODES, library

#: Launches per public kernel wrapper.  A wrapper adds one where it
#: launches its kernel on CUDA tensors, and nowhere else: the plain path
#: a CPU tensor takes does not count.
launches = {
    "fused_attention_block_ln": 0,
    "fused_mlp_ln": 0,
    "fused_attention_heads": 0,
    "fused_mlp": 0,
    "ms_deformable_attention": 0,
    "fused_attention_block_ln_int8": 0,
    "fused_mlp_ln_int8": 0,
    "fused_attention": 0,
    "fused_attention_block": 0,
    "fused_bottleneck": 0,
    "fused_identity_stage": 0,
}


def reset_launches():
    for name in launches:
        launches[name] = 0


def layer_norm(x, scale, bias, eps, dtype=None):
    """LayerNorm with the JAX package's semantics
    (yomitoku_tpu/models/layers/attention.py:layer_norm): float32
    statistics with the one-pass variance max(E[x^2] - mean^2, 0), output
    cast to ``dtype`` (default: x's)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp_min((xf * xf).mean(-1, keepdim=True) - mu * mu, 0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype or x.dtype)


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU: the only case in which a
    wrapper runs its plain version."""
    return all(t.device.type == "cpu" for t in tensors)


def require_cuda(name, *tensors):
    """Raise unless every tensor is on one CUDA device in one kernel dtype."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; the kernel needs CUDA")
    dt = tensors[0].dtype
    if str(dt).split(".")[-1] not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dt} (kernel takes float32, bfloat16)")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dt}")


def vector(v, n, like, name, dtype=None):
    """A (n,) parameter vector as a contiguous tensor of ``dtype`` (default
    ``like``'s), on ``like``'s device (where it must already lie)."""
    if v.shape != (n,):
        raise ValueError(f"{name}: expected shape ({n},), got {tuple(v.shape)}")
    if v.device != like.device:
        raise ValueError(f"{name}: parameter vector on {v.device}, x on {like.device}")
    return v.to(dtype or like.dtype).contiguous()


def _code(t):
    return DTYPE_CODES[str(t.dtype).split(".")[-1]]


def _ptr(t):
    return None if t is None else t.data_ptr()


def gemm(a, w, bias, out, res=None, ln=None, gelu=False):
    """out = epilogue(LN?(a) @ w + bias) on the GEMM kernel (csrc/gemm.cu).
    a (M, K) and out, res (M, N) with unit column stride; w (K, N) in the
    JAX (in, out) layout, row-major or the transpose of a row-major (N, K)
    tensor (a torch Linear weight ``.t()``); ``ln`` = (scale, bias, eps)
    first normalises a's rows (a LayerNorm pass into a scratch buffer)."""
    M, K = a.shape
    if w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"gemm: a {tuple(a.shape)} vs w {tuple(w.shape)}")
    N = w.shape[1]
    if out.shape != (M, N) or (res is not None and res.shape != (M, N)):
        raise ValueError("gemm: output / residual shape mismatch")
    for t in (a, out) + (() if res is None else (res,)):
        if t.stride(1) != 1:
            raise ValueError("gemm: rows must have unit column stride")
    if w.stride(1) == 1 and w.stride(0) >= N:
        nk, ldw = 0, w.stride(0)
    elif w.stride(0) == 1 and w.stride(1) >= K:
        nk, ldw = 1, w.stride(1)
    else:
        raise ValueError(f"gemm: unsupported weight strides {w.stride()}")
    g = b = normed = None
    eps = 0.0
    if ln is not None:
        g, b, eps = ln
        normed = torch.empty((M, K), dtype=a.dtype, device=a.device)  # LN(a)
    if a.dtype == torch.bfloat16:
        # the bf16 kernel moves 16-byte vectors of 8 elements
        lds = [a.stride(0), ldw, out.stride(0)] + ([] if res is None else [res.stride(0)])
        if K % 8 or N % 8 or any(s % 8 for s in lds) or any(
            t is not None and t.data_ptr() % 16 for t in (a, w, out, res, bias, g, b)
        ):
            raise ValueError("gemm: bf16 needs K, N and row strides % 8 == 0 "
                             "and 16-byte aligned operands")
    lib = library()
    with torch.cuda.device(a.device):
        rc = lib.lib.yt_gemm(
            _code(a), a.data_ptr(), a.stride(0), w.data_ptr(), ldw, nk,
            _ptr(bias), _ptr(res), 0 if res is None else res.stride(0),
            out.data_ptr(), out.stride(0), M, N, K, _ptr(g), _ptr(b),
            float(eps), int(gelu), _ptr(normed),
            torch.cuda.current_stream().cuda_stream,
        )
    lib.check(rc, "yt_gemm launch")


def attention(q, k, v, out, num_heads, scale):
    """out = softmax(q k^T * scale) v per head on the attention kernel
    (csrc/attention.cu).  q, out (B, Lq, H*Dh), k, v (B, Lk, H*Dh), each
    with unit stride along the last axis and any batch / row strides; out
    of q's dtype, or float32 for bfloat16 q, k, v."""
    B, Lq, D = q.shape
    Lk = k.shape[1]
    if k.shape != (B, Lk, D) or v.shape != (B, Lk, D) or out.shape != q.shape:
        raise ValueError("attention: q/k/v/out shapes disagree")
    if D % num_heads:
        raise ValueError(f"attention: D={D} not divisible by {num_heads}")
    dh = D // num_heads
    if dh > 128:
        raise ValueError(f"attention: head dim {dh} > 128")
    for t in (q, k, v, out):
        if t.stride(2) != 1:
            raise ValueError("attention: last axis must have unit stride")
    if out.dtype not in (q.dtype, torch.float32):
        raise TypeError(f"attention: {out.dtype} output for {q.dtype} inputs")
    lib = library()
    with torch.cuda.device(q.device):
        rc = lib.lib.yt_attention(
            _code(q), _code(out),
            q.data_ptr(), q.stride(0), q.stride(1),
            k.data_ptr(), k.stride(0), k.stride(1),
            v.data_ptr(), v.stride(0), v.stride(1),
            out.data_ptr(), out.stride(0), out.stride(1),
            B, num_heads, Lq, Lk, dh, float(scale),
            torch.cuda.current_stream().cuda_stream,
        )
    lib.check(rc, "yt_attention launch")


def _same_cuda_device(name, first, *tensors):
    if first.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {first.device}; the kernel needs CUDA")
    for t in tensors:
        if t is not None and t.device != first.device:
            raise ValueError(f"{name}: tensors on {t.device} and {first.device}")


def _aligned(t, nbytes):
    return t.data_ptr() % nbytes == 0


def quantize_rows(x, q, s, ln=None):
    """Per-row int8 codes of x, or of LN(x) with ``ln`` = (scale, bias, eps)
    (f32 vectors), on the row-quantize kernel (csrc/gemm_int8.cu): q (M, K)
    int8 and s (M, nchunks) float32, contiguous; each row splits into
    nchunks equal chunks with a scale each."""
    M, K = x.shape
    nc = s.shape[1]
    if q.shape != (M, K) or s.shape != (M, nc) or K % nc or (K // nc) % 4:
        raise ValueError(f"quantize_rows: x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"s {tuple(s.shape)} (chunks of a multiple of 4)")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError("quantize_rows: q int8 and s float32")
    _same_cuda_device("quantize_rows", x, q, s, *(ln or (None, None))[:2])
    if not (q.is_contiguous() and s.is_contiguous()) or x.stride(1) != 1:
        raise ValueError("quantize_rows: q, s contiguous and x rows unit-stride")
    if x.stride(0) % 4 or not _aligned(x, 4 * x.element_size()):
        raise ValueError("quantize_rows: x rows must start on 4-element boundaries")
    g = b = None
    eps = 0.0
    if ln is not None:
        g, b, eps = ln
        if g.dtype != torch.float32 or b.dtype != torch.float32:
            raise TypeError("quantize_rows: LayerNorm vectors must be float32")
    lib = library()
    with torch.cuda.device(x.device):
        rc = lib.lib.yt_quantize_rows(
            _code(x), x.data_ptr(), x.stride(0), _ptr(g), _ptr(b), float(eps),
            q.data_ptr(), s.data_ptr(), M, K, K // nc,
            torch.cuda.current_stream().cuda_stream,
        )
    lib.check(rc, "yt_quantize_rows launch")


def gemm_int8(a, sa, w, sw, bias, out, res=None, gelu=False):
    """out = epilogue(sum over K-chunks c of (a_c @ w_c)_int32 * sa[:, c] *
    sw + bias) on the int8 GEMM kernel (csrc/gemm_int8.cu): a (M, K) int8
    rows; sa (M, nchunks), sw (N,) and bias (N,) float32; w (K, N) int8 as
    the transpose of a row-major (N, K) tensor; out and res (M, N) of one
    dtype (float32 or bfloat16); the epilogue adds bias, then erf-GELU,
    then res."""
    M, K = a.shape
    N = w.shape[1]
    nc = sa.shape[1]
    if w.shape != (K, N) or out.shape != (M, N) or sa.shape != (M, nc) or K % nc:
        raise ValueError(f"gemm_int8: a {tuple(a.shape)}, w {tuple(w.shape)}, "
                         f"sa {tuple(sa.shape)}, out {tuple(out.shape)}")
    if w.stride(0) != 1 or w.stride(1) < K:
        raise ValueError("gemm_int8: w must be the transpose of a row-major "
                         f"(N, K) tensor, got strides {w.stride()}")
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError("gemm_int8: a and w must be int8")
    _same_cuda_device("gemm_int8", out, a, w, sa, sw, bias, res)
    for t in (sa, sw) + (() if bias is None else (bias,)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError("gemm_int8: scales and bias contiguous float32")
    if res is not None and (res.shape != out.shape or res.dtype != out.dtype):
        raise ValueError("gemm_int8: residual must match the output")
    for t in (a, out) + (() if res is None else (res,)):
        if t.stride(1) != 1:
            raise ValueError("gemm_int8: rows must have unit column stride")
    kchunk = K // nc
    if (K % 16 or N % 8 or a.stride(0) % 16 or w.stride(1) % 16
            or out.stride(0) % 2 or (res is not None and res.stride(0) % 2)
            or (kchunk != K and kchunk % 64)
            or not all(_aligned(t, 16) for t in (a, w))):
        raise ValueError("gemm_int8: needs K % 16, N % 8, int8 row strides % 16, "
                         "16-byte aligned int8 operands and K-chunks of K or a "
                         "multiple of 64")
    lib = library()
    with torch.cuda.device(a.device):
        rc = lib.lib.yt_gemm_int8(
            a.data_ptr(), a.stride(0), w.data_ptr(), w.stride(1),
            sa.data_ptr(), sw.data_ptr(), _ptr(bias), _ptr(res),
            0 if res is None else res.stride(0), out.data_ptr(), out.stride(0),
            _code(out), M, N, K, kchunk, int(gelu),
            torch.cuda.current_stream().cuda_stream,
        )
    lib.check(rc, "yt_gemm_int8 launch")
