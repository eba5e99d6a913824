"""What the kernel wrappers share: launch counts, the LayerNorm formula,
argument checks and the launchers of the C interface."""

import ctypes
import functools

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
    for counts in (attention_route_launches, gemm_route_launches,
                   gemm_int8_route_launches, conv_route_launches,
                   deform_route_launches):
        for route in counts:
            counts[route] = 0


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
    return all(t.is_cpu for t in tensors)


def require_cuda(name, *tensors):
    """Raise unless every tensor is on one CUDA device in one kernel dtype."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; the kernel needs CUDA")
    dt = tensors[0].dtype
    if dt not in _CODES:
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


#: DTYPE_CODES keyed by torch dtype
_CODES = {getattr(torch, name): code for name, code in DTYPE_CODES.items()}


def _code(t):
    return _CODES[t.dtype]


def _launch(device, fn, *args):
    """fn(*args, stream): a C entry called with ``device``'s current raw
    stream, under a device guard only where ``device`` is not current (the
    guard and the stream object cost more host time than the call)."""
    idx = device.index
    if idx == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))


def _ptr(t):
    return None if t is None else t.data_ptr()


#: Routes of the deformable attention kernel (csrc/deformable_attention.cu
#: ``yt_ms_deformable_attention``): "vector" 16-byte loads, a tap row's
#: channels over the fewest lanes that hold it; "scalar" single-element
#: loads, 32 lanes over the row.
DEFORM_ROUTES = {"vector": 1, "scalar": 2}
#: launches of the deformable attention kernel by route, counted like
#: ``launches``
deform_route_launches = dict.fromkeys(DEFORM_ROUTES, 0)


@functools.lru_cache(maxsize=None)
def deform_route(dtype, c, aligned):
    """The deformable attention kernel's route for ``c`` channels per head
    of ``dtype`` (float32 or bfloat16): "vector" where a tap row is whole
    16-byte pieces (c * itemsize % 16 == 0) and the value's base is 16-byte
    ``aligned``, else "scalar".  Anything else (another dtype, c outside
    1-128) raises: no route takes it."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ms_deformable_attention: dtype {dtype} (kernel takes "
                        "float32, bfloat16)")
    if not 0 < c <= 128:
        raise ValueError(f"ms_deformable_attention: {c} channels per head (1 to 128)")
    itemsize = 4 if dtype == torch.float32 else 2
    return "vector" if aligned and c * itemsize % 16 == 0 else "scalar"


#: Routes of the GEMM kernel (csrc/gemm.cu ``yt_gemm``): "fma" f32 FMAs
#: from shared memory (f32: the parity checks need full f32 products); the
#: bf16 routes, TMA + wgmma: "wgmma" 128 x 128 output units that two
#: consumer warpgroups take in turns; "wgmma_small" 64 x 128 units and one
#: consumer warpgroup, for grids that 128-row units would leave under one
#: wave.
GEMM_ROUTES = {"fma": 0, "wgmma": 1, "wgmma_small": 2}
#: (rows, columns) of a wgmma route's output unit
GEMM_TILES = {"wgmma": (128, 128), "wgmma_small": (64, 128)}
#: launches of the GEMM kernel by route, counted like ``launches``
gemm_route_launches = dict.fromkeys(GEMM_ROUTES, 0)


def gemm_route(dtype, M, N, legal, sms):
    """The GEMM kernel's route for an (M, K) x (K, N) product in ``dtype``
    on a card of ``sms`` SMs.  float32 takes "fma"; bfloat16 with TMA-legal
    operands (``legal``: K, N and row strides % 8, 16-byte aligned bases)
    takes "wgmma" where its 128 x 128 units fill the card, else
    "wgmma_small".  Anything else raises: no route takes it."""
    if dtype == torch.float32:
        return "fma"
    if dtype != torch.bfloat16 or not legal:
        raise ValueError(f"gemm: no route for {dtype} with these strides "
                         "(bf16 needs K, N and row strides % 8 == 0 and "
                         "16-byte aligned operands)")
    if gemm_units("wgmma", M, N) >= sms:
        return "wgmma"
    return "wgmma_small"


def gemm_units(route, M, N, tiles=None):
    """Output units (blocks of work) of an (M, N) product on a wgmma route
    of the bf16 GEMM, or of the int8 one with ``tiles=GEMM_INT8_TILES``."""
    bm, bn = (tiles or GEMM_TILES)[route]
    return -(-M // bm) * -(-N // bn)


def _weight_layout(w, K, N):
    """(w_nk, ldw) of a (K, N) weight: row-major (the JAX (in, out)
    layout), or the transpose of a row-major (N, K) tensor."""
    if w.dim() != 2 or w.shape != (K, N):
        raise ValueError(f"gemm: w {tuple(w.shape)}, expected ({K}, {N})")
    if w.stride(1) == 1 and w.stride(0) >= N:
        return 0, w.stride(0)
    if w.stride(0) == 1 and w.stride(1) >= K:
        return 1, w.stride(1)
    raise ValueError(f"gemm: unsupported weight strides {w.stride()}")


def launch_gemm(route, a, w, bias, out, res=None, ln=None, gelu=False, layout=None):
    """One launch of the GEMM kernel by ``route`` on arguments ``gemm`` has
    checked, with w's ``layout`` = ``_weight_layout(w, K, N)`` where the
    caller has it; the C entry refuses a route not built for them.  Counts
    nothing."""
    M, K = a.shape
    N = out.shape[1]
    nk, ldw = layout or _weight_layout(w, K, N)
    g = b = normed = None
    eps = 0.0
    if ln is not None:
        g, b, eps = ln
        normed = torch.empty((M, K), dtype=a.dtype, device=a.device)  # LN(a)
    lib = library()
    rc = _launch(
        a.device, lib.lib.yt_gemm,
        GEMM_ROUTES[route], _code(a), a.data_ptr(), a.stride(0), w.data_ptr(), ldw, nk,
        _ptr(bias), _ptr(res), 0 if res is None else res.stride(0),
        out.data_ptr(), out.stride(0), M, N, K, _ptr(g), _ptr(b),
        float(eps), int(gelu), _ptr(normed),
    )
    if rc:
        lib.check(rc, f"yt_gemm launch ({route})")


def _gemm_legal(a, w, ldw, out, res=None, bias=None, ln=None):
    """TMA-legal bf16 GEMM operands: K and N multiples of 8 elements, and
    ``_tma_legal`` for one batch: every row stride (w's ``ldw``) a multiple
    of 8 elements (16 bytes), every base, the vectors' too, 16-byte
    aligned."""
    K, N = w.shape
    rows = [(a, a.stride(0)), (w, ldw), (out, out.stride(0)), (res, 0 if res is None else res.stride(0))]
    vecs = [(v, 0) for v in (bias, *(ln or (None, None))[:2])]
    ts = [(t, ld) for t, ld in rows + vecs if t is not None]
    return K % 8 == 0 and N % 8 == 0 and _tma_legal(
        1, [t.data_ptr() for t, _ in ts], [(0, ld) for _, ld in ts])


def gemm(a, w, bias, out, res=None, ln=None, gelu=False):
    """out = epilogue(LN?(a) @ w + bias) on the GEMM kernel (csrc/gemm.cu),
    by the route ``gemm_route`` picks for a's card.  a (M, K) and out, res
    (M, N) with unit column stride; w (K, N) in the JAX (in, out) layout,
    row-major or the transpose of a row-major (N, K) tensor (a torch Linear
    weight ``.t()``); ``ln`` = (scale, bias, eps) first normalises a's rows
    (a LayerNorm pass into a scratch buffer)."""
    M, K = a.shape
    N = out.shape[1]
    if out.shape != (M, N) or (res is not None and res.shape != (M, N)):
        raise ValueError("gemm: output / residual shape mismatch")
    for t in (a, out) + (() if res is None else (res,)):
        if t.stride(1) != 1:
            raise ValueError("gemm: rows must have unit column stride")
    layout = _weight_layout(w, K, N)
    legal = _gemm_legal(a, w, layout[1], out, res, bias, ln)
    route = gemm_route(a.dtype, M, N, legal, _sm_count(a.device.index))
    launch_gemm(route, a, w, bias, out, res, ln, gelu, layout)
    gemm_route_launches[route] += 1


#: Routes of the attention kernel (csrc/attention.cu ``yt_attention``):
#: "fma" f32 FMAs from shared memory (f32, and bf16 head dims the wgmma
#: route is not built for); "wgmma" TMA + wgmma, 128 query rows per block;
#: "wgmma_small" the same kernel with 64 rows per block and the key range
#: split over up to ``_MAX_SPLITS`` blocks plus a combine pass, for grids
#: that 128-row blocks would leave under one wave.
ATTENTION_ROUTES = {"fma": 0, "wgmma": 1, "wgmma_small": 2}
#: head dims the wgmma routes are instantiated for
WGMMA_HEAD_DIMS = (16, 32, 64, 96, 128)
#: launches of the attention kernel by route, counted like ``launches``
attention_route_launches = dict.fromkeys(ATTENTION_ROUTES, 0)
_MAX_SPLITS = 4


def attention_route(dtype, out_dtype, B, H, Lq, Dh, strides_ok, sms):
    """The attention kernel's route for these arguments on a card of
    ``sms`` SMs -> (route, splits).

    bf16 inputs with a head dim in ``WGMMA_HEAD_DIMS`` and TMA-legal
    operands (``strides_ok``: 16-byte aligned bases, batch and row strides
    of a multiple of 8 elements) take a wgmma route: "wgmma" where its
    128-row blocks fill the card, else "wgmma_small" with the key range
    split over at most ``splits`` blocks, enough for the 64-row blocks to
    fill it (the kernel cuts the keys into its own tiles and never leaves a
    split empty).  Everything else takes "fma" (splits 1)."""
    if (dtype != torch.bfloat16 or out_dtype not in (torch.bfloat16, torch.float32)
            or Dh not in WGMMA_HEAD_DIMS or not strides_ok):
        return "fma", 1
    if -(-Lq // 128) * H * B >= sms:
        return "wgmma", 1
    return "wgmma_small", min(_MAX_SPLITS, -(-sms // (-(-Lq // 64) * H * B)))


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tma_legal(batch, ptrs, strides):
    """16-byte aligned bases and batch / row strides of 8 elements (16 bytes
    of bf16) for tensors with these data pointers and strides; the batch
    stride counts only where there is more than one."""
    return all(p % 16 == 0 and s[1] % 8 == 0 and (batch == 1 or (s[0] % 8 == 0 and s[0] > 0))
               for p, s in zip(ptrs, strides))


def launch_attention(route, splits, q, k, v, out, num_heads, scale):
    """One launch of the attention kernel by ``route`` with at most
    ``splits`` key splits, on arguments ``attention`` has checked; the C
    entry refuses a route not built for them.  Counts nothing."""
    B, Lq, D = q.shape
    dh = D // num_heads
    (qs, ks, vs, os_) = [t.stride() for t in (q, k, v, out)]
    part = None
    if splits > 1:  # room for the splits' partial outputs and (max, sum) pairs
        part = torch.empty(splits * B * num_heads * Lq * (dh + 2),
                           dtype=torch.float32, device=q.device)
    lib = library()
    rc = _launch(
        q.device, lib.lib.yt_attention,
        ATTENTION_ROUTES[route], splits, _code(q), _code(out),
        q.data_ptr(), qs[0], qs[1], k.data_ptr(), ks[0], ks[1], v.data_ptr(), vs[0], vs[1],
        out.data_ptr(), os_[0], os_[1], _ptr(part),
        B, num_heads, Lq, k.shape[1], dh, float(scale),
    )
    if rc:
        lib.check(rc, f"yt_attention launch ({route}, {splits} splits)")


def attention(q, k, v, out, num_heads, scale):
    """out = softmax(q k^T * scale) v per head on the attention kernel
    (csrc/attention.cu), by the route ``attention_route`` picks for q's
    card.  q, out (B, Lq, H*Dh), k, v (B, Lk, H*Dh), each with unit stride
    along the last axis and any batch / row strides; out of q's dtype, or
    float32 for bfloat16 q, k, v."""
    B, Lq, D = q.shape
    Lk = k.shape[1]
    if k.shape != (B, Lk, D) or v.shape != (B, Lk, D) or out.shape != q.shape:
        raise ValueError("attention: q/k/v/out shapes disagree")
    if D % num_heads:
        raise ValueError(f"attention: D={D} not divisible by {num_heads}")
    dh = D // num_heads
    if dh > 128:
        raise ValueError(f"attention: head dim {dh} > 128")
    if any(t.stride(2) != 1 for t in (q, k, v, out)):
        raise ValueError("attention: last axis must have unit stride")
    if out.dtype not in (q.dtype, torch.float32):
        raise TypeError(f"attention: {out.dtype} output for {q.dtype} inputs")
    tensors = (q, k, v, out)
    legal = _tma_legal(B, [t.data_ptr() for t in tensors], [t.stride() for t in tensors])
    route, splits = attention_route(q.dtype, out.dtype, B, num_heads, Lq, dh, legal,
                                    _sm_count(q.device.index))
    launch_attention(route, splits, q, k, v, out, num_heads, scale)
    attention_route_launches[route] += 1


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
    rc = _launch(
        x.device, lib.lib.yt_quantize_rows,
        _code(x), x.data_ptr(), x.stride(0), _ptr(g), _ptr(b), float(eps),
        q.data_ptr(), s.data_ptr(), M, K, K // nc,
    )
    if rc:
        lib.check(rc, "yt_quantize_rows launch")


#: Routes of the int8 GEMM kernel (csrc/gemm_int8.cu ``yt_gemm_int8``),
#: all TMA + int8 wgmma with two consumer warpgroups: "wgmma" 128 x 128
#: output units that they take in turns, K in one chunk; "wgmma_coop" 128 x
#: 128 units that they share, 64 rows each, for K-chunked products (the f32
#: fold of the finished chunks sits in registers beside the int32 sums) and
#: GELU epilogues; "wgmma_m64" 64 x 128 units taken in turns, any K-chunks,
#: for grids that 128-row units would leave under one wave.
GEMM_INT8_ROUTES = {"wgmma": 1, "wgmma_m64": 2, "wgmma_coop": 3}
#: (rows, columns) of an int8 route's output unit
GEMM_INT8_TILES = {"wgmma": (128, 128), "wgmma_m64": (64, 128), "wgmma_coop": (128, 128)}
#: launches of the int8 GEMM kernel by route, counted like ``launches``
gemm_int8_route_launches = dict.fromkeys(GEMM_INT8_ROUTES, 0)
#: k per stage of the int8 GEMM: K-chunks are whole multiples of it
INT8_BK = 128


def gemm_int8_route(M, N, nchunks, gelu, legal, sms):
    """The int8 GEMM kernel's route for an (M, K) x (K, N) product in
    ``nchunks`` K-chunks on a card of ``sms`` SMs.  TMA-legal operands
    (``legal``, ``_gemm_int8_legal``) take 128 x 128 units where they fill
    the card: "wgmma_coop" for a chunked K, and for a GELU epilogue (its
    erff, ~50 instructions a value, outlasts the products: both
    warpgroups run it at once), else "wgmma"; where they do not fill it,
    "wgmma_m64".  Anything else raises: no route takes it."""
    if not legal:
        raise ValueError("gemm_int8: no route for these operands (K % 16, N % 8, "
                         "K-chunks of K or a multiple of 128, 16-byte aligned "
                         "operands and vectors, row strides of 16-byte multiples)")
    if gemm_units("wgmma", M, N, GEMM_INT8_TILES) < sms:
        return "wgmma_m64"
    return "wgmma_coop" if nchunks > 1 or gelu else "wgmma"


def _gemm_int8_legal(a, w, out, sw, bias=None, res=None, kchunk=None):
    """TMA-legal int8 GEMM operands: K % 16, N % 8, K-chunks of K or a
    multiple of ``INT8_BK``; a, w, out, res, sw and bias on 16-byte
    aligned bases; every row stride (w's: its (N, K) rows) a 16-byte
    multiple."""
    K, N = w.shape
    kchunk = kchunk or K
    rows = [a.stride(0), w.stride(1), out.stride(0) * out.element_size()]
    if res is not None:
        rows.append(res.stride(0) * res.element_size())
    bases = [t for t in (a, w, out, sw, bias, res) if t is not None]
    return (K % 16 == 0 and N % 8 == 0 and K % kchunk == 0
            and (kchunk == K or kchunk % INT8_BK == 0)
            and all(r % 16 == 0 for r in rows) and all(_aligned(t, 16) for t in bases))


def launch_gemm_int8(route, a, sa, w, sw, bias, out, res=None, gelu=False):
    """One launch of the int8 GEMM kernel by ``route`` on arguments
    ``gemm_int8`` has checked; the C entry refuses a route not built for
    them.  Counts nothing."""
    M, K = a.shape
    N = out.shape[1]
    lib = library()
    rc = _launch(
        a.device, lib.lib.yt_gemm_int8,
        GEMM_INT8_ROUTES[route], a.data_ptr(), a.stride(0), w.data_ptr(), w.stride(1),
        sa.data_ptr(), sw.data_ptr(), _ptr(bias), _ptr(res),
        0 if res is None else res.stride(0), out.data_ptr(), out.stride(0),
        _code(out), M, N, K, K // sa.shape[1], int(gelu),
    )
    if rc:
        lib.check(rc, f"yt_gemm_int8 launch ({route})")


def gemm_int8(a, sa, w, sw, bias, out, res=None, gelu=False):
    """out = epilogue(sum over K-chunks c of (a_c @ w_c)_int32 * sa[:, c] *
    sw + bias) on the int8 GEMM kernel (csrc/gemm_int8.cu), by the route
    ``gemm_int8_route`` picks for a's card: a (M, K) int8 rows; sa (M,
    nchunks), sw (N,) and bias (N,) float32; w (K, N) int8 as the transpose
    of a row-major (N, K) tensor; out and res (M, N) of one dtype (float32
    or bfloat16); the epilogue adds bias, then erf-GELU, then res."""
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
    if out.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gemm_int8: output dtype {out.dtype} (float32 or bfloat16)")
    if res is not None and (res.shape != out.shape or res.dtype != out.dtype):
        raise ValueError("gemm_int8: residual must match the output")
    for t in (a, out) + (() if res is None else (res,)):
        if t.stride(1) != 1:
            raise ValueError("gemm_int8: rows must have unit column stride")
    legal = _gemm_int8_legal(a, w, out, sw, bias, res, K // nc)
    route = gemm_int8_route(M, N, nc, gelu, legal, _sm_count(a.device.index))
    launch_gemm_int8(route, a, sa, w, sw, bias, out, res, gelu)
    gemm_int8_route_launches[route] += 1


#: Routes of the implicit-GEMM convolution kernel (csrc/bottleneck.cu), one
#: per convolution of a bottleneck block: "fma" f32 FMAs from shared memory
#: (f32: the parity checks need full f32 products); the bf16 routes, TMA +
#: wgmma with two consumer warpgroups taking output units (a patch of
#: pixels by 128 channels, or 64 where N <= 64) in turns: "wgmma" 128-pixel
#: units; "wgmma_small" 64-pixel units, for grids that 128-pixel units would
#: leave under one wave; "wgmma_split" 64-pixel units with the K steps split
#: over up to ``_MAX_CONV_SPLITS`` blocks into an f32 workspace and a
#: combine pass, for grids that stay under one wave even so.
CONV_ROUTES = {"fma": 0, "wgmma": 1, "wgmma_small": 2, "wgmma_split": 3}
#: output pixels of a wgmma route's unit
CONV_TILE_ROWS = {"wgmma": 128, "wgmma_small": 64, "wgmma_split": 64}
#: launches of the convolution kernel by route, one per convolution,
#: counted like ``launches``
conv_route_launches = dict.fromkeys(CONV_ROUTES, 0)
#: channels of one K step of the wgmma routes (one 128-byte TMA box row)
CONV_BK = 64
_MAX_CONV_SPLITS = 8
#: the fewest K steps a split of the split route takes
_MIN_SPLIT_STEPS = 4


def conv_tile_cols(N):
    """Output channels of a wgmma unit: 64 where N <= 64 (an instantiation
    of its own, DBNet layer1's and PResNet stage0's Cm), else 128."""
    return 64 if N <= 64 else 128


def conv_units(route, M, N):
    """Output units of a convolution of M pixels and N channels on a wgmma
    route, counting the pixels in whole units as a 1x1 does."""
    return -(-M // CONV_TILE_ROWS[route]) * -(-N // conv_tile_cols(N))


def conv_k_steps(K, taps=1, K2=0):
    """K steps of a convolution: ``taps`` taps of K channels in tiles of
    ``CONV_BK``, then a second segment of K2 (the projection shortcut)."""
    return taps * -(-K // CONV_BK) + -(-K2 // CONV_BK)


def conv_splits(M, N, k_steps, sms):
    """K splits of the split route for a card of ``sms`` SMs: as many as
    its 64-pixel units fit in one wave (a second, partial wave costs more
    than the splits gain), at most ``_MAX_CONV_SPLITS``, each of at least
    ``_MIN_SPLIT_STEPS`` K steps; 1 where that leaves one."""
    fit = sms // conv_units("wgmma_split", M, N)
    return max(1, min(_MAX_CONV_SPLITS, fit, k_steps // _MIN_SPLIT_STEPS))


def conv_route(dtype, M, N, k_steps, legal, sms):
    """The convolution kernel's route for M output pixels, N channels and
    ``k_steps`` K steps on a card of ``sms`` SMs -> (route, splits).
    float32 takes "fma"; bfloat16 with TMA-legal operands (``legal``:
    channel counts % 8, 16-byte aligned tensors) takes "wgmma" where its
    128-pixel units fill at least three quarters of the card (one wave of
    them beat two of 64-pixel units there, DBNet layer3 on the H100), else
    "wgmma_small" where 64-pixel ones fill it, else "wgmma_split" with
    ``conv_splits`` splits (or "wgmma_small" where the K steps allow no
    split).  Anything else raises: no route takes it."""
    if dtype == torch.float32:
        return "fma", 1
    if dtype != torch.bfloat16 or not legal:
        raise ValueError(f"conv: no route for {dtype} with these operands (bf16 needs "
                         "channel counts % 8 == 0 and 16-byte aligned operands)")
    if 4 * conv_units("wgmma", M, N) >= 3 * sms:
        return "wgmma", 1
    if conv_units("wgmma_small", M, N) >= sms:
        return "wgmma_small", 1
    splits = conv_splits(M, N, k_steps, sms)
    return ("wgmma_split", splits) if splits > 1 else ("wgmma_small", 1)


@functools.lru_cache(maxsize=None)
def conv_patch(route, taps, H, W):
    """The patch (bw, bh) of pixels of one output unit on a wgmma route,
    bw bh <= its rows.  A 1x1 reads its pixels as one line: (rows, 1).  The
    3x3 takes the patch with the fewest units on an H x W page (the widest
    among equals): each unit's nine taps are the same box, shifted."""
    rows = CONV_TILE_ROWS[route]
    if taps == 1:
        return rows, 1
    best = None
    for bw in range(1, min(W, rows) + 1):
        bh = min(rows // bw, H)
        key = (-(-H // bh) * -(-W // bw), -bw)
        if best is None or key < best[0]:
            best = (key, bw, bh)
    return best[1], best[2]


def conv_padding(route, taps, B, H, W):
    """The share of a wgmma route's computed rows (units x unit rows) that
    lie off the page."""
    bw, bh = conv_patch(route, taps, H, W)
    rows = CONV_TILE_ROWS[route]
    M = B * H * W
    units = -(-M // rows) if taps == 1 else B * -(-H // bh) * -(-W // bw)
    return 1 - M / (units * rows)


@functools.lru_cache(maxsize=None)
def conv_plan(dtype, B, H, W, K, N, taps, K2, legal, sms):
    """How the kernel runs one convolution of a (B, H, W, K) input to N
    channels with ``taps`` taps (and a second K2-channel segment) ->
    (route, bw, bh, splits), the C interface's plan (bw = bh = 0 on
    "fma")."""
    route, splits = conv_route(dtype, B * H * W, N, conv_k_steps(K, taps, K2), legal, sms)
    if route == "fma":
        return route, 0, 0, 1
    return (route, *conv_patch(route, taps, H, W), splits)


@functools.lru_cache(maxsize=None)
def block_plans(dtype, B, H, W, Cin, Cm, Cout, proj, legal, sms):
    """The plans of a bottleneck block's three convolutions (reduce, 3x3,
    expand with the projection's K segment where ``proj``) -> (plans, the
    C interface's int[12], f32 workspace elements the split routes need)."""
    M = B * H * W
    plans = (conv_plan(dtype, B, H, W, Cin, Cm, 1, 0, legal, sms),
             conv_plan(dtype, B, H, W, Cm, Cm, 9, 0, legal, sms),
             conv_plan(dtype, B, H, W, Cm, Cout, 1, Cin if proj else 0, legal, sms))
    ws = max([plan[3] * M * n for plan, n in zip(plans, (Cm, Cm, Cout)) if plan[3] > 1],
             default=0)
    flat = [CONV_ROUTES[plans[i][0]] if j == 0 else plans[i][j] for i in range(3) for j in range(4)]
    return plans, (ctypes.c_int * 12)(*flat), ws


def conv_legal(tensors, channels):
    """TMA-legal bf16 convolution operands: every channel count % 8 (16-byte
    pixel rows), every tensor on a 16-byte aligned base."""
    return (all(c % 8 == 0 for c in channels)
            and all(t.data_ptr() % 16 == 0 for t in tensors if t is not None))


def conv_workspace(elements, device):
    """The split routes' f32 partials, or None where no plan splits."""
    return torch.empty(elements, dtype=torch.float32, device=device) if elements else None


def launch_conv(route, x, w, bias, out, dilation=1, x2=None, w2=None, bias2=None, res=None,
                splits=1):
    """One launch of the convolution kernel by ``route`` (with ``splits``
    K splits on "wgmma_split"): out = relu(conv(x, w) + bias [+ x2 . w2 +
    bias2] [+ res]) on contiguous NHWC x (B, H, W, K), out and res (B, H,
    W, N), x2 (B, H, W, K2); w (K, N) for a 1x1 or (9, K, N) for the 3x3 at
    ``dilation``; f32 biases.  The C entry refuses a route not built for
    the arguments.  Counts nothing: for measurements and tests."""
    B, H, W, K = x.shape
    N = out.shape[-1]
    if not all(t.is_contiguous() for t in (x, w, out, x2, w2, res) if t is not None):
        raise ValueError("launch_conv: contiguous NHWC tensors and weights")
    taps = 9 if w.dim() == 3 else 1
    bw, bh = (0, 0) if route == "fma" else conv_patch(route, taps, H, W)
    ws = conv_workspace(splits * B * H * W * N if splits > 1 else 0, x.device)
    plan = (ctypes.c_int * 4)(CONV_ROUTES[route], bw, bh, splits)
    lib = library()
    rc = _launch(
        x.device, lib.lib.yt_conv,
        _code(x), plan, x.data_ptr(), taps, w.data_ptr(), bias.data_ptr(), _ptr(x2),
        0 if x2 is None else x2.shape[-1], _ptr(w2), _ptr(bias2), _ptr(res), out.data_ptr(),
        B, H, W, K, N, int(dilation), _ptr(ws),
    )
    if rc:
        lib.check(rc, f"yt_conv launch ({route}, {splits} splits)")
