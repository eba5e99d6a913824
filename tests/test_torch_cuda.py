"""The port's CUDA kernels on the card, against their plain PyTorch
versions, and small models in f32 on the card against the CPU.  Every test here needs a GPU and skips without one.  The module
imports neither JAX nor the JAX package's models, so it runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: f32 kernels (TF32 off) within 1e-4 of the largest reference
value plus 1e-5 (summation order only); bf16 inputs against the f32 plain
version of the same bf16 values within 2e-2 of the largest value (the
kernels round intermediates to bf16 where the Pallas kernels do).  The
int8 kernels: codes of the row-quantize kernel equal to the plain
version's up to one step at a rounding tie, on at most 1e-3 of them (its
f32 LayerNorm sums in another order); the int8 GEMM on the same codes
within 1e-5 of the largest value; the W8A8 sublayers in f32 within 1e-4
of the largest value plus 1e-5 on all rows but at most 1% of them (rows
where a code moved by one step at a rounding tie, one quantum of one
input: about 1e-3 of the largest value), which stay within 2e-2."""

import numpy as np
import pytest
import torch

from yomitoku_tpu_torch import ops


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cases(rng, dt, layout, B=3, L=37, Lq=21, D=96, H=4, Hd=200):
    def t(*shape, std=1.0, center=0.0):
        a = (center + rng.standard_normal(shape) * std).astype(np.float32)
        return torch.from_numpy(a).to("cuda", dt)

    def w(i, o, std):
        # (in, out) values; "out_in.t": the .t() view of a row-major
        # (out, in) tensor, as the models pass their torch Linear weights
        a = t(i, o, std=std)
        return a.t().contiguous().t() if layout == "out_in.t" else a

    ws = D ** -0.5
    block = [t(B, L, D), t(D, std=0.1, center=1.0), t(D, std=0.1)]
    for _ in range(4):
        block += [w(D, D, ws), t(D, std=0.05)]
    mlp = [w(D, Hd, ws), t(Hd, std=0.05), w(Hd, D, Hd ** -0.5), t(D, std=0.05)]
    return [
        ("fused_attention_heads", [t(B, Lq, D), t(B, L, D), t(B, L, D), H]),
        ("fused_attention_block_ln", block + [H]),
        ("fused_mlp", [t(B * L, D)] + mlp),
        ("fused_mlp_ln", [t(B * L, D), t(D, std=0.1, center=1.0), t(D, std=0.1)] + mlp),
    ]


def _kernel(name, args, layout):
    """The wrapper and its args as the models call it: in their layout the
    ViT passes the packed (3D, D) qkv weight ``.t()`` to
    ``fused_attention_block_ln_packed``."""
    if name == "fused_attention_block_ln" and layout == "out_in.t":
        x, g, b, wq, bq, wk, bk, wv, bv, wo, bo, h = args
        w_in = torch.cat([wq.t(), wk.t(), wv.t()])
        return ops.fused_attention_block_ln_packed, [
            x, g, b, w_in.t(), torch.cat([bq, bk, bv]), wo, bo, h]
    return getattr(ops, name), args


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["out_in.t", "in_out"])
@pytest.mark.parametrize("heads", [4, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_versions(dtype, heads, layout):
    """Ragged shapes (L=37, Lq=21); head dim 24 (4 heads) takes the
    attention kernel's FMA route, 16 (6 heads) its wgmma route in bf16;
    W as the models pass it (torch Linear weights .t()) and as row-major
    (in, out) tensors: one bf16 GEMM instantiation each.  The residual
    sublayers are also held to the scale of their own delta (ref - x), once
    the output's rounding (unit roundoff times |out|) is taken off."""
    _require_cuda()
    dt = getattr(torch, dtype)
    unit = 2.0 ** -24 if dtype == "float32" else 2.0 ** -8
    rel, add = (1e-4, 1e-5) if dtype == "float32" else (2e-2, 0.0)
    for name, args in _cases(np.random.default_rng(5), dt, layout, H=heads):
        n0 = ops.launches[name]
        fn, kargs = _kernel(name, args, layout)
        got = fn(*kargs).float()
        want = getattr(ops, f"{name}_reference")(
            *[a.float() if isinstance(a, torch.Tensor) else a for a in args]
        )
        torch.cuda.synchronize()
        assert ops.launches[name] == n0 + 1, name
        d = (got - want).abs()
        limit = rel * want.abs().max().item() + add
        assert d.max().item() <= limit, (name, d.max().item(), limit)
        if name.endswith("_ln"):
            excess = (d - unit * got.abs()).max().item()
            dlimit = rel * (want - args[0].float()).abs().max().item() + add
            assert excess <= dlimit, (name, excess, dlimit)


@pytest.mark.cuda
def test_kernels_at_the_narrow_canvas_match_plain_versions():
    """The four OCR kernels in bf16 at the 400-wide width bucket's shapes:
    the ViT's sublayers at (128, 200, 768), 8 heads, hidden 3072, and the
    refine's attention of 101 queries over the 200-token memory, against
    their plain versions (2e-2 of the largest value)."""
    _require_cuda()
    cases = _cases(np.random.default_rng(6), torch.bfloat16, "out_in.t", B=128, L=200,
                   Lq=101, D=768, H=8, Hd=3072)
    for name, args in cases:
        n0 = ops.launches[name]
        fn, kargs = _kernel(name, args, "out_in.t")
        got = fn(*kargs).float()
        want = getattr(ops, f"{name}_reference")(
            *[a.float() if isinstance(a, torch.Tensor) else a for a in args])
        torch.cuda.synchronize()
        assert ops.launches[name] == n0 + 1, name
        limit = 2e-2 * want.abs().max().item()
        assert (got - want).abs().max().item() <= limit, name


@pytest.mark.cuda
def test_small_recognizer_f32_matches_cpu(monkeypatch):
    """A small PARSeq (tests/yaml/rec_small.yaml) in f32 on the card and on
    the CPU from the same seed, two batches: equal greedy ids, probs within
    1e-4.  Both with the full memory-K/V cache (int8 is the card's
    default)."""
    _require_cuda()
    monkeypatch.setenv("YOMITOKU_TPU_INT8_KV", "0")
    from pathlib import Path

    from yomitoku_tpu_torch.text_recognizer import TextRecognizer

    cfg = str(Path(__file__).parent / "yaml" / "rec_small.yaml")
    gpu = TextRecognizer(path_cfg=cfg, device="cuda", dtype=torch.float32,
                         from_pretrained=False).model
    cpu = TextRecognizer(path_cfg=cfg, device="cpu", from_pretrained=False).model
    rng = np.random.default_rng(7)
    ops.reset_launches()
    # the second batch replays the AR step's CUDA graph the first captured
    for _ in range(2):
        x = rng.integers(0, 256, (40, 32, 32, 3), dtype=np.uint8)
        ids_g, p_g = gpu.forward_tokens(x)
        assert ops.launches["fused_attention_block_ln"] > 0
        ids_c, p_c = cpu.forward_tokens(x)
        np.testing.assert_array_equal(ids_g, ids_c)
        np.testing.assert_allclose(p_g, p_c, atol=1e-4)


#: (batch, Lq, heads, c, pyramid, points, value layout): RT-DETR's 640x640
#: pyramid (80, 40, 20) at 8 heads of 32 (the layout decoder's 300 queries,
#: the cell detector's 2500, the table recognizer's batch of 4, uneven points
#: at a ragged Lq and batch 3), every c from 16 to 128 (c = 24: 3 of 4 lanes
#: of a bf16 tap group, 6 of 8 in f32) on a small pyramid, c = 4, 8 and 20
#: (a tap row on one lane; bf16 rows of 8 and 40 bytes take the scalar
#: route), more points than one chunk holds ((16, 12, 8): 36, against 16
#: per chunk at c = 32 in bf16 and 4 at c = 128), a single query, and value
#: passed as a view one element off 16-byte alignment ("offset"), which
#: takes the scalar route.
DETR, SMALL = ((80, 80), (40, 40), (20, 20)), ((12, 16), (6, 8), (3, 4))
DEFORM_CASES = [
    (1, 300, 8, 32, DETR, (4, 4, 4), "contiguous"),
    (1, 2500, 8, 32, DETR, (4, 4, 4), "contiguous"),
    (1, 37, 8, 32, DETR, (4, 2, 1), "contiguous"),
    (4, 300, 8, 32, DETR, (4, 4, 4), "contiguous"),
    (3, 37, 8, 32, DETR, (4, 2, 1), "contiguous"),
    (1, 300, 8, 32, DETR, (4, 4, 4), "offset"),
    *[(2, 45, 4, c, SMALL, (4, 4, 4), layout)
      for c in (16, 24, 32, 64, 128) for layout in ("contiguous", "offset")],
    *[(2, 45, 4, c, SMALL, (4, 4, 4), "contiguous") for c in (4, 8, 20)],
    (2, 50, 4, 32, SMALL, (16, 12, 8), "contiguous"),
    (2, 50, 4, 128, SMALL, (16, 12, 8), "contiguous"),
    (2, 50, 4, 24, SMALL, (16, 12, 8), "offset"),
    (1, 1, 2, 32, SMALL, (4, 4, 4), "contiguous"),
    # the table recognizer's page-route batches (region buckets)
    *[(b, 300, 8, 32, DETR, (4, 4, 4), "contiguous") for b in (2, 8, 16, 64)],
]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,lq,heads,c,shapes,points,layout", DEFORM_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deformable_kernel_matches_plain_version(dtype, batch, lq, heads, c, shapes, points,
                                                 layout):
    """ms_deformable_attention against its plain version, some locations off
    the map (loc * 1.3 - 0.15).  Query 0's locations are all NaN and query
    1's all far off the map (+-1e30, inf): their output rows are exactly 0;
    a scattering of other points is NaN or far off too, held against the
    plain version on locations moved to 10 (off the map: zero weight, where
    NaN would make the plain version's 0 * NaN).  The route the wrapper
    reports, "vector" for whole 16-byte rows on an aligned value, else
    "scalar", and one launch are asserted; two calls agree bit for bit."""
    _require_cuda()
    from yomitoku_tpu_torch.ops._common import deform_route_launches

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(11)
    P = sum(points)
    len_v = sum(h * w for h, w in shapes)
    att = rng.random((batch, lq, heads, P))
    loc = rng.random((batch, lq, heads, P, 2)) * 1.3 - 0.15
    odd = rng.random((batch, lq, heads, P)) < 0.02
    loc[odd] = rng.choice([np.nan, 1e30, -np.inf, 7.0], size=(int(odd.sum()), 2))
    loc[:, 0] = np.nan
    loc[:, 1:2, :, :, 0] = 1e30
    loc[:, 1:2, :, :, 1] = -np.inf
    args = [rng.standard_normal((batch, len_v, heads, c)), loc,
            att / att.sum(-1, keepdims=True)]
    args = [torch.from_numpy(a.astype(np.float32)).to("cuda", dt) for a in args]
    if layout == "offset":
        v = torch.empty(args[0].numel() + 1, dtype=dt, device="cuda")[1:]
        args[0] = v.view(args[0].shape).copy_(args[0])
    route = ("vector" if layout == "contiguous" and c * args[0].element_size() % 16 == 0
             else "scalar")
    n0, r0 = ops.launches["ms_deformable_attention"], deform_route_launches[route]
    got = ops.ms_deformable_attention(*args, shapes, points)
    again = ops.ms_deformable_attention(*args, shapes, points)
    finite = [a.float() for a in args]
    finite[1] = torch.where(torch.isfinite(finite[1]) & (finite[1].abs() < 1e3), finite[1],
                            torch.full_like(finite[1], 10.0))
    want = ops.ms_deformable_attention_reference(*finite, shapes, points)
    torch.cuda.synchronize()
    assert ops.launches["ms_deformable_attention"] == n0 + 2
    assert deform_route_launches[route] == r0 + 2, dict(deform_route_launches)
    assert got.dtype == dt and got.shape == (batch, lq, heads * c)
    assert torch.equal(got, again)
    assert not got[:, :min(lq, 2)].any()
    rel, add = (1e-4, 1e-5) if dtype == "float32" else (2e-2, 0.0)
    limit = rel * want.abs().max().item() + add
    assert (got.float() - want).abs().max().item() <= limit


#: (B, H, Lq, Lk, Dh, layout, input dtype, output dtype, route): the main
#: paths' shapes (RT-DETR's AIFI and decoder at batch 1 and at the table
#: recognizer's 4, and a cross shape; the PARSeq refine; the ViT block's
#: packed QKV slices in bf16 and with the int8 sublayer's f32 output;
#: fused_attention's (B*H, L, Dh) views, Lq > Lk among them), every wgmma
#: head dim, ragged Lq and Lk, a low-variance regime, and the inputs that
#: take the FMA kernel (f32, head dims 24 and 48, a misaligned base).
#: Layouts: "heads" (B, L, H*Dh) tensors, "packed" column slices of one
#: (B, L, 3 H*Dh) buffer, "bhld" (B, H, L, Dh) through fused_attention,
#: "lowvar" logits near 100 that vary by about 1 (exp overflows f32 unless
#: the running max is right), "misaligned" bases 8 bytes off.
ATTENTION_CASES = [
    (1, 8, 400, 400, 32, "heads", "bfloat16", "bfloat16", "wgmma_small"),
    (1, 8, 400, 400, 32, "heads", "float32", "float32", "fma"),
    (1, 8, 300, 300, 32, "heads", "bfloat16", "bfloat16", "wgmma_small"),
    (4, 8, 400, 400, 32, "heads", "bfloat16", "bfloat16", "wgmma_small"),
    (4, 8, 300, 300, 32, "heads", "bfloat16", "bfloat16", "wgmma_small"),
    (4, 8, 300, 300, 32, "heads", "float32", "float32", "fma"),
    (2, 8, 300, 400, 32, "heads", "bfloat16", "bfloat16", "wgmma_small"),
    (2, 8, 300, 400, 32, "heads", "float32", "float32", "fma"),
    (128, 8, 101, 400, 96, "heads", "bfloat16", "bfloat16", "wgmma"),
    (1, 2, 101, 400, 96, "heads", "float32", "float32", "fma"),
    (128, 8, 400, 400, 96, "packed", "bfloat16", "bfloat16", "wgmma"),
    (128, 8, 400, 400, 96, "packed", "bfloat16", "float32", "wgmma"),
    (128, 8, 400, 400, 96, "bhld", "bfloat16", "bfloat16", "wgmma"),
    (1, 2, 1, 8, 16, "heads", "bfloat16", "bfloat16", "wgmma_small"),
    (2, 3, 17, 63, 16, "heads", "bfloat16", "float32", "wgmma_small"),
    (1, 4, 101, 1024, 128, "heads", "bfloat16", "bfloat16", "wgmma_small"),
    (64, 2, 300, 300, 128, "packed", "bfloat16", "float32", "wgmma"),
    (128, 2, 17, 80, 64, "heads", "bfloat16", "bfloat16", "wgmma"),
    (2, 3, 37, 45, 32, "bhld", "bfloat16", "bfloat16", "wgmma_small"),
    (2, 3, 37, 45, 32, "bhld", "float32", "float32", "fma"),
    (1, 8, 300, 300, 32, "bhld", "bfloat16", "bfloat16", "wgmma_small"),
    (1, 8, 300, 300, 32, "bhld", "float32", "float32", "fma"),
    (2, 2, 21, 19, 24, "bhld", "bfloat16", "bfloat16", "fma"),
    (2, 2, 21, 19, 24, "bhld", "float32", "float32", "fma"),
    (1, 2, 101, 400, 96, "bhld", "bfloat16", "bfloat16", "wgmma_small"),
    (1, 2, 101, 400, 96, "bhld", "float32", "float32", "fma"),
    (2, 4, 400, 1024, 64, "lowvar", "bfloat16", "bfloat16", "wgmma_small"),
    (128, 8, 400, 400, 32, "lowvar", "bfloat16", "float32", "wgmma"),
    (2, 4, 37, 45, 24, "heads", "bfloat16", "bfloat16", "fma"),
    (2, 4, 37, 45, 48, "heads", "bfloat16", "bfloat16", "fma"),
    (2, 4, 37, 45, 32, "misaligned", "bfloat16", "bfloat16", "fma"),
    # RT-DETR at the table recognizer's page-route batches (region buckets)
    (2, 8, 400, 400, 32, "heads", "bfloat16", "bfloat16", "wgmma_small"),
    (8, 8, 400, 400, 32, "heads", "bfloat16", "bfloat16", "wgmma"),
    (16, 8, 300, 300, 32, "heads", "bfloat16", "bfloat16", "wgmma"),
    (64, 8, 400, 400, 32, "heads", "bfloat16", "bfloat16", "wgmma"),
    (64, 8, 300, 300, 32, "heads", "bfloat16", "bfloat16", "wgmma"),
    # the recognizer's 400-wide width bucket: the ViT at 200 tokens and the
    # refine's 101 queries over 200 keys (three 80-key tiles, ragged)
    (128, 8, 200, 200, 96, "packed", "bfloat16", "bfloat16", "wgmma"),
    (128, 8, 200, 200, 96, "packed", "bfloat16", "float32", "wgmma"),
    (1, 8, 200, 200, 96, "packed", "bfloat16", "bfloat16", "wgmma_small"),
    (128, 8, 101, 200, 96, "heads", "bfloat16", "bfloat16", "wgmma"),
    (8, 8, 101, 200, 96, "heads", "bfloat16", "bfloat16", "wgmma_small"),
]


def _attention_inputs(rng, B, H, Lq, Lk, Dh, layout, dt):
    """q, k, v of dtype ``dt`` on the card in the layout of the case."""
    D = H * Dh
    if layout == "packed":
        qkv = _dev(rng.standard_normal((B, Lk, 3 * D)), dt)
        return qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    if layout == "bhld":
        return tuple(_dev(rng.standard_normal((B, H, n, Dh)), dt) for n in (Lq, Lk, Lk))
    if layout == "lowvar":
        return (_dev(12 + 0.05 * rng.standard_normal((B, Lq, D)), dt),
                _dev(1 + 0.05 * rng.standard_normal((B, Lk, D)), dt),
                _dev(1 + rng.standard_normal((B, Lk, D)), dt))
    if layout == "misaligned":
        return tuple(_dev(rng.standard_normal((B, n, D + 4)), dt)[..., 4:]
                     for n in (Lq, Lk, Lk))
    return tuple(_dev(rng.standard_normal((B, n, D)), dt) for n in (Lq, Lk, Lk))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Lq,Lk,Dh,layout,dtype,out,route", ATTENTION_CASES)
def test_attention_routes_match_plain_versions(B, H, Lq, Lk, Dh, layout, dtype, out, route):
    """Each case through the wrapper the main path calls (f32 outputs
    through the attention launcher, as the int8 sublayer calls it): its
    launch counted once, the route taken, and the output against the plain
    version on the same values (bf16 inputs within 2e-2 of the largest
    value, f32 inputs within 1e-4 of it plus 1e-5)."""
    from yomitoku_tpu_torch.ops._common import attention, attention_route_launches

    _require_cuda()
    q, k, v = _attention_inputs(np.random.default_rng(34), B, H, Lq, Lk, Dh, layout,
                                getattr(torch, dtype))
    routes0 = dict(attention_route_launches)
    if layout == "bhld":
        name, n0 = "fused_attention", ops.launches["fused_attention"]
        got = ops.fused_attention(q, k, v)
        want = ops.fused_attention_reference(q.float(), k.float(), v.float())
    else:
        want = ops.fused_attention_heads_reference(q.float(), k.float(), v.float(), H)
        if out == "float32" and q.dtype == torch.bfloat16:
            name, n0 = None, 0
            got = torch.empty(q.shape, dtype=torch.float32, device="cuda")
            attention(q, k, v, got, H, Dh ** -0.5)
        else:
            name, n0 = "fused_attention_heads", ops.launches["fused_attention_heads"]
            got = ops.fused_attention_heads(q, k, v, H)
    torch.cuda.synchronize()
    if name:
        assert ops.launches[name] == n0 + 1
    taken = {r: n - routes0[r] for r, n in attention_route_launches.items()}
    assert taken == {r: int(r == route) for r in taken}, taken
    assert got.dtype == getattr(torch, out) and got.shape == want.shape
    rel, add = (1e-4, 1e-5) if dtype == "float32" else (2e-2, 0.0)
    err, top = (got.float() - want).abs().max().item(), want.abs().max().item()
    assert err <= rel * top + add, (err, top)


GEMM_EPILOGUES = ("ln", "bias", "gelu", "res", "none")
#: (M, N, K, route, forced): ragged M, N below every unit's width (96),
#: K not a multiple of 64 (200), on every bf16 route forced through the
#: launcher, and through the wrapper where its route choice lands: the
#: small grid and the 128-row one; f32 through the wrapper ("fma")
GEMM_CASES = (
    [(200, 96, 200, route, True) for route in ("wgmma", "wgmma_small")]
    + [(1000, 768, 768, "wgmma_small", False), (33000, 264, 200, "wgmma", False),
       (200, 96, 200, "fma", False)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", GEMM_EPILOGUES)
@pytest.mark.parametrize("layout", ["out_in.t", "in_out"])
@pytest.mark.parametrize("M,N,K,route,forced", GEMM_CASES)
def test_gemm_routes_match_plain_versions(M, N, K, route, forced, layout, epilogue):
    """The GEMM kernel on each route against the plain product of the same
    values (LN(a) rounded to the storage type first, as the kernel and the
    Pallas kernels round it), bf16 within 2e-2 of the largest value, f32
    within 1e-4 of it plus 1e-5; W as a torch Linear weight .t() and as a
    row-major (in, out) tensor.  Through the wrapper its launch is counted
    on the route taken; through the launcher nothing is counted."""
    import torch.nn.functional as F

    from yomitoku_tpu_torch.ops._common import gemm, gemm_route_launches, launch_gemm

    _require_cuda()
    dt = torch.float32 if route == "fma" else torch.bfloat16
    rng = np.random.default_rng(61)
    a = _dev(rng.standard_normal((M, K)), dt)
    w = _dev(rng.standard_normal((K, N)) * K ** -0.5, dt)
    if layout == "out_in.t":
        w = w.t().contiguous().t()
    bias = None if epilogue == "none" else _dev(0.1 * rng.standard_normal(N), dt)
    res = _dev(rng.standard_normal((M, N)), dt) if epilogue == "res" else None
    ln = None
    if epilogue == "ln":
        ln = (_dev(1 + 0.1 * rng.standard_normal(K), dt), _dev(0.1 * rng.standard_normal(K), dt),
              1e-6)
    gelu = epilogue == "gelu"
    out = torch.empty((M, N), dtype=dt, device="cuda")
    routes0 = dict(gemm_route_launches)
    if forced:
        launch_gemm(route, a, w, bias, out, res, ln, gelu)
    else:
        gemm(a, w, bias, out, res=res, ln=ln, gelu=gelu)
    torch.cuda.synchronize()
    taken = {r: n - routes0[r] for r, n in gemm_route_launches.items()}
    assert taken == {r: int(r == route and not forced) for r in taken}, taken
    x = a if ln is None else ops.layer_norm(a, ln[0], ln[1], ln[2])
    want = x.float() @ w.float() + (0 if bias is None else bias.float())
    if gelu:
        want = F.gelu(want)
    if res is not None:
        want = want + res.float()
    rel, add = (1e-4, 1e-5) if dt == torch.float32 else (2e-2, 0.0)
    err, top = (out.float() - want).abs().max().item(), want.abs().max().item()
    assert err <= rel * top + add, (err, top)


@pytest.mark.cuda
def test_small_rtdetr_f32_matches_cpu():
    """The layout parser of tests/yaml/layout_small.yaml in f32 on the card
    and on the CPU from the same seed: logits within 1e-3 of the largest,
    boxes within 1e-3, query by query.  On input seed 2 the gaps between
    the 20th and 21st selection scores are 0.023 and 0.032 (measured on
    the CPU), far above f32 differences, so both sides select alike."""
    _require_cuda()
    from pathlib import Path

    from yomitoku_tpu_torch.layout_parser import LayoutParser

    cfg = str(Path(__file__).parent / "yaml" / "layout_small.yaml")
    gpu = LayoutParser(path_cfg=cfg, device="cuda", dtype=torch.float32,
                       from_pretrained=False).model
    cpu = LayoutParser(path_cfg=cfg, device="cpu", from_pretrained=False).model
    x = np.random.default_rng(2).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    n0 = ops.launches["ms_deformable_attention"]
    got = {k: v.cpu() for k, v in gpu(x).items()}
    assert ops.launches["ms_deformable_attention"] > n0
    want = cpu(x)
    limit = 1e-3 * want["pred_logits"].abs().max().item()
    assert (got["pred_logits"] - want["pred_logits"]).abs().max().item() <= limit
    assert (got["pred_boxes"] - want["pred_boxes"]).abs().max().item() <= 1e-3


# ------------------------------------------------------------------ W8A8


def _dev(a, dt=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to("cuda", dt)


def _held_int8(got, want, dtype):
    """bf16: within 2e-2 of the largest value.  f32: within 1e-4 of it plus
    1e-5, except on at most 1% of the rows (a code moved at a rounding
    tie), which stay within 2e-2 of it."""
    d = (got.float() - want).abs().reshape(-1, want.shape[-1]).amax(-1)
    top = want.abs().max().item()
    if dtype == "bfloat16":
        assert d.max().item() <= 2e-2 * top, (d.max().item(), top)
        return
    off = d > 1e-4 * top + 1e-5
    assert off.float().mean().item() <= 1e-2, int(off.sum())
    assert d.max().item() <= 2e-2 * top, (d.max().item(), top)


def _int8_weights(rng, shapes):
    out = []
    for k, n in shapes:
        w = _dev(rng.standard_normal((k, n)) * k ** -0.5)
        out += list(ops.quantize_weight_int8(w)) + [_dev(rng.standard_normal(n) * 0.05)]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,Hd", [(300, 96, 384), (257, 64, 2048), (1024, 128, 512),
                                    (25600, 768, 3072)])  # the 400-wide bucket, batch 128
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_mlp_matches_plain_version(dtype, N, D, Hd):
    """fused_mlp_ln_int8 at ragged row counts; Hd=2048 quantizes the GELU
    output in two chunks of 1024."""
    _require_cuda()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(21)
    x = _dev(rng.standard_normal((N, D)), dt)
    g, b = _dev(1 + 0.1 * rng.standard_normal(D)), _dev(0.1 * rng.standard_normal(D))
    w = _int8_weights(rng, [(D, Hd), (Hd, D)])
    n0 = ops.launches["fused_mlp_ln_int8"]
    got = ops.fused_mlp_ln_int8(x, g, b, *w)
    want = ops.fused_mlp_ln_int8_reference(x.float(), g, b, *w)
    torch.cuda.synchronize()
    assert ops.launches["fused_mlp_ln_int8"] == n0 + 1
    assert got.dtype == dt
    _held_int8(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,D,H", [(3, 37, 96, 6), (2, 40, 128, 8), (2, 33, 96, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_attention_block_matches_plain_version(dtype, B, L, D, H):
    """fused_attention_block_ln_int8 with ragged L; head dims 16 (the bf16
    attention kernel's wgmma route, f32 output) and 24 (its FMA
    route)."""
    _require_cuda()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(22)
    x = _dev(rng.standard_normal((B, L, D)), dt)
    g, b = _dev(1 + 0.1 * rng.standard_normal(D)), _dev(0.1 * rng.standard_normal(D))
    w = _int8_weights(rng, [(D, D)] * 4)
    n0 = ops.launches["fused_attention_block_ln_int8"]
    got = ops.fused_attention_block_ln_int8(x, g, b, *w, H)
    want = ops.fused_attention_block_ln_int8_reference(x.float(), g, b, *w, H)
    torch.cuda.synchronize()
    assert ops.launches["fused_attention_block_ln_int8"] == n0 + 1
    _held_int8(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_attention_block_at_the_narrow_canvas(dtype):
    """fused_attention_block_ln_int8 at the 400-wide width bucket's shape,
    x (128, 200, 768), 8 heads.  bf16 within 2e-2 of the largest value.

    f32: at this size the row-quantize kernel's codes of LayerNorm(x)
    differ from the plain quantizer's in about one code in a million (by
    one step, where the two f32 LayerNorms round to either side of a tie),
    and such a code moves its token's q, k and v, so every row of its
    sequence moves.  So: the kernel's codes are at most one step off the
    plain version's and at most 1e-4 of them differ; the rows of the
    sequences no flip reaches hold the 1%-of-rows rule; and on the
    kernel's own codes the plain version of the rest of the block holds
    it on every row."""
    from yomitoku_tpu_torch.ops._common import layer_norm, quantize_rows
    from yomitoku_tpu_torch.ops.mlp import quantize_rows_reference

    _require_cuda()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(23)
    B, L, D, H = 128, 200, 768, 8
    x = _dev(rng.standard_normal((B, L, D)), dt)
    g, b = _dev(1 + 0.1 * rng.standard_normal(D)), _dev(0.1 * rng.standard_normal(D))
    w = _int8_weights(rng, [(D, D)] * 4)
    n0 = ops.launches["fused_attention_block_ln_int8"]
    got = ops.fused_attention_block_ln_int8(x, g, b, *w, H)
    want = ops.fused_attention_block_ln_int8_reference(x.float(), g, b, *w, H)
    torch.cuda.synchronize()
    assert ops.launches["fused_attention_block_ln_int8"] == n0 + 1
    if dtype == "bfloat16":
        _held_int8(got, want, dtype)
        return
    xq = torch.empty((B * L, D), dtype=torch.int8, device="cuda")
    sx = torch.empty((B * L, 1), dtype=torch.float32, device="cuda")
    quantize_rows(x.view(B * L, D), xq, sx, ln=(g, b, 1e-6))
    hq, _ = quantize_rows_reference(layer_norm(x, g, b, 1e-6, torch.float32).view(B * L, D))
    step = (xq.int() - hq.int()).abs()
    assert step.max().item() <= 1 and (step > 0).float().mean().item() <= 1e-4
    flipped = (step > 0).view(B, L * D).any(1)
    top = want.abs().max().item()
    d = (got - want).abs().reshape(B, L, D).amax(-1)
    assert (d[~flipped] > 1e-4 * top + 1e-5).float().mean().item() <= 1e-2
    assert d.max().item() <= 2e-2 * top
    same = ops.fused_attention_block_ln_int8_reference(x, g, b, *w, H, ln_codes=(xq, sx))
    _held_int8(got, same, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,ln", [(None, True), (None, False), (128, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_kernel_codes(dtype, chunk, ln):
    from yomitoku_tpu_torch.ops._common import quantize_rows

    _require_cuda()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(23)
    M, K = 333, 512
    x = _dev(rng.standard_normal((M, K)) * 3, dt)
    g, b = _dev(1 + 0.1 * rng.standard_normal(K)), _dev(0.1 * rng.standard_normal(K))
    nc = K // (chunk or K)
    q = torch.empty((M, K), dtype=torch.int8, device="cuda")
    s = torch.empty((M, nc), dtype=torch.float32, device="cuda")
    quantize_rows(x, q, s, ln=(g, b, 1e-6) if ln else None)
    v = ops.layer_norm(x, g, b, 1e-6, torch.float32) if ln else x.float()
    wq, ws = ops.quantize_rows_reference(v, chunk)
    torch.cuda.synchronize()
    d = (q.int() - wq.int()).abs()
    assert d.max().item() <= 1 and d.float().mean().item() <= 1e-3
    torch.testing.assert_close(s, ws, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("gelu,res,kchunk", [(True, False, 1024), (False, True, 1024),
                                             (False, True, 3072), (False, False, 192)])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_gemm_matches_plain_on_same_codes(out_dtype, gelu, res, kchunk):
    """The int8 GEMM on given codes and scales: exact int32 sums, then the
    plain version's f32 epilogue (within 1e-5 of the largest value, the
    erf and the output rounding aside)."""
    from yomitoku_tpu_torch.ops._common import gemm_int8
    from yomitoku_tpu_torch.ops.mlp import dequantize, int_matmul

    _require_cuda()
    dt = getattr(torch, out_dtype)
    rng = np.random.default_rng(24)
    M, K, N = 201, 3072 if kchunk != 192 else 192, 136
    a = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8)).cuda()
    w = torch.from_numpy(rng.integers(-127, 128, (N, K), dtype=np.int8)).cuda().t()
    nc = K // kchunk
    sa = _dev(rng.random((M, nc)) * 1e-3)
    sw = _dev(rng.random(N) * 1e-3)
    bias = _dev(rng.standard_normal(N))
    r = _dev(rng.standard_normal((M, N)), dt) if res else None
    out = torch.empty((M, N), dtype=dt, device="cuda")
    gemm_int8(a, sa, w, sw, bias, out, res=r, gelu=gelu)
    want = 0
    for c in range(nc):
        sl = slice(c * kchunk, (c + 1) * kchunk)
        want = want + dequantize(int_matmul(a[:, sl], w[sl]), sa[:, c:c + 1], sw)
    want = want + bias
    if gelu:
        want = torch.nn.functional.gelu(want)
    if res:
        want = r.float() + want
    torch.cuda.synchronize()
    tol = 1e-5 if out_dtype == "float32" else 2 ** -8
    assert (out.float() - want).abs().max().item() <= tol * want.abs().max().item()


#: (M, K, kchunk, N, route, forced): ragged M (201, 333), three K-chunks of
#: 1024, a ragged K of 192 in one chunk (TMA's zero fill), N below a unit's
#: width (136) and the recognizer's batch-1 projections (M = 400), on every
#: int8 route forced through the launcher, and through the wrapper where
#: its route choice lands (small grids on "wgmma_m64", 4096 x 768 on
#: "wgmma", or "wgmma_coop" with K in chunks or GELU); at M = 4096 the blocks take
#: two or three units each (two warpgroups in turns, chunk by chunk where
#: K is chunked, and a unit without a partner; or sharing each unit)
INT8_GEMM_CASES = (
    [(333, 192, 192, 136, route, True) for route in ("wgmma", "wgmma_m64", "wgmma_coop")]
    + [(201, 768, 768, 136, "wgmma", True), (201, 3072, 1024, 136, "wgmma_m64", True),
       (201, 3072, 1024, 136, "wgmma_coop", True), (201, 3072, 1024, 136, "wgmma_m64", False),
       (400, 768, 768, 2304, "wgmma_m64", False), (400, 768, 768, 768, "wgmma", True),
       (4096, 768, 768, 768, "wgmma", False), (4096, 768, 768, 768, "wgmma_m64", True),
       (4096, 3072, 1024, 768, "wgmma_m64", True), (4096, 3072, 1024, 768, "wgmma_coop", False)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", ["bias", "gelu", "res", "none"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,kchunk,N,route,forced", INT8_GEMM_CASES)
def test_int8_gemm_routes_match_plain_on_same_codes(M, K, kchunk, N, route, forced, out_dtype,
                                                    epilogue):
    """The int8 GEMM on each route against the plain version on the same
    codes and scales (exact int32 sums per K-chunk, then the f32
    epilogue): f32 within 1e-5 of the largest value, bf16 within 2^-8 of
    it.  Through the wrapper its launch is counted on the route taken;
    through the launcher nothing is counted."""
    from yomitoku_tpu_torch.ops._common import (
        gemm_int8,
        gemm_int8_route_launches,
        launch_gemm_int8,
    )
    from yomitoku_tpu_torch.ops.mlp import dequantize, int_matmul

    _require_cuda()
    dt = getattr(torch, out_dtype)
    rng = np.random.default_rng(25)
    a = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8)).cuda()
    w = torch.from_numpy(rng.integers(-127, 128, (N, K), dtype=np.int8)).cuda().t()
    nc = K // kchunk
    sa = _dev(rng.random((M, nc)) * 1e-3)
    sw = _dev(rng.random(N) * 1e-3)
    bias = None if epilogue == "none" else _dev(rng.standard_normal(N))
    r = _dev(rng.standard_normal((M, N)), dt) if epilogue == "res" else None
    gelu = epilogue == "gelu"
    out = torch.empty((M, N), dtype=dt, device="cuda")
    routes0 = dict(gemm_int8_route_launches)
    if forced:
        launch_gemm_int8(route, a, sa, w, sw, bias, out, res=r, gelu=gelu)
    else:
        gemm_int8(a, sa, w, sw, bias, out, res=r, gelu=gelu)
        if gelu and route == "wgmma":  # the wrapper shares GELU units
            route = "wgmma_coop"
    want = 0
    for c in range(nc):
        sl = slice(c * kchunk, (c + 1) * kchunk)
        want = want + dequantize(int_matmul(a[:, sl], w[sl]), sa[:, c:c + 1], sw)
    if bias is not None:
        want = want + bias
    if gelu:
        want = torch.nn.functional.gelu(want)
    if r is not None:
        want = r.float() + want
    torch.cuda.synchronize()
    taken = {k: n - routes0[k] for k, n in gemm_int8_route_launches.items()}
    assert taken == {k: int(k == route and not forced) for k in taken}, taken
    tol = 1e-5 if out_dtype == "float32" else 2 ** -8
    err, top = (out.float() - want).abs().max().item(), want.abs().max().item()
    assert err <= tol * top, (err, top)


@pytest.mark.cuda
def test_int8_gemm_route_refuses_a_chunked_wide_unit():
    """The C entry obeys the route or refuses it: "wgmma" (128-row units)
    holds no f32 fold, so a K-chunked product on it raises."""
    from yomitoku_tpu_torch.ops._common import launch_gemm_int8

    _require_cuda()
    a = torch.zeros((256, 2048), dtype=torch.int8, device="cuda")
    w = torch.zeros((128, 2048), dtype=torch.int8, device="cuda").t()
    sa, sw = torch.ones((256, 2), device="cuda"), torch.ones(128, device="cuda")
    out = torch.empty((256, 128), device="cuda")
    with pytest.raises(RuntimeError, match="route not built"):
        launch_gemm_int8("wgmma", a, sa, w, sw, None, out)


@pytest.mark.cuda
def test_int8_kv_loop_matches_full_cache(monkeypatch):
    """A small PARSeq in f32 on the card with the int8 memory-K/V cache (the
    card's default) against the full cache, two batches of one size (one
    CUDA graph, captured on the first, replayed on the second), with the
    JAX package's criteria (tests/test_int8_kv.py): at least 70% of ids
    equal, probs before each row's first divergence within 2e-2, and each
    first divergence a near-tie of the full-cache path (gap < 0.05)."""
    _require_cuda()
    from pathlib import Path

    from yomitoku_tpu_torch.text_recognizer import TextRecognizer

    cfg = str(Path(__file__).parent / "yaml" / "rec_small.yaml")
    monkeypatch.delenv("YOMITOKU_TPU_INT8_KV", raising=False)
    q8 = TextRecognizer(path_cfg=cfg, device="cuda", dtype=torch.float32,
                        from_pretrained=False).model
    monkeypatch.setenv("YOMITOKU_TPU_INT8_KV", "0")
    full = TextRecognizer(path_cfg=cfg, device="cuda", dtype=torch.float32,
                          from_pretrained=False).model
    assert q8.int8_kv and not full.int8_kv
    rng = np.random.default_rng(9)
    for _ in range(2):
        x = rng.integers(0, 256, (40, 32, 32, 3), dtype=np.uint8)
        ids_a, probs_a = full.forward_tokens(x)
        ids_b, probs_b = q8.forward_tokens(x)
        assert (ids_a == ids_b).mean() >= 0.7
        dist = full.forward_probs(torch.from_numpy(x)).cpu().numpy()
        for r in range(len(ids_a)):
            diff = np.nonzero(ids_a[r] != ids_b[r])[0]
            j0 = diff[0] if diff.size else ids_a.shape[1]
            np.testing.assert_allclose(probs_a[r, :j0], probs_b[r, :j0], atol=2e-2)
            if diff.size:
                assert dist[r, j0, ids_a[r, j0]] - dist[r, j0, ids_b[r, j0]] < 0.05
    loop = q8._ar_loops[(40, 16)]  # a 32x32 canvas of 8x8 patches
    assert list(q8._ar_loops) == [(40, 16)] and loop.graph is not None
    assert loop.mem[0].dtype == torch.int8


# ------------------------------------------------------------------ fused backbone


def _block_args(rng, dt, B, H, W, Cin, Cm, Cout, proj):
    """x (B, H, W, Cin) and fused_bottleneck's weights (fan-in scaled, in
    ``dt``) and f32 biases."""
    def w(*shape):
        return _dev(rng.standard_normal(shape) * shape[-2] ** -0.5, dt)

    def b(n):
        return _dev(rng.standard_normal(n) * 0.1)

    args = [_dev(rng.standard_normal((B, H, W, Cin)), dt), w(Cin, Cm), b(Cm),
            w(9, Cm, Cm) / 3, b(Cm), w(Cm, Cout), b(Cout)]
    return args + ([w(Cin, Cout), b(Cout)] if proj else [None, None])


def _held(got, want, dtype):
    """f32 within 1e-4 of the largest value plus 1e-5; bf16 (against the
    plain version on the same bf16 values, which rounds h1 and h2 where the
    kernel does) within 2e-2 of it."""
    rel, add = (1e-4, 1e-5) if dtype == "float32" else (2e-2, 0.0)
    err, top = (got.float() - want.float()).abs().max().item(), want.float().abs().max().item()
    assert err <= rel * top + add, (err, top)


def _planned_routes(dt, B, H, W, Cin, Cm, Cout, proj, blocks=1):
    """conv_route_launches' moves that one block (or ``blocks`` blocks) on
    the current card should make: one launch per convolution, on the route
    the plans pick."""
    from yomitoku_tpu_torch.ops._common import CONV_ROUTES, _sm_count, block_plans

    plans = block_plans(dt, B, H, W, Cin, Cm, Cout, proj, True,
                        _sm_count(torch.cuda.current_device()))[0]
    want = dict.fromkeys(CONV_ROUTES, 0)
    for plan in plans:
        want[plan[0]] += blocks
    return want


def _route_moves(before):
    from yomitoku_tpu_torch.ops._common import conv_route_launches

    return {r: n - before[r] for r, n in conv_route_launches.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,Cin,Cm,Cout,d,proj", [
    (2, 13, 10, 32, 16, 64, 2, True),     # odd sizes, dilation 2, projection
    (2, 13, 10, 64, 16, 64, 1, False),    # odd sizes, identity
    (1, 9, 17, 64, 24, 64, 2, False),     # Cm % 32 != 0: a partial K tile
    (1, 37, 29, 64, 64, 256, 1, True),    # DBNet layer1_0's widths
    (1, 25, 19, 256, 128, 256, 2, False),  # several M and N tiles, d = 2
    (1, 5, 4, 128, 32, 128, 2, False),    # every 3x3 tap partly off the page
    (1, 20, 20, 2048, 512, 2048, 1, False),  # PResNet stage3: the split route
    (1, 150, 123, 64, 64, 256, 1, True),  # W no multiple of the patch width, N = 64 units
    (1, 2, 3, 64, 32, 64, 2, False),      # d = 2: the rows' taps wholly off the page
    (4, 40, 40, 1024, 256, 1024, 1, False),  # PResNet stage2 at the TSR's batch of 4
    (1, 160, 160, 256, 64, 256, 1, False),  # Cm = 64 on "wgmma": PResNet stage0
    # PResNet's late stages at the table recognizer's page-route batches
    (2, 20, 20, 2048, 512, 2048, 1, False),  # split route, 2 splits
    (2, 40, 40, 1024, 256, 1024, 1, False),  # 64-pixel units
    (8, 20, 20, 2048, 512, 2048, 1, False),  # 128-pixel units
    (16, 40, 40, 1024, 256, 1024, 1, False),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bottleneck_kernel_matches_plain_version(dtype, B, H, W, Cin, Cm, Cout, d, proj):
    """One block against the plain version, its launch counted once and
    each of its three convolutions on the route its plan picks."""
    from yomitoku_tpu_torch.ops._common import conv_route_launches

    _require_cuda()
    dt = getattr(torch, dtype)
    args = _block_args(np.random.default_rng(31), dt, B, H, W, Cin, Cm, Cout, proj)
    n0, routes0 = ops.launches["fused_bottleneck"], dict(conv_route_launches)
    got = ops.fused_bottleneck(*args, dilation=d)
    want = ops.bottleneck_reference(*args, dilation=d)
    torch.cuda.synchronize()
    assert ops.launches["fused_bottleneck"] == n0 + 1
    assert _route_moves(routes0) == _planned_routes(dt, B, H, W, Cin, Cm, Cout, proj)
    assert got.dtype == dt and got.shape == (B, H, W, Cout)
    _held(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("N,d,H,W,B,C,Cm", [
    (3, 1, 13, 10, 2, 64, 16), (2, 2, 13, 10, 2, 64, 16), (1, 2, 6, 7, 2, 64, 16),
    (5, 1, 20, 9, 2, 64, 16),
    (5, 1, 100, 74, 1, 1024, 256),  # DBNet layer3
    (2, 1, 20, 20, 1, 2048, 512),   # PResNet stage3's widths: the split route
    (2, 2, 9, 11, 4, 256, 64),      # batch 4, d = 2, Cm = 64 units
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_identity_stage_kernel_matches_plain_version(dtype, N, d, H, W, B, C, Cm):
    """N identity blocks against the plain version, one launch counted and
    3 N convolutions on the routes the plans pick."""
    from yomitoku_tpu_torch.ops._common import conv_route_launches

    _require_cuda()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(32)
    blocks = [_block_args(rng, dt, B, H, W, C, Cm, C, False) for _ in range(N)]
    x = blocks[0][0]
    stacks = [torch.stack([blk[i] for blk in blocks]) for i in range(1, 7)]
    n0, routes0 = ops.launches["fused_identity_stage"], dict(conv_route_launches)
    got = ops.fused_identity_stage(x, *stacks, dilation=d)
    want = ops.fused_identity_stage_reference(x, *stacks, dilation=d)
    torch.cuda.synchronize()
    assert ops.launches["fused_identity_stage"] == n0 + 1
    assert _route_moves(routes0) == _planned_routes(dt, B, H, W, C, Cm, C, False, N)
    assert got.shape == x.shape
    _held(got, want, dtype)


#: (B, H, W, K, N, taps, d, segment 2, residual): the 3x3 at dilations 1
#: and 2 with a ragged page, a 1x1 reduce with K not a multiple of 64, the
#: expand with the projection's second K segment and with a residual, N =
#: 64 (its own instantiation) and N = 192 (a partial 128-wide n tile)
CONV_CASES = [
    (2, 13, 21, 128, 192, 9, 2, False, False),
    (1, 30, 17, 64, 64, 9, 1, False, False),
    (3, 11, 7, 200, 96, 1, 1, False, False),
    (1, 29, 31, 64, 256, 1, 1, True, False),
    (2, 9, 14, 128, 512, 1, 1, False, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("route,splits", [("wgmma", 1), ("wgmma_small", 1),
                                          ("wgmma_split", 3), ("fma", 1)])
@pytest.mark.parametrize("B,H,W,K,N,taps,d,seg2,res", CONV_CASES)
def test_conv_routes_match_plain_versions(B, H, W, K, N, taps, d, seg2, res, route, splits):
    """Every route of the convolution kernel forced through ``launch_conv``
    against ``conv_reference`` on the same values (bf16 within 2e-2 of the
    largest value; "fma" in f32 within 1e-4 of it plus 1e-5); nothing is
    counted."""
    from yomitoku_tpu_torch.ops._common import conv_route_launches, launch_conv

    _require_cuda()
    dt = torch.float32 if route == "fma" else torch.bfloat16
    rng = np.random.default_rng(37)
    x = _dev(rng.standard_normal((B, H, W, K)), dt)
    w = _dev(rng.standard_normal((9, K, N) if taps == 9 else (K, N)) * (taps * K) ** -0.5, dt)
    bias = _dev(0.1 * rng.standard_normal(N))
    x2 = w2 = b2 = r = None
    if seg2:
        x2 = _dev(rng.standard_normal((B, H, W, 72)), dt)
        w2, b2 = _dev(rng.standard_normal((72, N)) / 8.5, dt), _dev(0.1 * rng.standard_normal(N))
    if res:
        r = _dev(rng.standard_normal((B, H, W, N)), dt)
    out = torch.empty((B, H, W, N), dtype=dt, device="cuda")
    routes0 = dict(conv_route_launches)
    launch_conv(route, x, w, bias, out, d, x2, w2, b2, r, splits)
    torch.cuda.synchronize()
    assert not any(_route_moves(routes0).values())
    want = ops.conv_reference(x, w, bias, d, x2, w2, b2, r)
    _held(out, want, "float32" if route == "fma" else "bfloat16")


@pytest.mark.cuda
def test_split_route_repeats_bit_for_bit():
    """The split route sums its K splits in a fixed order: two runs agree
    bit for bit."""
    from yomitoku_tpu_torch.ops._common import launch_conv

    _require_cuda()
    rng = np.random.default_rng(38)
    x = _dev(rng.standard_normal((1, 20, 20, 512)), torch.bfloat16)
    w = _dev(rng.standard_normal((9, 512, 512)) / 68, torch.bfloat16)
    bias = _dev(0.1 * rng.standard_normal(512))
    outs = [torch.empty((1, 20, 20, 512), dtype=torch.bfloat16, device="cuda") for _ in range(2)]
    for out in outs:
        launch_conv("wgmma_split", x, w, bias, out, 1, splits=5)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_wrappers_launch_with_another_device_current():
    """The bottleneck, stage and deformable wrappers launch on their
    tensors' card while another card is current (``_launch``'s guard), and
    leave the current card as it was."""
    _require_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    rng = np.random.default_rng(39)
    dev = torch.device("cuda", 1)
    args = [None if a is None else a.to(dev)
            for a in _block_args(rng, torch.bfloat16, 1, 13, 10, 64, 16, 64, False)]
    stacks = [a[None] for a in args[1:7]]
    shapes, points = ((8, 8), (4, 4)), (2, 2)
    value = torch.from_numpy(rng.standard_normal((1, 80, 2, 32)).astype(np.float32)).to(dev)
    loc = torch.from_numpy(rng.random((1, 5, 2, 4, 2)).astype(np.float32)).to(dev)
    att = torch.from_numpy(rng.random((1, 5, 2, 4)).astype(np.float32)).to(dev)
    with torch.cuda.device(0):
        got = [ops.fused_bottleneck(*args[:7]), ops.fused_identity_stage(args[0], *stacks),
               ops.ms_deformable_attention(value, loc, att, shapes, points)]
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(dev)
    want = [ops.bottleneck_reference(*args[:7]),
            ops.fused_identity_stage_reference(args[0], *stacks),
            ops.ms_deformable_attention_reference(value, loc, att, shapes, points)]
    for g, w, dt in zip(got, want, ("bfloat16", "bfloat16", "float32")):
        assert g.device == dev
        _held(g, w, dt)


@pytest.mark.cuda
def test_fused_backbone_raises_on_non_nhwc_input(monkeypatch):
    """The kernels read NHWC rows in place: an NCHW-contiguous CUDA tensor
    raises (nothing copies it quietly), in the wrappers and in a block
    whose gate is open."""
    _require_cuda()
    from yomitoku_tpu_torch.models.layers.resnet import Bottleneck

    rng = np.random.default_rng(33)
    args = _block_args(rng, torch.float32, 1, 6, 5, 32, 8, 32, False)
    nchw = args[0].permute(0, 3, 1, 2).contiguous()
    with pytest.raises(ValueError, match="NHWC"):
        ops.fused_bottleneck(nchw.permute(0, 2, 3, 1), *args[1:])
    stacks = [a[None] for a in args[1:7]]
    with pytest.raises(ValueError, match="NHWC"):
        ops.fused_identity_stage(nchw.permute(0, 2, 3, 1), *stacks)
    monkeypatch.setenv("YOMITOKU_TPU_FUSED_BOTTLENECK", "1")
    block = Bottleneck(32, 8).cuda()
    with pytest.raises(ValueError, match="NHWC"):
        block(nchw)
    out = block(nchw.contiguous(memory_format=torch.channels_last))
    assert out.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,D,H", [(2, 37, 96, 4), (1, 400, 256, 8)])
@pytest.mark.parametrize("layout", ["out_in.t", "in_out"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_attention_block_matches_plain_version(dtype, layout, B, L, D, H):
    _require_cuda()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(35)
    args = [_dev(rng.standard_normal((B, L, D)), dt)]
    for _ in range(4):
        w = _dev(rng.standard_normal((D, D)) * D ** -0.5, dt)
        args += [w.t().contiguous().t() if layout == "out_in.t" else w,
                 _dev(rng.standard_normal(D) * 0.05, dt)]
    n0 = ops.launches["fused_attention_block"]
    got = ops.fused_attention_block(*args, H)
    want = ops.fused_attention_block_reference(*[a.float() for a in args], H)
    torch.cuda.synchronize()
    assert ops.launches["fused_attention_block"] == n0 + 1
    _held(got, want, dtype)


@pytest.mark.cuda
def test_small_dbnet_fused_f32_matches_cpu(monkeypatch):
    """DBNet (dbnetv2_1, full widths) at 64x96 in f32 with both fused-backbone
    switches on, on the card, against the same seed-0 weights on the CPU's
    library path: the map within 1e-4."""
    _require_cuda()
    from yomitoku_tpu_torch.text_detector import TextDetector

    monkeypatch.setenv("YOMITOKU_TPU_FUSED_BOTTLENECK", "1")
    monkeypatch.setenv("YOMITOKU_TPU_FUSED_STAGE", "1")
    gpu = TextDetector(device="cuda", dtype=torch.float32, from_pretrained=False).model
    cpu = TextDetector(device="cpu", from_pretrained=False).model
    x = np.random.default_rng(36).random((2, 64, 96, 3)).astype(np.float32)
    ops.reset_launches()
    got = gpu.forward_binary(x)
    assert ops.launches["fused_bottleneck"] == 2
    assert ops.launches["fused_identity_stage"] == 4
    np.testing.assert_allclose(got, cpu.forward_binary(x), atol=1e-4)


# ------------------------------------------------------------------ page crops


def _crop_inputs():
    """A printed page with 128 aligned lines (some of them vertical), two
    skewed quads and a perspective one; the regions of the detector's and
    layout parser's full-page resize and of four tables."""
    import cv2

    from yomitoku_tpu_torch.ops import device_crop as dc

    rng = np.random.default_rng(3)
    page = np.full((1800, 1200, 3), 255, np.uint8)
    quads = []
    for i in range(120):
        y = 10 + 14 * i
        x1 = int(rng.integers(200, 1000))
        cv2.putText(page, "ABC 0123 xyz" * 3, (12, y + 11), cv2.FONT_HERSHEY_SIMPLEX, 0.4,
                    (0, 0, 0), 1)
        quads.append([[10, y], [x1, y], [x1, y + 12], [10, y + 12]])
    quads += [[[1100, 40 + 200 * i], [1130, 40 + 200 * i], [1130, 220 + 200 * i],
               [1100, 220 + 200 * i]] for i in range(8)]
    skewed = [[[20, 60], [400, 80], [398, 110], [18, 90]],
              [[500, 300], [900, 260], [903, 300], [503, 340]],
              [[100, 500], [700, 520], [690, 580], [95, 555]]]
    return dc.pad_page(page), quads, skewed


@pytest.mark.cuda
def test_crops_on_the_card_match_the_cpu():
    """sample_lines and sample_regions_separable on the card against the
    same functions on the CPU (0-255 scale: max|d| <= 0.1, mean <= 1e-3,
    whatever the TF32 switches say); the narrow canvas equal to the left
    slice of the full one."""
    from yomitoku_tpu_torch.ops import device_crop as dc
    from yomitoku_tpu_torch.ops import separable_resize as sr

    _require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = True  # the crops must not use it
    try:
        page, quads, skewed = _crop_inputs()
        mats, wh = dc.line_homographies(quads + skewed, (32, 800))
        regions = [[(0, 0, 1200, 1800)], [(40, 120, 920, 560), (40, 600, 920, 1180),
                                          (0, 0, 480, 640), (480, 640, 960, 1280)]]
        cpu, card = torch.device("cpu"), torch.device("cuda")

        def run(dev):
            p = torch.from_numpy(page).to(dev)
            out = {"gather": dc.sample_lines(p, torch.from_numpy(mats), torch.from_numpy(wh))}
            for i, (rs, hw) in enumerate(zip(regions, ((1184, 800), (640, 640)))):
                m, _ = dc.region_mats(rs, hw)
                out[f"regions{i}"] = sr.sample_regions_separable(p, torch.from_numpy(m), hw,
                                                                 flip_bgr=bool(i))
            return out

        want, got = run(cpu), run(card)
        for k in want:
            d = (got[k].cpu() - want[k]).abs()
            assert d.max().item() <= 0.1 and d.mean().item() <= 1e-3, (k, d.max(), d.mean())
        p = torch.from_numpy(page).to(card)
        narrow = dc.sample_lines(p, torch.from_numpy(mats), torch.from_numpy(wh),
                                 out_hw=(32, 400))
        fits = torch.from_numpy(wh[:, 0] <= 400)
        assert fits.sum() > 10
        assert torch.equal(narrow[fits], got["gather"][fits][:, :, :400])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False



def _document_pages():
    """Pages of 2-5 lines of two words each: pages with the same number of
    lines decode in the same AR loop."""
    import cv2

    pages = []
    for n in (4, 4, 2, 5, 3, 4):
        img = np.full((120, 180, 3), 255, np.uint8)
        for i in range(n):
            y = int(120 / (n + 1) * (i + 1))
            cv2.putText(img, f"L{i} AB", (8, y), cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 0, 0), 2)
            cv2.putText(img, f"Z{i}", (108, y), cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 0, 0), 2)
        pages.append(img)
    return pages


@pytest.mark.cuda
def test_document_batch_on_a_cold_analyzer_equals_calls():
    """DocumentAnalyzer.batch(max_in_flight=4) on a freshly built analyzer
    (small configs, bf16, the page route and the int8 memory-K/V cache:
    the card's defaults), whose AR graphs are captured while other pages
    run, gives each page what its own __call__ gives on a second analyzer
    with the same weights, bit for bit; then again, warm."""
    _require_cuda()
    from pathlib import Path

    from yomitoku_tpu_torch.document_analyzer import DocumentAnalyzer
    from yomitoku_tpu_torch.utils.synthetic_heads import (
        balance_final_score_head,
        spread_score_heads,
    )

    yaml = Path(__file__).parent / "yaml"
    small = lambda name: {"path_cfg": str(yaml / name), "from_pretrained": False}  # noqa: E731
    configs = {"ocr": {"text_detector": small("det_small.yaml"),
                       "text_recognizer": small("rec_small.yaml")},
               "layout_analyzer": {"layout_parser": small("layout_small.yaml"),
                                   "table_structure_recognizer": small("layout_small.yaml")}}
    warm, cold = (DocumentAnalyzer(configs=configs, device="cuda") for _ in range(2))
    pages = _document_pages()
    lp = warm.layout.layout_parser
    balance_final_score_head(spread_score_heads(lp.model), lp.preprocess(pages[0]))
    with torch.no_grad():
        warm.text_detector.model.decoder.binarize[6].weight.mul_(10.0)
    for a, b in ((warm.text_detector, cold.text_detector),
                 (warm.text_recognizer, cold.text_recognizer), (lp, cold.layout.layout_parser),
                 (warm.layout.table_structure_recognizer,
                  cold.layout.table_structure_recognizer)):
        b.model.load_state_dict(a.model.state_dict())
    want = [warm(p)[0].model_dump() for p in pages]
    assert sum(len(w["words"]) for w in want) > len(pages)
    for _ in range(2):
        got = cold.batch(pages, max_in_flight=4)
        assert [g[0].model_dump() for g in got] == want
    assert cold.text_recognizer.model._ar_loops
