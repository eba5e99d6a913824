"""The port's CUDA kernels on the card, against their plain PyTorch
versions, and small models in f32 on the card against the CPU.  Every test here needs a GPU and skips without one.  The module
imports neither JAX nor the JAX package's models, so it runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: f32 kernels (TF32 off) within 1e-4 of the largest reference
value plus 1e-5 (summation order only); bf16 inputs against the f32 plain
version of the same bf16 values within 2e-2 of the largest value (the
kernels round intermediates to bf16 where the Pallas kernels do)."""

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
    attention kernel's FMA path, 16 (6 heads) its tensor-core path in bf16;
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
def test_small_recognizer_f32_matches_cpu():
    """A small PARSeq (tests/yaml/rec_small.yaml) in f32 on the card and on
    the CPU from the same seed, two batches: equal greedy ids, probs within
    1e-4."""
    _require_cuda()
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


@pytest.mark.cuda
@pytest.mark.parametrize("batch,lq,points", [
    (1, 300, (4, 4, 4)), (1, 2500, (4, 4, 4)), (1, 37, (4, 2, 1)),
    (4, 300, (4, 4, 4)), (3, 37, (4, 2, 1))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deformable_kernel_matches_plain_version(dtype, batch, lq, points):
    """ms_deformable_attention at RT-DETR's 640x640 pyramid (80, 40, 20), 8
    heads of 32, some locations off the map: the layout decoder's 300
    queries, the cell detector's 2500, uneven points at a ragged Lq, and
    the table recognizer's batch of 4 crops (each image its own value)."""
    _require_cuda()
    dt = getattr(torch, dtype)
    shapes = ((80, 80), (40, 40), (20, 20))
    rng = np.random.default_rng(11)
    P = sum(points)
    att = rng.random((batch, lq, 8, P))
    args = [rng.standard_normal((batch, 8400, 8, 32)),
            rng.random((batch, lq, 8, P, 2)) * 1.3 - 0.15,
            att / att.sum(-1, keepdims=True)]
    args = [torch.from_numpy(a.astype(np.float32)).to("cuda", dt) for a in args]
    n0 = ops.launches["ms_deformable_attention"]
    got = ops.ms_deformable_attention(*args, shapes, points).float()
    want = ops.ms_deformable_attention_reference(*[a.float() for a in args],
                                                 shapes, points)
    torch.cuda.synchronize()
    assert ops.launches["ms_deformable_attention"] == n0 + 1
    rel, add = (1e-4, 1e-5) if dtype == "float32" else (2e-2, 0.0)
    limit = rel * want.abs().max().item() + add
    assert (got - want).abs().max().item() <= limit


@pytest.mark.cuda
@pytest.mark.parametrize("batch,lq,lk", [(1, 400, 400), (4, 300, 300), (2, 300, 400)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_heads_at_rtdetr_shapes(dtype, batch, lq, lk):
    """fused_attention_heads with 8 heads of 32 (the bf16 tensor-core path
    needs Dh % 16 == 0): AIFI's L=400, the decoder's 300 queries (ragged
    against the 64-key tiles) and a cross shape."""
    _require_cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(3)
    q, k, v = [torch.randn(batch, n, 256, generator=g).to("cuda", dt)
               for n in (lq, lk, lk)]
    got = ops.fused_attention_heads(q, k, v, 8).float()
    want = ops.fused_attention_heads_reference(q.float(), k.float(), v.float(), 8)
    torch.cuda.synchronize()
    rel, add = (1e-4, 1e-5) if dtype == "float32" else (2e-2, 0.0)
    assert (got - want).abs().max().item() <= rel * want.abs().max().item() + add


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
