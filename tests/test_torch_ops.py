"""The port's four kernel wrappers (yomitoku_tpu_torch.ops) on CPU tensors,
where they run their plain PyTorch versions, against the JAX package's
Pallas kernels in interpret mode, on the same seeded numpy inputs.

Tolerance atol = rtol = 1e-4: both sides compute in f32 (LayerNorm
statistics, logits, accumulation) and differ only in summation order and
in the GELU's erf (the Pallas kernels' A&S 7.1.26 rational form, |err| <=
1.5e-7, against torch's erf).  The CUDA kernels themselves are held
against these plain versions on the card (chip_smoke.py and
tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yomitoku_tpu.ops.pallas import flash_attention as pallas_attn
from yomitoku_tpu.ops.pallas import fused_mlp as pallas_mlp
from yomitoku_tpu_torch import ops

TOL = dict(atol=1e-4, rtol=1e-4)


def _rows(rng, n, d, collapsed):
    """(n, d) rows; ``collapsed`` rows have across-channel variance
    ~1e-6, the regime where LayerNorm eps (1e-6 vs 1e-5) is an O(1) effect
    (the RT-DETR eps fault, commit 6ffced8).  Their mean is kept at 0.01:
    at larger means the one-pass f32 variance E[x^2] - mean^2 cancels so
    far that two summation orders of the same formula already differ by
    more than the tolerance (4e-4 at mean 0.05, 7e-2 at 0.5)."""
    x = rng.randn(n, d).astype(np.float32)
    if collapsed:
        x = 0.01 + 1e-3 * (x - x.mean(-1, keepdims=True))
    return x.astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _counts_unchanged(fn):
    before = dict(ops.launches)
    out = fn()
    assert ops.launches == before, "a CPU call must not count as a launch"
    return out


@pytest.mark.parametrize(
    "B,Lq,Lk,D,H",
    [
        (2, 13, 24, 48, 4),    # ragged Lq (the kernel masks it, Pallas pads)
        (2, 24, 16, 64, 4),
        (1, 101, 40, 96, 8),   # PARSeq refine: 101 queries, 8 heads
    ],
)
def test_fused_attention_heads_matches_pallas(B, Lq, Lk, D, H):
    rng = np.random.RandomState(0)
    q = rng.randn(B, Lq, D).astype(np.float32)
    k = rng.randn(B, Lk, D).astype(np.float32)
    v = rng.randn(B, Lk, D).astype(np.float32)
    want = np.asarray(
        pallas_attn.fused_attention_heads(*_j(q, k, v), H, interpret=True)
    )
    got = _counts_unchanged(lambda: ops.fused_attention_heads(*_t(q, k, v), H))
    assert got.shape == (B, Lq, D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _block_args(rng, B, L, D, collapsed):
    x = _rows(rng, B * L, D, collapsed).reshape(B, L, D)
    g = (rng.rand(D) + 0.5).astype(np.float32)
    b = (rng.randn(D) * 0.1).astype(np.float32)
    ws = [(rng.randn(D, D) * 0.08).astype(np.float32) for _ in range(4)]
    bs = [(rng.randn(D) * 0.05).astype(np.float32) for _ in range(4)]
    return [x, g, b, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], ws[3], bs[3]]


@pytest.mark.parametrize("collapsed", [False, True])
def test_fused_attention_block_ln_matches_pallas(collapsed):
    B, L, D, H = 2, 24, 64, 4
    args = _block_args(np.random.RandomState(1), B, L, D, collapsed)
    want = np.asarray(
        pallas_attn.fused_attention_block_ln(*_j(*args), H, interpret=True)
    )
    got = _counts_unchanged(lambda: ops.fused_attention_block_ln(*_t(*args), H))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fused_attention_block_ln_packed_matches_pallas():
    """The packed entry as the models call it: the three projections as one
    torch-layout (3D, D) weight passed ``.t()``, the out-projection too."""
    B, L, D, H = 2, 24, 64, 4
    args = _block_args(np.random.RandomState(5), B, L, D, False)
    want = np.asarray(
        pallas_attn.fused_attention_block_ln(*_j(*args), H, interpret=True)
    )
    x, g, b, wq, bq, wk, bk, wv, bv, wo, bo = _t(*args)
    w_in = torch.cat([wq.t(), wk.t(), wv.t()]).contiguous()  # (3D, D)
    got = _counts_unchanged(lambda: ops.fused_attention_block_ln_packed(
        x, g, b, w_in.t(), torch.cat([bq, bk, bv]),
        wo.t().contiguous().t(), bo, H,
    ))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _mlp_args(rng, N, D, Hd):
    return [
        (rng.randn(D, Hd) * 0.1).astype(np.float32),
        (rng.randn(Hd) * 0.05).astype(np.float32),
        (rng.randn(Hd, D) * 0.1).astype(np.float32),
        (rng.randn(D) * 0.05).astype(np.float32),
    ]


@pytest.mark.parametrize("collapsed", [False, True])
def test_fused_mlp_ln_matches_pallas(collapsed):
    rng = np.random.RandomState(2)
    N, D, Hd = 16, 64, 256
    x = _rows(rng, N, D, collapsed)
    g = (rng.rand(D) + 0.5).astype(np.float32)
    b = (rng.randn(D) * 0.1).astype(np.float32)
    w = _mlp_args(rng, N, D, Hd)
    want = np.asarray(pallas_mlp.fused_mlp_ln(*_j(x, g, b, *w), interpret=True))
    got = _counts_unchanged(lambda: ops.fused_mlp_ln(*_t(x, g, b, *w)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("N,D,Hd", [(96, 64, 128), (40, 48, 192)])
def test_fused_mlp_matches_pallas(N, D, Hd):
    rng = np.random.RandomState(3)
    x = rng.randn(N, D).astype(np.float32)
    w = _mlp_args(rng, N, D, Hd)
    want = np.asarray(pallas_mlp.fused_mlp(*_j(x, *w), interpret=True))
    got = _counts_unchanged(lambda: ops.fused_mlp(*_t(x, *w)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("eps,other", [(1e-6, 1e-5), (1e-5, 1e-6)])
def test_layer_norm_matches_flax_at_collapsed_variance(eps, other):
    """The shared LayerNorm (ViT eps 1e-6, decoder eps 1e-5) equals flax's
    fast-variance LayerNorm where a wrong eps is an O(1) error."""
    import flax.linen as nn

    D = 64
    x = _rows(np.random.RandomState(4), 8, D, collapsed=True)
    p = {"params": {"scale": np.ones(D, np.float32),
                    "bias": np.zeros(D, np.float32)}}
    want = np.asarray(nn.LayerNorm(epsilon=eps).apply(p, jnp.asarray(x)))
    wrong = np.asarray(nn.LayerNorm(epsilon=other).apply(p, jnp.asarray(x)))
    assert np.abs(want - wrong).max() > 0.1
    g, b = _t(p["params"]["scale"], p["params"]["bias"])
    got = ops.layer_norm(torch.from_numpy(x), g, b, eps).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_non_cpu_non_cuda_tensors_raise():
    """A tensor off the CPU takes the kernel or raises: no plain fallback."""
    x = torch.empty(2, 16, 32, device="meta")
    with pytest.raises(ValueError, match="needs CUDA"):
        ops.fused_attention_heads(x, x, x, 4)
    w = torch.empty(32, 64, device="meta")
    with pytest.raises(ValueError, match="needs CUDA"):
        ops.fused_mlp(x[0], w, w[0], w.t(), w[:, 0])
