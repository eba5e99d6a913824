"""The port's ``ms_deformable_attention`` on CPU tensors, where it runs its
plain version, against the JAX package's gather
(``deformable_attention_core``) and its Pallas kernel in interpret mode,
on the same seeded numpy inputs: levels (8, 8), (4, 4), (2, 2), some
locations outside [0, 1] (``loc * 1.3 - 0.15``) so that taps fall off the
map, uneven points per level, and Lq above the Pallas kernel's 512-query
tile.

Tolerance atol = rtol = 1e-5 against the gather and the Pallas kernel:
all compute in f32 and differ only in the order of the bilinear and
attention products (|out| <= ~3).  The CUDA kernel itself is held against
this plain version on the card (chip_smoke.py, tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yomitoku_tpu.models.layers.rtdetr_decoder import deformable_attention_core
from yomitoku_tpu.ops.pallas.deformable_attention import (
    ms_deformable_attention as pallas_ms_deformable_attention,
)
from yomitoku_tpu_torch import ops

SHAPES = ((8, 8), (4, 4), (2, 2))
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(B, Lq, nh, c, points, seed, oob=True):
    rng = np.random.RandomState(seed)
    L = sum(h * w for h, w in SHAPES)
    P = sum(points)
    value = rng.randn(B, L, nh, c).astype(np.float32)
    loc = rng.rand(B, Lq, nh, P, 2).astype(np.float32)
    if oob:
        loc = loc * 1.3 - 0.15
    att = rng.rand(B, Lq, nh, P).astype(np.float32)
    att = att / att.sum(-1, keepdims=True)
    return value, loc, att


def _port(value, loc, att, points):
    before = dict(ops.launches)
    out = ops.ms_deformable_attention(
        *map(torch.from_numpy, (value, loc, att)), SHAPES, points)
    assert ops.launches == before, "a CPU call must not count as a launch"
    return out.numpy()


@pytest.mark.parametrize(
    "B,Lq,nh,c,points,oob",
    [
        (2, 40, 2, 32, (4, 4, 4), True),
        (1, 33, 8, 32, (4, 2, 1), True),   # uneven points per level
        (2, 17, 4, 16, (3, 1, 2), False),  # all locations inside the map
        (1, 600, 2, 32, (4, 4, 4), True),  # Lq above the 512-query tile
        (1, 19, 2, 24, (4, 4, 4), True),   # c = 24: 48-byte bf16 rows
        (2, 23, 2, 32, (16, 12, 8), True),  # 36 points: more than 32
        (1, 9, 3, 24, (16, 12, 8), True),
    ],
)
def test_matches_jax_gather(B, Lq, nh, c, points, oob):
    value, loc, att = _inputs(B, Lq, nh, c, points, seed=Lq, oob=oob)
    want = np.asarray(deformable_attention_core(
        jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(att),
        list(points)))
    got = _port(value, loc, att, points)
    assert got.shape == (B, Lq, nh * c)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("Lq,points", [(40, (4, 2, 1)), (24, (4, 4, 4))])
def test_matches_pallas_interpret(Lq, points):
    value, loc, att = _inputs(1, Lq, 2, 32, points, seed=3)
    want = np.asarray(pallas_ms_deformable_attention(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(att), SHAPES,
        points, interpret=True))
    np.testing.assert_allclose(_port(value, loc, att, points), want, **TOL)


@pytest.mark.parametrize("c,points", [(24, (4, 4, 4)), (32, (16, 12, 8)), (24, (16, 12, 8))])
def test_more_points_and_other_widths_match_pallas_interpret(c, points):
    """The plain version at the widths and point counts the kernel's routes
    and chunks cover beyond RT-DETR's: c = 24, more than 32 points."""
    value, loc, att = _inputs(1, 21, 2, c, points, seed=c + sum(points))
    want = np.asarray(pallas_ms_deformable_attention(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(att), SHAPES,
        points, interpret=True))
    got = _port(value, loc, att, points)
    assert got.shape == (1, 21, 2 * c)
    np.testing.assert_allclose(got, want, **TOL)


def test_bf16_inputs_upcast_and_round_once():
    """bf16 value, locations and weights: f32 arithmetic on the bf16
    values, one rounding of the result to bf16."""
    value, loc, att = _inputs(1, 20, 2, 32, (4, 4, 4), seed=9)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (value, loc, att)]
    got = ops.ms_deformable_attention(*args, SHAPES, (4, 4, 4))
    want = ops.ms_deformable_attention(*[a.float() for a in args], SHAPES, (4, 4, 4))
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)


def test_shapes_that_disagree_raise():
    value, loc, att = map(torch.from_numpy, _inputs(1, 8, 2, 32, (4, 4, 4), seed=1))
    with pytest.raises(ValueError, match="do not cover"):
        ops.ms_deformable_attention(value, loc, att, ((8, 8), (4, 4)), (4, 4, 4))
    with pytest.raises(ValueError, match="do not"):
        ops.ms_deformable_attention(value, loc, att, SHAPES, (4, 4, 3))


def test_non_cpu_non_cuda_tensors_raise():
    """A tensor off the CPU takes the kernel or raises: no plain fallback."""
    value = torch.empty(1, 84, 2, 32, device="meta")
    loc = torch.empty(1, 8, 2, 12, 2, device="meta")
    att = torch.empty(1, 8, 2, 12, device="meta")
    with pytest.raises(ValueError, match="needs CUDA"):
        ops.ms_deformable_attention(value, loc, att, SHAPES, (4, 4, 4))
