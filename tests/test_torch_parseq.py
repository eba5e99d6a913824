"""The port's PARSeq against the JAX package's on the same weights: the JAX
seeded init carried across by ``state_dict_from_jax``.  Small config
(D=48, 4 heads, depth 2, 32x48 canvas, 24 tokens, 6-char labels), CPU,
f32, the JAX int8 K/V cache pinned off (the port has none).

Probs agree to atol 2e-4 (f32 summation order through 2 encoder blocks,
the decoder and a softmax); greedy ids agree exactly."""

import jax
import numpy as np
import pytest
import torch

from test_parseq_torch_parity import small_cfg
from yomitoku_tpu.models.parseq import PARSeq as JaxPARSeq
from yomitoku_tpu.models.weights_convert import convert_parseq
from yomitoku_tpu_torch.models.parseq import PARSeq
from yomitoku_tpu_torch.weights import state_dict_from_jax


_PARAMS = {}  # JAX seed-0 params per decoder depth (init compiles once)


def _pair(monkeypatch, dec_depth=1, **overrides):
    monkeypatch.setenv("YOMITOKU_TPU_INT8_KV", "0")
    cfg = small_cfg(dec_depth=dec_depth)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    jm = JaxPARSeq(cfg)
    assert not jm.int8_kv
    if dec_depth not in _PARAMS:
        _PARAMS[dec_depth] = jm.init_params(0)
    jm.params = _PARAMS[dec_depth]
    port = PARSeq(cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(jm.params, port))
    return jm, port


def _images(seed, n=4):
    return (np.random.RandomState(seed).rand(n, 32, 48, 3) * 2 - 1).astype(np.float32)


@pytest.mark.parametrize("decode_ar", [1, 0])
@pytest.mark.parametrize("refine_iters", [0, 1])
def test_parseq_matches_jax(monkeypatch, refine_iters, decode_ar):
    jm, port = _pair(monkeypatch, refine_iters=refine_iters, decode_ar=decode_ar)
    x = _images(refine_iters + 2 * decode_ar)
    want = jm.forward_probs(x)
    got = port.forward_probs(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 7, 22)
    np.testing.assert_allclose(got, want, atol=2e-4)
    jids = want.argmax(-1)
    np.testing.assert_array_equal(got.argmax(-1), jids)
    ids, probs = port.forward_tokens(x)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(
        probs, np.take_along_axis(want, jids[..., None], -1)[..., 0], atol=2e-4
    )


@pytest.mark.parametrize("refine_iters", [0, 1])
def test_parseq_ar_state_reused_across_batches(monkeypatch, refine_iters):
    """The AR loop keeps its buffers per (batch size, memory length) and
    resets them in place: a batch after another of the same size decodes
    as on a fresh model, and a second batch size gets its own state."""
    jm, port = _pair(monkeypatch, refine_iters=refine_iters)
    for seed, n in ((11, 4), (12, 4), (13, 2), (11, 4)):
        x = _images(seed, n)
        want = jm.forward_probs(x)
        got = port.forward_probs(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=2e-4)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert sorted(port._ar_loops) == [(2, 24), (4, 24)]  # 4 x 6 patches


def test_parseq_uncached_decoder_and_uint8_input(monkeypatch):
    """Depth-2 decoder (the AR loop re-decodes the whole content stream)
    on uint8 crops normalised on the device."""
    jm, port = _pair(monkeypatch, dec_depth=2)
    u8 = np.random.RandomState(7).randint(0, 256, (3, 32, 48, 3), np.uint8)
    jids, jprobs = jm.forward_tokens(u8)
    ids, probs = port.forward_tokens(u8)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(probs, jprobs, atol=2e-4)


def test_state_dict_round_trip(monkeypatch):
    """convert_parseq(port state_dict) gives back the JAX params exactly."""
    jm, port = _pair(monkeypatch)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = convert_parseq(sd, jm)
    leaves = jax.tree_util.tree_leaves_with_path(jm.params)
    back_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(back_leaves) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(back_leaves[path], leaf)


def test_token_layout():
    port = PARSeq(small_cfg(), device="cpu")
    assert (port.eos_id, port.bos_id, port.pad_id) == (0, 22, 23)
    assert port.head.out_features == port.num_tokens - 2
