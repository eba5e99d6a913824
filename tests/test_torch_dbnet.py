"""The port's DBNet (dbnetv2_1, ResNet-50 with dilation) against the JAX
package's on the same weights: the port's seeded init with randomised
FrozenBN statistics (fresh ones, mean 0 / var 1, would hide a mean/var
mix-up), given to the JAX model through ``convert_dbnet``; the way back,
``state_dict_from_jax``, must restore the state_dict exactly.  64x96
input, CPU, f32.  The probability map agrees to atol 2e-4; the uint8 wire
map, which rounds prob * 255, within one quantum."""

import jax
import numpy as np
import pytest
import torch

from yomitoku_tpu.config import structured
from yomitoku_tpu.configs import TextDetectorDBNetV2_1Config
from yomitoku_tpu.models.dbnet import DBNet as JaxDBNet
from yomitoku_tpu.models.weights_convert import convert_dbnet
from yomitoku_tpu_torch.models.dbnet import DBNet
from yomitoku_tpu_torch.models.layers.resnet import FrozenBatchNorm
from yomitoku_tpu_torch.weights import state_dict_from_jax


def randomize_bn(model, seed=7):
    """FrozenBN weight/bias/mean/var drawn from a seed (numpy)."""
    rng = np.random.RandomState(seed)
    for m in model.modules():
        if isinstance(m, FrozenBatchNorm):
            n = m.running_mean.shape[0]
            for buf, value in ((m.weight, 1 + 0.1 * rng.randn(n)),
                               (m.bias, 0.1 * rng.randn(n)),
                               (m.running_mean, 0.1 * rng.randn(n)),
                               (m.running_var, rng.rand(n) + 0.5)):
                buf.copy_(torch.from_numpy(value.astype(np.float32)))


def numpy_state(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def pair():
    cfg = structured(TextDetectorDBNetV2_1Config)
    port = DBNet(cfg, device="cpu")
    randomize_bn(port)
    jm = JaxDBNet(cfg)
    jm.params = convert_dbnet(numpy_state(port), jm)
    return jm, port


def test_dbnet_map_matches_jax(pair):
    jm, port = pair
    x = np.random.RandomState(0).rand(1, 64, 96, 3).astype(np.float32)
    want = jm.forward_binary(x)
    got = port.forward_binary(x)
    assert got.shape == want.shape == (1, 64, 96)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_dbnet_u8_wire_map_within_one_quantum(pair):
    jm, port = pair
    u8 = np.random.RandomState(1).randint(0, 256, (1, 64, 96, 3), np.uint8)
    want = jm.forward_binary_u8(u8, as_u8=True)
    got = port.forward_binary_u8(u8)
    assert got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_state_dict_round_trip(pair):
    """state_dict_from_jax inverts convert_dbnet exactly, both ways."""
    jm, port = pair
    sd = numpy_state(port)
    back = state_dict_from_jax(jm.params, port)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    again = convert_dbnet({k: v.numpy() for k, v in back.items()}, jm)
    leaves = jax.tree_util.tree_leaves_with_path(jm.params)
    again_leaves = dict(jax.tree_util.tree_leaves_with_path(again))
    assert len(again_leaves) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(again_leaves[path], leaf)
