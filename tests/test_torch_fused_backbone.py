"""The port's fused-backbone configuration (``fused_bottleneck``,
``fused_identity_stage``) and its two attention kernels without a model
caller (``fused_attention``, ``fused_attention_block``) against the JAX
package, on the CPU: each wrapper takes its plain version on CPU tensors,
the JAX side runs its Pallas kernel in interpret mode, or its jnp
reference where the Pallas test of that kernel is marked slow.  The models
run with the port's gates forced open (they open only for CUDA tensors)
against the JAX models' default path on the same weights.

Tolerances (f32 on both sides, summation order only): the bottleneck at
rtol 1e-3 / atol 3e-4 and the stage at 2e-4, as the JAX package's own
kernel tests; attention 2e-5, the attention block 5e-5; the DBNet map at
1e-4; RT-DETRv2 logits and boxes within 1e-3 of the largest value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yomitoku_tpu.config import load_config, structured
from yomitoku_tpu.configs import (
    LayoutParserRTDETRv2V2Config,
    TextDetectorDBNetV2_1Config,
)
from yomitoku_tpu.models.dbnet import DBNet as JaxDBNet
from yomitoku_tpu.models.rtdetr import RTDETRv2 as JaxRTDETRv2
from yomitoku_tpu.models.weights_convert import convert_dbnet, convert_rtdetr
from yomitoku_tpu.ops.pallas import bottleneck as jax_bottleneck
from yomitoku_tpu.ops.pallas import flash_attention as jax_attention
from yomitoku_tpu_torch import ops
from yomitoku_tpu_torch.models.dbnet import DBNet
from yomitoku_tpu_torch.models.layers import presnet, resnet
from yomitoku_tpu_torch.models.rtdetr import RTDETRv2


def randomize_bn(model, seed=7):
    """FrozenBN weight/bias/mean/var drawn from a seed (numpy), as
    tests/test_torch_dbnet.py draws them."""
    rng = np.random.RandomState(seed)
    for m in model.modules():
        if isinstance(m, resnet.FrozenBatchNorm):
            n = m.running_mean.shape[0]
            for buf, value in ((m.weight, 1 + 0.1 * rng.randn(n)),
                               (m.bias, 0.1 * rng.randn(n)),
                               (m.running_mean, 0.1 * rng.randn(n)),
                               (m.running_var, rng.rand(n) + 0.5)):
                buf.copy_(torch.from_numpy(value.astype(np.float32)))


def numpy_state(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, rel=1e-3):
    """max |got - want| within ``rel`` of the largest value of want."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, limit = np.abs(got - want).max(), rel * np.abs(want).max()
    assert err <= limit, (err, limit)


def _bottleneck_params(rng, Cin, Cm, Cout, down):
    """tests/test_bottleneck_kernel.py's parameter draw."""
    p = dict(
        w1=(rng.randn(Cin, Cm) * 0.1).astype(np.float32),
        b1=(rng.randn(Cm) * 0.05).astype(np.float32),
        w2=(rng.randn(9, Cm, Cm) * 0.05).astype(np.float32),
        b2=(rng.randn(Cm) * 0.05).astype(np.float32),
        w3=(rng.randn(Cm, Cout) * 0.1).astype(np.float32),
        b3=(rng.randn(Cout) * 0.05).astype(np.float32),
    )
    if down:
        p["wd"] = (rng.randn(Cin, Cout) * 0.1).astype(np.float32)
        p["bd"] = (rng.randn(Cout) * 0.05).astype(np.float32)
    return p


# ------------------------------------------------------------------ kernels


def test_fold_bn_matches_jax():
    rng = np.random.RandomState(0)
    C = 16
    scale, var = rng.rand(C) + 0.5, rng.rand(C) + 0.5
    bias, mean = rng.randn(C), rng.randn(C)
    args = [a.astype(np.float32) for a in (scale, bias, mean, var)]
    want = jax_bottleneck.fold_bn(*map(jnp.asarray, args))
    got = ops.fold_bn(*map(t, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize(
    "H,W,Cin,Cm,Cout,d,down",
    [
        (16, 24, 32, 8, 32, 1, False),   # identity shortcut
        (16, 24, 32, 8, 64, 1, True),    # projection shortcut
        (24, 16, 16, 8, 16, 2, False),   # dilation 2 (DBNet layer4)
        (48, 16, 16, 8, 16, 1, False),   # several strips
        (13, 10, 16, 8, 32, 2, True),    # odd sizes, dilation 2, projection
    ],
)
def test_fused_bottleneck_matches_pallas(H, W, Cin, Cm, Cout, d, down):
    rng = np.random.RandomState(H + Cout + d)
    x = rng.randn(2, H, W, Cin).astype(np.float32)
    p = _bottleneck_params(rng, Cin, Cm, Cout, down)
    want = jax_bottleneck.fused_bottleneck(
        jnp.asarray(x), dilation=d, interpret=True,
        **{k: jnp.asarray(v) for k, v in p.items()})
    got = ops.fused_bottleneck(t(x), dilation=d, **{k: t(v) for k, v in p.items()})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=3e-4)


def test_h1_is_zero_padded_not_x():
    """The 3x3 pads h1 = relu(x w1 + b1) with zeros.  Padding x instead
    would give relu(b1) on the border taps: with b1 > 0 that is a
    different function, at every edge of the page."""
    rng = np.random.RandomState(3)
    p = _bottleneck_params(rng, 16, 8, 16, False)
    p["b1"] = np.abs(p["b1"]) + 0.5
    x = rng.randn(1, 7, 9, 16).astype(np.float32)
    got = ops.bottleneck_reference(t(x), **{k: t(v) for k, v in p.items()},
                                   dilation=2).numpy()
    want = np.asarray(jax_bottleneck.bottleneck_reference(
        jnp.asarray(x), **{k: jnp.asarray(v) for k, v in p.items()}, dilation=2))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    xp = np.pad(x, ((0, 0), (2, 2), (2, 2), (0, 0)))
    wrong = np.asarray(jax_bottleneck.bottleneck_reference(
        jnp.asarray(xp), **{k: jnp.asarray(v) for k, v in p.items()},
        dilation=2))[:, 2:-2, 2:-2]
    edge = np.abs(wrong - want)
    assert edge[:, 0].max() > 1e-2 and edge[:, -1].max() > 1e-2
    assert edge[:, :, 0].max() > 1e-2 and edge[:, :, -1].max() > 1e-2


def _stage_weights(rng, N, C, Cm):
    """tests/test_stage_kernel.py's weight draw."""
    s = 1.0 / np.sqrt(C)
    return [(rng.randn(*shape) * scale).astype(np.float32) for shape, scale in (
        ((N, C, Cm), s), ((N, Cm), 0.1), ((N, 9, Cm, Cm), s), ((N, Cm), 0.1),
        ((N, Cm, C), s), ((N, C), 0.1))]


@pytest.mark.parametrize("N,d,H,W", [(2, 1, 32, 16), (3, 1, 24, 8), (2, 2, 32, 8)])
def test_fused_identity_stage_matches_jax_blocks(N, d, H, W):
    """Against N composed JAX reference blocks (the Pallas stage's own test
    is marked slow)."""
    C, Cm = 128, 32
    rng = np.random.RandomState(0)
    ws = _stage_weights(rng, N, C, Cm)
    x = rng.randn(2, H, W, C).astype(np.float32)
    want = jnp.asarray(x)
    for j in range(N):
        want = jax_bottleneck.bottleneck_reference(
            want, *(jnp.asarray(w[j]) for w in ws), dilation=d)
    got = ops.fused_identity_stage(t(x), *map(t, ws), dilation=d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize(
    "B,H,Lq,Lk,Dh",
    [(1, 8, 300, 300, 32), (2, 2, 101, 400, 64), (1, 1, 128, 128, 128),
     (1, 2, 7, 5, 16)],
)
def test_fused_attention_matches_pallas(B, H, Lq, Lk, Dh):
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(B, H, n, Dh).astype(np.float32) for n in (Lq, Lk, Lk))
    want = jax_attention.fused_attention(*map(jnp.asarray, (q, k, v)), interpret=True)
    got = ops.fused_attention(t(q), t(k), t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    got = ops.fused_attention(t(q), t(k), t(v), scale=0.5)
    want = jax_attention.fused_attention(*map(jnp.asarray, (q, k, v)), scale=0.5,
                                         interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,L,D,H", [(2, 48, 96, 3), (1, 40, 64, 8)])
def test_fused_attention_block_matches_pallas(B, L, D, H):
    rng = np.random.RandomState(3)
    x = rng.randn(B, L, D).astype(np.float32)
    args = [x]
    for _ in range(4):
        args += [(rng.randn(D, D) * 0.1).astype(np.float32),
                 (rng.randn(D) * 0.02).astype(np.float32)]
    want = jax_attention.fused_attention_block(*map(jnp.asarray, args), H,
                                               interpret=True)
    got = ops.fused_attention_block(*map(t, args), H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=5e-5)


def test_bf16_plain_versions_round_where_the_kernels_do():
    """bf16 in, bf16 out: the plain bottleneck rounds h1 and h2 to bf16, so
    it differs from its f32 run on the same bf16 values by bf16 rounding
    only (a few parts in 1e3 of the largest value)."""
    rng = np.random.RandomState(4)
    p = {k: t(v).bfloat16() for k, v in _bottleneck_params(rng, 16, 8, 32, True).items()}
    x = t(rng.randn(1, 9, 11, 16).astype(np.float32)).bfloat16()
    got = ops.fused_bottleneck(x, dilation=2, **p)
    want = ops.fused_bottleneck(x.float(), dilation=2, **{k: v.float() for k, v in p.items()})
    assert got.dtype == torch.bfloat16
    err = (got.float() - want).abs().max().item()
    assert 0 < err <= 2e-2 * want.abs().max().item()


# ------------------------------------------------------------------ models


def _open_gates(monkeypatch):
    """The port's fused-backbone gates opened for CPU tensors (stride 1
    still required)."""
    monkeypatch.setattr(resnet, "use_fused_bottleneck",
                        lambda x, stride, *a: stride == 1)
    monkeypatch.setattr(resnet, "use_fused_stage", lambda x, n, *a: n >= 2)
    monkeypatch.setattr(resnet, "fused_backbone", lambda x: True)


def _count_calls(monkeypatch):
    """Wrap the kernel wrappers where the layers call them -> call counts."""
    calls = {"fused_bottleneck": 0, "fused_identity_stage": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for mod, name in ((resnet, "fused_bottleneck"), (resnet, "fused_identity_stage"),
                      (presnet, "fused_bottleneck")):
        monkeypatch.setattr(mod, name, counted(name, getattr(mod, name)))
    return calls


def test_gates_follow_the_switches_and_the_device(monkeypatch):
    x = torch.zeros(1, 8, 4, 4)
    for var in ("YOMITOKU_TPU_FUSED_BOTTLENECK", "YOMITOKU_TPU_FUSED_STAGE"):
        monkeypatch.delenv(var, raising=False)
    assert not resnet.use_fused_bottleneck(x, 1, 8, 2, 8, 1)
    monkeypatch.setenv("YOMITOKU_TPU_FUSED_BOTTLENECK", "1")
    monkeypatch.setenv("YOMITOKU_TPU_FUSED_STAGE", "1")
    # open only for CUDA tensors: a CPU tensor keeps the library path
    assert not resnet.use_fused_bottleneck(x, 1, 8, 2, 8, 1)
    assert not resnet.use_fused_stage(x, 3, 8, 2, 1)
    assert not resnet.fused_backbone(x)

    class Cuda:
        is_cuda = True

    assert resnet.use_fused_bottleneck(Cuda(), 1, 8, 2, 8, 2)
    assert not resnet.use_fused_bottleneck(Cuda(), 2, 8, 2, 8, 1)
    assert resnet.use_fused_stage(Cuda(), 2, 8, 2, 2)
    assert not resnet.use_fused_stage(Cuda(), 1, 8, 2, 1)
    assert resnet.fused_backbone(Cuda())
    monkeypatch.setenv("YOMITOKU_TPU_FUSED_BOTTLENECK", "0")
    assert not resnet.use_fused_bottleneck(Cuda(), 1, 8, 2, 8, 1)


@pytest.fixture(scope="module")
def dbnet_pair():
    cfg = structured(TextDetectorDBNetV2_1Config)
    port = DBNet(cfg, device="cpu")
    randomize_bn(port)
    jm = JaxDBNet(cfg)
    jm.params = convert_dbnet(numpy_state(port), jm)
    return jm, port


def test_dbnet_fused_matches_jax(dbnet_pair, monkeypatch):
    """DBNet with both gates open (2 fused blocks: layer1_0, layer4_0; 4
    fused stages) against the JAX model's default path."""
    jm, port = dbnet_pair
    x = np.random.RandomState(0).rand(1, 64, 96, 3).astype(np.float32)
    want = jm.forward_binary(x)
    _open_gates(monkeypatch)
    calls = _count_calls(monkeypatch)
    got = port.forward_binary(x)
    assert calls == {"fused_bottleneck": 2, "fused_identity_stage": 4}
    assert got.shape == want.shape == (1, 64, 96)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_dbnet_features_fused_match_unfused(dbnet_pair, monkeypatch):
    """Each stage's features, fused (stride-1 blocks only, stages off, then
    both) against the port's library path, f32."""
    _, port = dbnet_pair
    x = t(np.random.RandomState(1).rand(2, 3, 96, 64).astype(np.float32))
    want = port.backbone(x)
    _open_gates(monkeypatch)
    for stage in (False, True):
        monkeypatch.setattr(resnet, "use_fused_stage", lambda x, n, *a: stage)
        got = port.backbone(x)
        for name, w in want.items():
            assert got[name].is_contiguous(memory_format=torch.channels_last)
            close(got[name].numpy(), w.numpy(), 1e-4)


@pytest.fixture(scope="module")
def rtdetr_pair():
    cfg = load_config(LayoutParserRTDETRv2V2Config, "tests/yaml/layout_small.yaml")
    port = RTDETRv2(cfg, device="cpu")
    randomize_bn(port)
    jm = JaxRTDETRv2(cfg)
    jm.params = convert_rtdetr(numpy_state(port), jm)
    return jm, port


def test_rtdetr_fused_matches_jax(rtdetr_pair, monkeypatch):
    """RT-DETRv2 with the bottleneck gate open (13 fused PResNet blocks)
    against the JAX model's default path, on the input whose top-k
    selection tests/test_torch_rtdetr.py shows to be free of near-ties."""
    jm, port = rtdetr_pair
    u8 = np.random.RandomState(2).randint(0, 256, (2, 128, 128, 3), np.uint8)
    x = u8.astype(np.float32) * np.float32(1.0 / 255.0)
    want = jax.jit(jm.core.apply)(jm.params, jnp.asarray(x))
    _open_gates(monkeypatch)
    calls = _count_calls(monkeypatch)
    got = port(u8)
    assert calls == {"fused_bottleneck": 13, "fused_identity_stage": 0}
    close(got["pred_logits"].numpy(), want["pred_logits"])
    close(got["pred_boxes"].numpy(), want["pred_boxes"])


def test_stride2_blocks_keep_the_library_path(rtdetr_pair, monkeypatch):
    """With the real gate (stride 1 only, CUDA faked) PResNet's three
    stride-2 blocks never reach the kernel."""
    _, port = rtdetr_pair
    seen = []
    monkeypatch.setattr(resnet, "use_fused_bottleneck",
                        lambda x, stride, *a: seen.append(stride) or stride == 1)
    monkeypatch.setattr(resnet, "fused_backbone", lambda x: True)
    calls = _count_calls(monkeypatch)
    port.backbone(t(np.random.RandomState(5).rand(1, 3, 64, 64).astype(np.float32)))
    assert sorted(seen) == [1] * 13 + [2] * 3
    assert calls["fused_bottleneck"] == 13


def test_load_state_dict_refolds(monkeypatch):
    """Folded weights are kept per weight version: a second forward reuses
    them, a state_dict load (in-place copies) folds anew, and the fused
    block then matches the library path under the new weights."""
    torch.manual_seed(0)
    block = resnet.Bottleneck(16, 4, 1, 2, downsample=True)
    other = resnet.Bottleneck(16, 4, 1, 2, downsample=True)
    randomize_bn(block, seed=1)
    randomize_bn(other, seed=2)
    first = block.folded(torch.float32)
    assert block.folded(torch.float32) is first
    block.load_state_dict(other.state_dict())
    again = block.folded(torch.float32)
    assert again is not first
    assert not torch.equal(again[0], first[0])
    x = t(np.random.RandomState(6).rand(2, 16, 9, 7).astype(np.float32))
    want = other(x)
    monkeypatch.setattr(resnet, "use_fused_bottleneck", lambda x, *a: True)
    close(block(x).detach().numpy(), want.detach().numpy(), 1e-5)


def test_stage_weights_refold(monkeypatch):
    """The stacked stage weights follow a load into any one of the blocks."""
    blocks = [resnet.Bottleneck(16, 4) for _ in range(3)]
    for i, b in enumerate(blocks):
        randomize_bn(b, seed=10 + i)
    first = resnet.stage_weights(blocks, torch.float32)
    assert resnet.stage_weights(blocks, torch.float32) is first
    with torch.no_grad():
        blocks[2].bn2.running_var.mul_(2.0)
    again = resnet.stage_weights(blocks, torch.float32)
    assert torch.equal(again[0], first[0]) and not torch.equal(again[2], first[2])
    x = t(np.random.RandomState(7).rand(1, 16, 6, 5).astype(np.float32))
    want = x
    for b in blocks:
        want = b(want)
    got = ops.fused_identity_stage(x.permute(0, 2, 3, 1), *again).permute(0, 3, 1, 2)
    close(got.detach().numpy(), want.detach().numpy(), 1e-5)
