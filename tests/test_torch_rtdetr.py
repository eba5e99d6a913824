"""The port's RT-DETRv2 (PResNet-50-d, HybridEncoder, deformable decoder)
against the JAX package's on the same weights: the port's seeded init with
randomised FrozenBN statistics (fresh ones, mean 0 / var 1, would hide a
mean/var mix-up), given to the JAX model through ``convert_rtdetr``; the
way back, ``state_dict_from_jax``, must restore the state_dict exactly.
Config tests/yaml/layout_small.yaml (the layout parser's full widths and
6 decoder layers at 128x128 and 20 queries), CPU, f32.

Tolerances: each output within 1e-4 of its largest value plus 1e-5 (f32
on both sides; summation order only, through ~60 layers).  Top-k query
selection is compared as sets, and each test first checks that the gap
between the k-th and (k+1)-th selection score is above 1e-3, far above the
two sides' score difference (~1e-6), so that no near-tie can reorder it."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yomitoku_tpu.config import load_config
from yomitoku_tpu.configs import LayoutParserRTDETRv2V2Config
from yomitoku_tpu.models.layers import rtdetr_decoder as jax_decoder
from yomitoku_tpu.models.layers import rtdetr_encoder as jax_encoder
from yomitoku_tpu.models.layers.presnet import PResNet as JaxPResNet
from yomitoku_tpu.models.rtdetr import RTDETRv2 as JaxRTDETRv2
from yomitoku_tpu.models.weights_convert import convert_rtdetr
from yomitoku_tpu_torch.models.layers import rtdetr_decoder, rtdetr_encoder
from yomitoku_tpu_torch.models.layers.resnet import FrozenBatchNorm
from yomitoku_tpu_torch.models.rtdetr import RTDETRv2
from yomitoku_tpu_torch.weights import state_dict_from_jax

CFG = "tests/yaml/layout_small.yaml"
GAP = 1e-3


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


def close(got, want, rel=1e-4, add=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    limit = rel * np.abs(want).max() + add
    assert err <= limit, (err, limit)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


@pytest.fixture(scope="module")
def pair():
    cfg = load_config(LayoutParserRTDETRv2V2Config, CFG)
    port = RTDETRv2(cfg, device="cpu")
    randomize_bn(port)
    jm = JaxRTDETRv2(cfg)
    jm.params = convert_rtdetr(numpy_state(port), jm)
    return jm, port


def test_presnet_matches_jax(pair):
    jm, port = pair
    x = np.random.RandomState(0).rand(2, 128, 128, 3).astype(np.float32)
    want = JaxPResNet(return_idx=(1, 2, 3)).apply(
        {"params": jm.params["params"]["backbone"]}, jnp.asarray(x))
    got = port.backbone(nchw(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        close(g.permute(0, 2, 3, 1).numpy(), w)


def test_hybrid_encoder_matches_jax(pair):
    jm, port = pair
    rng = np.random.RandomState(1)
    feats = [rng.randn(2, s, s, c).astype(np.float32)
             for s, c in ((16, 512), (8, 1024), (4, 2048))]
    want = jax_encoder.HybridEncoder().apply(
        {"params": jm.params["params"]["encoder"]}, [jnp.asarray(f) for f in feats])
    got = port.encoder([nchw(f) for f in feats])
    for g, w in zip(got, want):
        close(g.permute(0, 2, 3, 1).numpy(), w)


def test_rtdetr_matches_jax(pair):
    """The whole detector on uint8 images (scaled on the device): equal
    selected-query sets, then logits and boxes query by query."""
    jm, port = pair
    u8 = np.random.RandomState(2).randint(0, 256, (2, 128, 128, 3), np.uint8)
    x = u8.astype(np.float32) * np.float32(1.0 / 255.0)
    apply = jax.jit(partial(
        jm.core.apply, capture_intermediates=lambda m, _: m.name == "enc_score_head",
        mutable=["intermediates"]))
    want, state = apply(jm.params, jnp.asarray(x))
    jax_enc = np.asarray(
        state["intermediates"]["decoder"]["enc_score_head"]["__call__"][0])

    captured = {}
    hook = port.decoder.enc_score_head.register_forward_hook(
        lambda m, i, out: captured.__setitem__("enc", out.numpy()))
    try:
        got = port(u8)
    finally:
        hook.remove()
    k = port.decoder.num_queries
    for scores_j, scores_p in zip(jax_enc.max(-1), captured["enc"].max(-1)):
        order = np.argsort(-scores_p, kind="stable")
        assert scores_p[order[k - 1]] - scores_p[order[k]] > GAP
        assert set(order[:k]) == set(np.argsort(-scores_j, kind="stable")[:k])
        close(scores_p, scores_j)
    close(got["pred_logits"].numpy(), want["pred_logits"])
    close(got["pred_boxes"].numpy(), want["pred_boxes"])
    assert got["pred_logits"].shape == (2, k, 6)
    # uint8 scaled on the device == the same values given as float
    again = port(torch.from_numpy(x))
    torch.testing.assert_close(again["pred_boxes"], got["pred_boxes"], rtol=0, atol=0)


def test_state_dict_round_trip(pair):
    """state_dict_from_jax inverts convert_rtdetr exactly, both ways; the
    five score heads JAX does not hold keep the port's values."""
    jm, port = pair
    sd = numpy_state(port)
    back = state_dict_from_jax(jm.params, port)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    again = convert_rtdetr({k: v.numpy() for k, v in back.items()}, jm)
    leaves = jax.tree_util.tree_leaves_with_path(jm.params)
    again_leaves = dict(jax.tree_util.tree_leaves_with_path(again))
    assert len(again_leaves) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(again_leaves[path], leaf)


def test_reference_checkpoint_keys_load_strictly(pair):
    """A reference-layout state_dict loads strictly: all six score heads
    are parameters; the denoising embedding, the decoder's buffers and the
    BN counters are dropped; a missing parameter raises."""
    _, port = pair
    cfg = load_config(LayoutParserRTDETRv2V2Config, CFG)
    fresh = RTDETRv2(cfg, device="cpu")
    sd = {k: v + 0.5 for k, v in port.state_dict().items()}
    assert all(f"decoder.dec_score_head.{i}.weight" in sd for i in range(6))
    extra = {
        "decoder.denoising_class_embed.weight": torch.zeros(7, 256),
        "decoder.anchors": torch.zeros(1, 336, 4),
        "decoder.valid_mask": torch.ones(1, 336, 1),
        "decoder.decoder.layers.0.cross_attn.num_points_scale": torch.ones(12),
        "backbone.conv1.conv1_1.norm.num_batches_tracked": torch.tensor(3),
    }
    fresh.load_reference_state_dict({**sd, **extra})
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    del sd["decoder.dec_score_head.0.bias"]
    with pytest.raises(RuntimeError, match="dec_score_head.0.bias"):
        fresh.load_reference_state_dict(sd)


def _jax_linear(p):
    return (torch.from_numpy(np.asarray(p["kernel"]).T.copy()),
            torch.from_numpy(np.array(p["bias"])))


def _load_linear(module, p):
    w, b = _jax_linear(p)
    module.weight.copy_(w)
    module.bias.copy_(b)


def test_ms_deformable_attention_layer_matches_jax():
    """MSDeformableAttention with uneven points (4, 2, 1): offsets scaled
    by 1/n per level, by the reference box size and by 0.5."""
    d, nh, points, shapes = 64, 4, (4, 2, 1), ((8, 8), (4, 4), (2, 2))
    rng = np.random.RandomState(3)
    query = rng.randn(2, 12, d).astype(np.float32)
    ref = rng.uniform(0.1, 0.9, (2, 12, 1, 4)).astype(np.float32)
    value = rng.randn(2, 84, d).astype(np.float32)
    jmod = jax_decoder.MSDeformableAttention(d, nh, 3, points)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(query), jnp.asarray(ref),
                       jnp.asarray(value), shapes)
    want = jmod.apply(params, jnp.asarray(query), jnp.asarray(ref),
                      jnp.asarray(value), shapes)
    port = rtdetr_decoder.MSDeformableAttention(d, nh, 3, points)
    with torch.no_grad():
        for name in ("sampling_offsets", "attention_weights", "value_proj",
                     "output_proj"):
            _load_linear(getattr(port, name), params["params"][name])
        got = port(*map(torch.from_numpy, (query, ref, value)), shapes)
    close(got.numpy(), want)


def _collapsed(rng, n, d):
    """Tokens whose across-channel variance is ~1e-6, where LayerNorm's eps
    (1e-5 vs 1e-6) is an O(1) effect (the RT-DETR eps fault, 6ffced8)."""
    base = rng.rand(1, n, d).astype(np.float32)
    mean = base.mean(-1, keepdims=True)
    return (0.01 + 1e-3 * (base - mean)).astype(np.float32)


def test_aifi_matches_jax_at_collapsed_variance():
    """AIFI (post-LN, position on q and k only) with random weights on
    collapsed-variance tokens; and with attention and FFN zeroed, norm1
    must be the eps-1e-5 LayerNorm and not the eps-1e-6 one."""
    import flax.linen as nn

    d, n = 32, 8
    rng = np.random.RandomState(4)
    x = _collapsed(rng, n, d)
    pos = (0.1 * rng.randn(1, n, d)).astype(np.float32)
    jlayer = jax_encoder.AIFILayer(d_model=d, nhead=4, dim_feedforward=64)
    params = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(pos))
    p = jax.tree_util.tree_map(np.asarray, params)["params"]
    port = rtdetr_encoder.AIFILayer(d, 4, 64)
    with torch.no_grad():
        attn = p["self_attn"]
        qkv = [_jax_linear(attn[f"{c}_proj"]) for c in "qkv"]
        port.self_attn.in_proj_weight.copy_(torch.cat([w for w, _ in qkv]))
        port.self_attn.in_proj_bias.copy_(torch.cat([b for _, b in qkv]))
        _load_linear(port.self_attn.out_proj, attn["out_proj"])
        _load_linear(port.linear1, p["linear1"])
        _load_linear(port.linear2, p["linear2"])
        got = port(*map(torch.from_numpy, (x, pos)))
    close(got.numpy(), jlayer.apply(params, jnp.asarray(x), jnp.asarray(pos)))

    def flax_ln(v, eps):
        ln = {"params": {"scale": np.ones(d, np.float32),
                         "bias": np.zeros(d, np.float32)}}
        return np.asarray(nn.LayerNorm(epsilon=eps).apply(ln, jnp.asarray(v)))

    with torch.no_grad():
        for t in port.parameters():
            t.zero_()
        port.norm1.weight.fill_(1.0)
        port.norm2.weight.fill_(1.0)
        seen = {}
        hook = port.norm1.register_forward_hook(lambda m, i, o: seen.__setitem__("n1", o))
        port(torch.from_numpy(x), torch.zeros(1, n, d))
        hook.remove()
    norm1 = seen["n1"].numpy()
    assert np.abs(flax_ln(x, 1e-5) - flax_ln(x, 1e-6)).max() > 0.3
    np.testing.assert_allclose(norm1, flax_ln(x, 1e-5), atol=2e-5)
    assert np.abs(norm1 - flax_ln(x, 1e-6)).max() > 0.3


@pytest.mark.parametrize("shapes", [((16, 16), (8, 8), (4, 4)),
                                    ((80, 80), (40, 40), (20, 20))])
def test_anchors_match_jax(shapes):
    """At 640x640 the level-0 border ring (316 anchors) is the only invalid
    part of the pyramid: its anchors are +inf."""
    got, got_valid = rtdetr_decoder.generate_anchors(shapes)
    want, want_valid = jax_decoder.generate_anchors(shapes)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_valid, want_valid)
    if shapes[0] == (80, 80):
        assert int((~got_valid).sum()) == 316
