"""The port's ViT and two-stream decoder layers against the JAX package's
flax modules, on parameters from the JAX seeded init carried across by
``state_dict_from_jax``.  CPU, f32; tolerance atol 1e-4 (the two differ
in summation order only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_parseq_torch_parity import small_cfg
from yomitoku_tpu.models.layers.two_stream import TwoStreamDecoderLayer
from yomitoku_tpu.models.layers.vit import EncoderBlock, ViTEncoder
from yomitoku_tpu.models.parseq import PARSeq as JaxPARSeq
from yomitoku_tpu_torch.models.parseq import PARSeq
from yomitoku_tpu_torch.weights import state_dict_from_jax

ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    cfg = small_cfg()
    params = JaxPARSeq(cfg).init_params(0)["params"]
    port = PARSeq(cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(params, port))
    return cfg, params, port


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


def _collapse(x):
    """Tokens with across-channel variance ~1e-6 (mean 0.01): the regime
    where the LayerNorm eps (1e-6 in the ViT, 1e-5 in the decoder) is an
    O(1) effect."""
    return (0.01 + 1e-3 * (x - x.mean(-1, keepdims=True))).astype(np.float32)


@pytest.mark.parametrize("collapsed", [False, True])
def test_encoder_block(models, collapsed):
    cfg, params, port = models
    D = cfg.encoder.embed_dim
    x = np.random.RandomState(0).randn(2, 24, D).astype(np.float32)
    if collapsed:
        x = _collapse(x)
    blk = EncoderBlock(D, cfg.encoder.num_heads, cfg.encoder.mlp_ratio)
    want = blk.apply({"params": params["encoder"]["blocks_0"]}, jnp.asarray(x))
    _close(port.encoder.blocks[0](torch.from_numpy(x)), want)


@pytest.mark.parametrize("width", [48, 32])
def test_vit_encoder(models, width):
    """Full canvas, and a narrower one that slices the position-embedding
    sub-grid."""
    cfg, params, port = models
    enc = ViTEncoder(
        img_size=tuple(cfg.data.img_size), patch_size=tuple(cfg.encoder.patch_size),
        embed_dim=cfg.encoder.embed_dim, depth=cfg.encoder.depth,
        num_heads=cfg.encoder.num_heads, mlp_ratio=cfg.encoder.mlp_ratio,
    )
    img = np.random.RandomState(1).rand(2, 32, width, 3).astype(np.float32)
    want = enc.apply({"params": params["encoder"]}, jnp.asarray(img))
    _close(port.encoder(torch.from_numpy(img)), want)


def _decoder_inputs(D, B=2, L=7, M=12):
    rng = np.random.RandomState(2)
    q, c, m = (rng.randn(B, n, D).astype(np.float32) for n in (L, L, M))
    ones = np.ones((L, L), bool)
    cloze = np.triu(ones, 1) & ~np.triu(ones, 2)
    kpm = np.zeros((B, L), bool)
    kpm[0, 4:] = True
    return q, c, m, cloze, kpm


@pytest.mark.parametrize(
    "update_content,masked,collapsed",
    [(False, False, False), (False, True, False), (True, False, False),
     (True, True, False), (True, True, True)],
)
def test_two_stream_decoder_layer(models, update_content, masked, collapsed):
    cfg, params, port = models
    D = cfg.decoder.embed_dim
    q, c, m, cloze, kpm = _decoder_inputs(D)
    if collapsed:
        q, c = _collapse(q), _collapse(c)
    masks = (cloze, cloze, kpm) if masked else (None, None, None)
    layer = TwoStreamDecoderLayer(D, cfg.decoder.num_heads, cfg.decoder.mlp_ratio)
    jq, jc = layer.apply(
        {"params": params["decoder"]["layers_0"]},
        *map(jnp.asarray, (q, c, m)),
        *(None if a is None else jnp.asarray(a) for a in masks),
        update_content=update_content,
    )
    tq, tc = port.decoder.layers[0](
        *map(torch.from_numpy, (q, c, m)),
        *(None if a is None else torch.from_numpy(a) for a in masks),
        update_content=update_content,
    )
    _close(tq, jq)
    _close(tc, jc)


def test_decoder_query_step(models):
    """The cached AR step: one query row against content and memory K/V."""
    cfg, params, port = models
    D = cfg.decoder.embed_dim
    q, c, m, _, _ = _decoder_inputs(D)
    row = np.triu(np.ones((7, 7), bool), 1)[3:4]
    layer = TwoStreamDecoderLayer(D, cfg.decoder.num_heads, cfg.decoder.mlp_ratio)
    p = {"params": params["decoder"]["layers_0"]}
    jkc, jvc = layer.apply(p, jnp.asarray(c), method="content_kv")
    jkm, jvm = layer.apply(p, jnp.asarray(m), method="memory_kv")
    want = layer.apply(p, jnp.asarray(q[:, 3:4]), jkc, jvc, jkm, jvm,
                       jnp.asarray(row), method="query_step")
    lay = port.decoder.layers[0]
    kc, vc = lay.content_kv(torch.from_numpy(c))
    km, vm = lay.memory_kv(torch.from_numpy(m))
    _close(kc, jkc)
    _close(km, jkm)
    got = lay.query_step(torch.from_numpy(q[:, 3:4]), kc, vc, km, vm,
                         torch.from_numpy(row))
    _close(got, want)


def test_content_embeddings_scaled_by_sqrt_d(models):
    cfg, params, port = models
    tok = torch.tensor([[cfg.num_tokens - 2, 3, 0]])
    emb = params["text_embed"]["embedding"]
    want = emb[[3, 0]] * np.sqrt(cfg.decoder.embed_dim)
    got = port.content_embeddings(tok)[0, 1:] - port.pos_queries[0, :2]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
