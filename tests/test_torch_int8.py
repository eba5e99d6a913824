"""The port's int8 recognizer pieces against the JAX package's, CPU, on the
same seeded numpy inputs: weight and K/V quantization, the plain W8A8
sublayers against the Pallas kernels in interpret mode (as
tests/test_int8_encoder.py runs them), ``attend_int8``, and a small PARSeq
with the int8 encoder forced on both sides, with the int8 memory-K/V cache
on and off.

Tolerances.  Quantization codes are compared first and must be equal:
weights, K/V and activation rows, whose f32 inputs are the same on both
sides here (the card's kernels, whose f32 inputs may differ from the plain
version's in the last bit, may move a code by one step at a rounding tie;
tests/test_torch_cuda.py bounds that share).  Sublayer outputs within 1e-5
of the largest output (f32 summation order only); encoder memory within
1e-4 of its largest value; greedy ids equal wherever the top-2 logit gap
is at least 1e-3, and equal outright on these inputs."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_parseq_torch_parity import small_cfg
from yomitoku_tpu.models.layers import attention as jax_attn
from yomitoku_tpu.models.parseq import PARSeq as JaxPARSeq
from yomitoku_tpu.ops.pallas import flash_attention as pallas_attn
from yomitoku_tpu.ops.pallas import fused_mlp as pallas_mlp
from yomitoku_tpu_torch import ops
from yomitoku_tpu_torch.models import parseq as port_parseq
from yomitoku_tpu_torch.models.layers import attention as port_attn
from yomitoku_tpu_torch.models.parseq import PARSeq
from yomitoku_tpu_torch.weights import state_dict_from_jax

def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("shape,std", [((64, 32), 2.0), ((768, 96), 0.03),
                                       ((256, 2048), 0.1)])
def test_quantize_weight_int8_matches_jax(shape, std):
    w = (np.random.RandomState(0).randn(*shape) * std).astype(np.float32)
    w[:, 1] = 0.0  # an all-zero output channel takes the 1e-8 floor
    q, s = ops.quantize_weight_int8(torch.from_numpy(w))
    jq, js = pallas_mlp.quantize_weight_int8(jnp.asarray(w))
    assert q.dtype == torch.int8 and q.shape == shape and s.shape == (shape[1],)
    assert q.stride() == (1, shape[0])  # the transpose of a row-major (N, K)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_quantize_kv_int8_matches_jax(scale):
    rng = np.random.RandomState(1)
    k = (rng.randn(2, 4, 40, 16) * scale).astype(np.float32)
    v = rng.randn(2, 4, 40, 16).astype(np.float32)
    v[1, 2] = 0.0  # an all-zero head
    got = port_attn.quantize_kv_int8(*_t(k, v))
    want = jax_attn.quantize_kv_int8(*_j(k, v))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].shape == (2, 4, 1, 1)


@pytest.mark.parametrize("chunk", [None, 128])
def test_quantize_rows_matches_pallas_formula(chunk):
    """The row quantization of the Pallas kernels (fused_mlp.py:218-221,
    234-237), written out in jnp, per row or per row and chunk."""
    a = (np.random.RandomState(2).randn(12, 256) * 3).astype(np.float32)
    a[3] = 0.0
    c = chunk or 256
    g = jnp.asarray(a).reshape(12, 256 // c, c)
    s = jnp.maximum(jnp.max(jnp.abs(g), axis=-1, keepdims=True), 1e-6) * (1.0 / 127.0)
    want_q = jnp.clip(jnp.round(g / s), -127, 127).astype(jnp.int8).reshape(12, 256)
    q, sc = ops.quantize_rows_reference(torch.from_numpy(a), chunk)
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(s)[..., 0])


def _mlp_case(N, D, H, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, D).astype(np.float32)
    g = (rng.rand(D) + 0.5).astype(np.float32)
    b = (rng.randn(D) * 0.1).astype(np.float32)
    w1 = (rng.randn(D, H) * 0.1).astype(np.float32)
    b1 = (rng.randn(H) * 0.05).astype(np.float32)
    w2 = (rng.randn(H, D) * 0.1).astype(np.float32)
    b2 = (rng.randn(D) * 0.05).astype(np.float32)
    return x, g, b, w1, b1, w2, b2


@pytest.mark.parametrize("N,D,H", [(16, 64, 256), (16, 64, 2048), (40, 96, 384)])
def test_fused_mlp_ln_int8_matches_pallas(N, D, H):
    """H=2048 gives two hidden chunks of 1024; H=384 one of 384."""
    x, g, b, w1, b1, w2, b2 = _mlp_case(N, D, H)
    assert ops.hidden_chunk(H) == pallas_mlp._pick(H, 1024, 128) or H
    jw1, js1 = pallas_mlp.quantize_weight_int8(jnp.asarray(w1))
    jw2, js2 = pallas_mlp.quantize_weight_int8(jnp.asarray(w2))
    want = np.asarray(pallas_mlp.fused_mlp_ln_int8(
        *_j(x, g, b), jw1, js1, jnp.asarray(b1), jw2, js2, jnp.asarray(b2),
        interpret=True))
    w1q, s1 = ops.quantize_weight_int8(torch.from_numpy(w1))
    w2q, s2 = ops.quantize_weight_int8(torch.from_numpy(w2))
    n0 = dict(ops.launches)
    got = ops.fused_mlp_ln_int8(*_t(x, g, b), w1q, s1, torch.from_numpy(b1),
                                w2q, s2, torch.from_numpy(b2)).numpy()
    assert ops.launches == n0  # the plain version on the CPU counts nothing
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_mlp_chunks_are_a_different_function():
    """Quantizing the GELU output per 1024-wide chunk is not the same as
    one scale per row: the Pallas kernel's chunked scales are what the
    plain version computes."""
    x, g, b, w1, b1, w2, b2 = _mlp_case(16, 64, 2048)
    w1q, s1 = ops.quantize_weight_int8(torch.from_numpy(w1))
    w2q, s2 = ops.quantize_weight_int8(torch.from_numpy(w2))
    args = (*_t(x, g, b), w1q, s1, torch.from_numpy(b1), w2q, s2,
            torch.from_numpy(b2))
    chunked = ops.fused_mlp_ln_int8_reference(*args)
    real_pick = ops.mlp._pick
    try:
        ops.mlp._pick = lambda total, target, align: None  # one chunk = H
        whole = ops.fused_mlp_ln_int8_reference(*args)
    finally:
        ops.mlp._pick = real_pick
    assert (chunked - whole).abs().max().item() > 1e-4


def _block_case(B, L, D, seed=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, L, D).astype(np.float32)
    g = (rng.rand(D) + 0.5).astype(np.float32)
    b = (rng.randn(D) * 0.1).astype(np.float32)
    ws = [(rng.randn(D, D) * 0.08).astype(np.float32) for _ in range(4)]
    bs = [(rng.randn(D) * 0.05).astype(np.float32) for _ in range(4)]
    return x, g, b, ws, bs


@pytest.mark.parametrize("B,L,D,H", [(2, 24, 64, 4), (3, 17, 96, 6)])
def test_fused_attention_block_ln_int8_matches_pallas(B, L, D, H):
    x, g, b, ws, bs = _block_case(B, L, D)
    jargs = _j(x, g, b)
    targs = _t(x, g, b)
    for w, bias in zip(ws, bs):
        jq, js = pallas_mlp.quantize_weight_int8(jnp.asarray(w))
        jargs += [jq, js, jnp.asarray(bias)]
        q, s = ops.quantize_weight_int8(torch.from_numpy(w))
        targs += [q, s, torch.from_numpy(bias)]
    if L % 8:
        # the Pallas kernel needs L % 8 == 0: hold the port to the
        # reference composition at this ragged length instead
        want = _int8_block_by_hand(x, g, b, ws, bs, H)
    else:
        want = np.asarray(pallas_attn.fused_attention_block_ln_int8(
            *jargs, H, interpret=True))
    got = ops.fused_attention_block_ln_int8(*targs, H).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # the packed entry the models call gives the same result
    packed = ops.fused_attention_block_ln_int8_packed(
        targs[0], targs[1], targs[2],
        torch.cat([targs[3], targs[6], targs[9]], 1),
        torch.cat([targs[4], targs[7], targs[10]]),
        torch.cat([targs[5], targs[8], targs[11]]),
        targs[12], targs[13], targs[14], H).numpy()
    np.testing.assert_array_equal(packed, got)


def _int8_block_by_hand(x, g, b, ws, bs, H):
    """The Pallas kernel body (flash_attention.py:365-430) in jnp."""
    xf = jnp.asarray(x)
    mu = xf.mean(-1, keepdims=True)
    var = jnp.maximum((xf * xf).mean(-1, keepdims=True) - mu * mu, 0.0)
    h = (xf - mu) * (1.0 / jnp.sqrt(var + 1e-6)) * g + b

    def quant(a):
        s = jnp.maximum(jnp.max(jnp.abs(a), -1, keepdims=True), 1e-6) * (1.0 / 127.0)
        return jnp.clip(jnp.round(a / s), -127, 127), s

    hq, sh = quant(h)
    qw = [pallas_mlp.quantize_weight_int8(jnp.asarray(w)) for w in ws]
    q, k, v = [(jnp.einsum("bld,de->ble", hq, w.astype(jnp.float32)) * sh * s + bb)
               for (w, s), bb in zip(qw[:3], bs[:3])]
    B, L, D = x.shape
    split = lambda t: t.reshape(B, L, H, D // H).transpose(0, 2, 1, 3)  # noqa: E731
    logits = jnp.einsum("bhqd,bhkd->bhqk", split(q), split(k)) * (D // H) ** -0.5
    w = jnp.exp(logits - logits.max(-1, keepdims=True))
    w = w / w.sum(-1, keepdims=True)
    attn = jnp.einsum("bhqk,bhkd->bhqd", w, split(v)).transpose(0, 2, 1, 3)
    aq, sa = quant(attn.reshape(B, L, D))
    out = jnp.einsum("bld,de->ble", aq, qw[3][0].astype(jnp.float32)) * sa * qw[3][1] + bs[3]
    return np.asarray(xf + out)


@pytest.mark.parametrize("lq,masked", [(1, False), (3, True)])
def test_attend_int8_matches_jax(lq, masked):
    """MultiHeadAttention.attend_int8 against the JAX module's method on the
    same weights: an AR step (one query) and a masked block of queries."""
    D, H, M, B = 32, 4, 40, 2
    rng = np.random.RandomState(3)
    params = {n: {"kernel": (rng.randn(D, D) * 0.2).astype(np.float32),
                  "bias": (rng.randn(D) * 0.1).astype(np.float32)}
              for n in ("q_proj", "k_proj", "v_proj", "out_proj")}
    q = rng.randn(B, H, lq, D // H).astype(np.float32)
    k = (rng.randn(B, H, M, D // H) * 2).astype(np.float32)
    v = rng.randn(B, H, M, D // H).astype(np.float32)
    mask = (rng.rand(1, 1, lq, M) < 0.3) if masked else None
    jm = jax_attn.MultiHeadAttention(D, H)
    kq, sk, vq, sv = jax_attn.quantize_kv_int8(*_j(k, v))
    want = jm.apply({"params": params}, jnp.asarray(q), kq, sk, vq, sv,
                    None if mask is None else jnp.asarray(mask),
                    method="attend_int8")
    port = port_attn.MultiHeadAttention(D, H)
    port.load_state_dict(_packed_attn_sd(params))
    cache = port_attn.quantize_kv_int8(*_t(k, v))
    got = port.attend_int8(torch.from_numpy(q), *cache,
                           None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


def _packed_attn_sd(params):
    """q/k/v/out denses as nn.MultiheadAttention's packed parameters."""
    from yomitoku_tpu_torch.weights import _Writer

    w = _Writer()
    w.packed("m", params, "in_proj_weight", "in_proj_bias", "out_proj")
    return {k[2:]: v for k, v in w.sd.items()}


# -------------------------------------------------------------- slice level


def _force_int8_encoder(monkeypatch):
    """Both packages take their int8 encoder sublayers on the CPU: the JAX
    gates forced, its kernels in interpret mode; the port's gates forced,
    its plain versions."""
    for name, fn in (("use_int8_encoder", lambda: True),
                     ("_use_fused_block", lambda x, h: True),
                     ("_use_fused_mlp", lambda x, hd: True)):
        monkeypatch.setattr(jax_attn, name, fn)
    for mod, name in ((pallas_attn, "fused_attention_block_ln_int8"),
                      (pallas_mlp, "fused_mlp_ln_int8"),
                      (pallas_mlp, "fused_mlp")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name),
                                                         interpret=True))
    monkeypatch.setattr(port_attn, "use_int8_encoder", lambda x: True)
    monkeypatch.setattr(port_attn, "_use_fused_block", lambda x, h: True)
    monkeypatch.setattr(port_attn, "_use_fused_mlp", lambda x: True)


_PARAMS = {}


def _pair(monkeypatch, int8_kv):
    monkeypatch.setenv("YOMITOKU_TPU_INT8_KV", "1" if int8_kv else "0")
    cfg = small_cfg()
    jm = JaxPARSeq(cfg)
    assert jm.int8_kv == int8_kv
    if "p" not in _PARAMS:
        _PARAMS["p"] = jm.init_params(0)
    jm.params = _PARAMS["p"]
    port = PARSeq(cfg, device="cpu")
    assert port.int8_kv == int8_kv
    port.load_state_dict(state_dict_from_jax(jm.params, port))
    return jm, port


def _images(seed, n=4):
    return (np.random.RandomState(seed).rand(n, 32, 48, 3) * 2 - 1).astype(np.float32)


def _ids_equal_outside_ties(got_logits, want_logits, gap=1e-3):
    top2 = np.sort(want_logits, -1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) < gap
    differ = got_logits.argmax(-1) != want_logits.argmax(-1)
    assert not (differ & ~tie).any(), int((differ & ~tie).sum())


@pytest.mark.parametrize("int8_kv", [True, False])
def test_parseq_int8_encoder_matches_jax(monkeypatch, int8_kv):
    _force_int8_encoder(monkeypatch)
    jm, port = _pair(monkeypatch, int8_kv)
    x = _images(5)
    want_mem = np.asarray(jm.core.apply(jm.params, jnp.asarray(x), method="encode"))
    got_mem = port.encoder(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_mem, want_mem, rtol=0,
                               atol=1e-4 * np.abs(want_mem).max())
    want = np.log(np.asarray(jm.forward_probs(x)))
    got = port.forward_logits(torch.from_numpy(x)).numpy()
    _ids_equal_outside_ties(got, want)
    ids, _ = port.forward_tokens(x)
    jids, _ = jm.forward_tokens(x)
    np.testing.assert_array_equal(ids, jids)


def test_int8_kv_cache_changes_the_decode_state(monkeypatch):
    """With the cache on, the AR loop holds int8 codes and per-(batch,
    head) scales; with it off, the f32 K/V."""
    _, port = _pair(monkeypatch, True)
    port.forward_tokens(_images(6))
    mem = port._ar_loops[(4, 24)].mem
    assert [t.dtype for t in mem] == [torch.int8, torch.float32] * 2
    assert mem[1].shape == (4, 4, 1, 1)
    port.int8_kv = False
    port.forward_tokens(_images(6))
    assert [t.dtype for t in port._ar_loops[(4, 24)].mem] == [torch.float32] * 2


def test_int8_kv_default_policy(monkeypatch):
    monkeypatch.delenv("YOMITOKU_TPU_INT8_KV", raising=False)
    assert port_parseq._int8_kv_default("cuda")
    assert not port_parseq._int8_kv_default("cpu")
    for env, want in (("1", True), ("0", False), ("junk", False)):
        monkeypatch.setenv("YOMITOKU_TPU_INT8_KV", env)
        assert port_parseq._int8_kv_default("cpu") is want
    monkeypatch.setenv("YOMITOKU_TPU_INT8_KV", "0")
    assert not port_parseq._int8_kv_default("cuda")


def test_audit_matches_jax(monkeypatch):
    """The audit decodes one batch with and without the int8 cache and
    keeps int8 only where the greedy ids agree, as the JAX audit does."""
    jm, port = _pair(monkeypatch, True)
    batch = _images(7)
    want = jm.audit_int8_kv(batch)
    assert port.audit_int8_kv(batch) == want
    assert port.int8_kv == jm.int8_kv == want
    port.int8_kv = False
    assert port.audit_int8_kv(batch)  # nothing to audit with int8 off


def test_recognizer_audits_real_checkpoints(monkeypatch, tmp_path):
    """TextRecognizer audits the int8 cache when a real checkpoint loads
    with the default in force, and not when the user forced the choice."""
    from yomitoku_tpu_torch.text_recognizer import TextRecognizer

    cfg = str(__import__("pathlib").Path(__file__).parent / "yaml" / "rec_small.yaml")
    src = TextRecognizer(path_cfg=cfg, device="cpu", from_pretrained=False).model
    ckpt = tmp_path / "yomitoku-text-recognizer-parseq-large-v4_1" / "pytorch_model.bin"
    ckpt.parent.mkdir()
    torch.save(src.state_dict(), ckpt)
    monkeypatch.setenv("YOMITOKU_TPU_WEIGHTS", str(tmp_path))
    monkeypatch.setattr(port_parseq, "_int8_kv_default", lambda device: True)
    calls = []
    monkeypatch.setattr(PARSeq, "audit_int8_kv", lambda self: calls.append(1))
    monkeypatch.delenv("YOMITOKU_TPU_INT8_KV", raising=False)
    TextRecognizer(path_cfg=cfg, device="cpu")
    assert calls == [1]
    monkeypatch.setenv("YOMITOKU_TPU_INT8_KV", "1")
    TextRecognizer(path_cfg=cfg, device="cpu")
    TextRecognizer(path_cfg=cfg, device="cpu", from_pretrained=False)
    assert calls == [1]


def test_new_weights_change_the_int8_encoder(monkeypatch):
    """The int8 weights are quantized once and kept; a state_dict load after
    a first forward must re-quantize them."""
    _force_int8_encoder(monkeypatch)
    _, port = _pair(monkeypatch, False)
    x = torch.from_numpy(_images(8))
    first = port.encoder(x)
    assert "_int8_weights" in port.encoder.blocks[0].attn.__dict__
    sd = {k: v * 1.5 if k.startswith("encoder.blocks") and k.endswith("weight") else v
          for k, v in port.state_dict().items()}
    port.load_state_dict(sd)
    second = port.encoder(x)
    fresh = PARSeq(small_cfg(), device="cpu")
    fresh.load_state_dict(sd)
    np.testing.assert_array_equal(second.numpy(), fresh.encoder(x).numpy())
    assert (second - first).abs().max().item() > 1e-3
