"""The recognizers and the OCR that ``yomitoku_torch --lite`` and
``parseq-small`` run, against the JAX package on the CPU, on the same
seeded inputs and weights.

* The port's plain ``fused_attention_heads`` and
  ``fused_attention_block_ln`` at parseq-tiny's head dim of 46 (8 heads, D
  368) and parseq-small's 48 (D 384), against the Pallas kernels in
  interpret mode.  L and Lk are multiples of 8 here (96, 104): the JAX
  block requires L % 8 == 0 and its gating keeps unaligned keys off the
  kernel; L = 100 runs in the model pair below, where JAX takes its XLA
  path.  atol = rtol = 1e-4: both sides compute in f32 and differ only in
  summation order (tests/test_torch_ops.py's tolerance).
* The port's ``PARSeq`` with the ``parseq-tiny`` and ``parseq-small``
  catalog configs, depth cut to 2 and widths kept (Dh 46 and 48, tiny's
  patch (8, 16) on 32x400, small's 16x16 on 32x800), against JAX's on the
  JAX seeded init carried over by ``state_dict_from_jax``: greedy ids
  equal, probs within 2e-4 (tests/test_torch_parseq.py's rule).
* ``OCR`` built from the ``--lite`` model names (``dbnetv2_1-lite``,
  ``parseq-tiny``) with the cuts of tests/yaml/det_small.yaml (64 / 96
  resize) and rec_small.yaml (one encoder block, 6-character labels), the
  recognizer's widths and canvas kept, on demo/sample_text.png: the same
  quads and strings, scores within rtol 1e-4 (tests/test_torch_ocr.py's
  rule)."""

from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from yomitoku_tpu.config import structured as jax_structured
from yomitoku_tpu.configs import text_recognizer as jax_rec_configs
from yomitoku_tpu.models.parseq import PARSeq as JaxPARSeq
from yomitoku_tpu.models.weights_convert import convert_dbnet
from yomitoku_tpu.ocr import OCR as JaxOCR
from yomitoku_tpu.ops.pallas import flash_attention as pallas_attn
from yomitoku_tpu_torch import ops
from yomitoku_tpu_torch.models.parseq import PARSeq
from yomitoku_tpu_torch.ocr import OCR
from yomitoku_tpu_torch.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
#: (D, heads): parseq-tiny's 8 heads of 46, parseq-small's 8 of 48
WIDTHS = [(368, 8), (384, 8)]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("Lq,Lk", [(51, 104), (101, 96)])
@pytest.mark.parametrize("D,H", WIDTHS)
def test_fused_attention_heads_matches_pallas(D, H, Lq, Lk):
    """The refine's cross-attention shape: tiny's 51 queries, small's 101,
    over a memory of 96 or 104 keys, batch 2."""
    rng = np.random.RandomState(D + Lq)
    q, k, v = (rng.randn(2, n, D).astype(np.float32) for n in (Lq, Lk, Lk))
    want = np.asarray(pallas_attn.fused_attention_heads(*_j(q, k, v), H, interpret=True))
    before = dict(ops.launches)
    got = ops.fused_attention_heads(*_t(q, k, v), H)
    assert ops.launches == before
    assert got.shape == (2, Lq, D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("L", [96, 104])
@pytest.mark.parametrize("D,H", WIDTHS)
def test_fused_attention_block_ln_matches_pallas(D, H, L):
    """The ViT's pre-LN self-attention sublayer, batch 2, through the
    public entry and through the packed entry as the models call it."""
    rng = np.random.RandomState(D + L)
    x = rng.randn(2, L, D).astype(np.float32)
    g = (rng.rand(D) + 0.5).astype(np.float32)
    b = (rng.randn(D) * 0.1).astype(np.float32)
    ws = [(rng.randn(D, D) * D ** -0.5).astype(np.float32) for _ in range(4)]
    bs = [(rng.randn(D) * 0.05).astype(np.float32) for _ in range(4)]
    args = [x, g, b, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], ws[3], bs[3]]
    want = np.asarray(pallas_attn.fused_attention_block_ln(*_j(*args), H, interpret=True))
    got = ops.fused_attention_block_ln(*_t(*args), H)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    xt, gt, bt, wq, bq, wk, bk, wv, bv, wo, bo = _t(*args)
    w_in = torch.cat([wq.t(), wk.t(), wv.t()]).contiguous()  # (3D, D), torch layout
    packed = ops.fused_attention_block_ln_packed(
        xt, gt, bt, w_in.t(), torch.cat([bq, bk, bv]), wo.t().contiguous().t(), bo, H)
    np.testing.assert_allclose(packed.numpy(), want, **TOL)


#: the catalog configs and what makes each one's attention shapes
RECOGNIZERS = {
    "parseq-tiny": (jax_rec_configs.TextRecognizerPARSeqTinyConfig, 46, (32, 400), 100, 51),
    "parseq-small": (jax_rec_configs.TextRecognizerPARSeqSmallConfig, 48, (32, 800), 100, 101),
}
_PARAMS = {}  # JAX seed-0 params per recognizer (init compiles once)


@pytest.mark.parametrize("name", list(RECOGNIZERS))
def test_parseq_at_full_width_matches_jax(monkeypatch, name):
    """Depth cut to 2, every width kept: head dims 46 and 48, 100 tokens
    (tiny's (8, 16) patches on 32x400, small's 16x16 on 32x800), 51 and
    101 positions; two lines of random pixels."""
    monkeypatch.setenv("YOMITOKU_TPU_INT8_KV", "0")
    cls, dh, img, tokens, positions = RECOGNIZERS[name]
    cfg = jax_structured(cls)
    cfg.encoder.depth = 2
    assert cfg.decoder.embed_dim // cfg.decoder.num_heads == dh
    assert list(cfg.data.img_size) == list(img)
    jm = JaxPARSeq(cfg)
    assert not jm.int8_kv
    if name not in _PARAMS:
        _PARAMS[name] = jm.init_params(0)
    jm.params = _PARAMS[name]
    port = PARSeq(cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(jm.params, port))
    x = (np.random.RandomState(3).rand(2, *img, 3) * 2 - 1).astype(np.float32)
    want = jm.forward_probs(x)
    got = port.forward_probs(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, positions, cfg.num_tokens - 2)
    np.testing.assert_allclose(got, want, atol=2e-4)
    ids, probs = port.forward_tokens(x)
    jids = want.argmax(-1)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(
        probs, np.take_along_axis(want, jids[..., None], -1)[..., 0], atol=2e-4)
    assert sorted(port._ar_loops) == [(2, tokens)]


#: the cuts of tests/yaml/det_small.yaml and rec_small.yaml, on the --lite
#: models; the recognizer keeps parseq-tiny's widths, patch and canvas
LITE_DET_CUT = {"data": {"shortest_size": 64, "limit_size": 96}}
LITE_REC_CUT = {"encoder": {"depth": 1}, "max_label_length": 6}


@pytest.fixture(scope="module")
def lite_pipelines(tmp_path_factory):
    cfg_dir = tmp_path_factory.mktemp("lite_cfg")
    det_cfg, rec_cfg = cfg_dir / "det_lite.yaml", cfg_dir / "rec_lite.yaml"
    det_cfg.write_text(yaml.safe_dump(LITE_DET_CUT))
    rec_cfg.write_text(yaml.safe_dump(LITE_REC_CUT))
    configs = {
        "text_detector": {"model_name": "dbnetv2_1-lite", "path_cfg": str(det_cfg),
                          "from_pretrained": False},
        "text_recognizer": {"model_name": "parseq-tiny", "path_cfg": str(rec_cfg),
                            "from_pretrained": False},
    }
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YOMITOKU_TPU_INT8_KV", "0")
        jax_ocr = JaxOCR(configs=configs, device="cpu")
        port = OCR(configs=configs, device="cpu")
        # detector: the port's seeded init, its last transposed conv scaled
        # (tests/test_torch_ocr.py), to JAX; recognizer: JAX's, to the port
        det = port.detector.model
        with torch.no_grad():
            det.decoder.binarize[6].weight.mul_(10.0)
        sd = {k: v.numpy() for k, v in det.state_dict().items()}
        jax_ocr.detector.model.params = convert_dbnet(sd, jax_ocr.detector.model)
        rec = jax_ocr.recognizer.model
        assert not rec.int8_kv
        rec.params = rec.init_params(0)
        port.recognizer.model.load_state_dict(
            state_dict_from_jax(rec.params, port.recognizer.model))
        yield jax_ocr, port


def test_lite_models_are_the_lite_shapes(lite_pipelines):
    _, port = lite_pipelines
    rec = port.recognizer.model
    assert rec.img_size == (32, 400)
    assert rec.head.in_features == 368 and rec.head.out_features == 7119
    assert port.recognizer._cfg.decoder.num_heads == 8
    assert port.recognizer._cfg.encoder.patch_size == [8, 16]
    assert port.detector._cfg.data.shortest_size == 64


def test_lite_ocr_matches_jax(lite_pipelines):
    """OCR on demo/sample_text.png: the same quads and strings, scores
    within rtol 1e-4."""
    jax_ocr, port = lite_pipelines
    page = cv2.imread(str(ROOT / "demo" / "sample_text.png"))
    want, _ = jax_ocr(page)
    got, vis = port(page)
    assert vis is None
    assert len(got.words) == len(want.words) > 0
    for g, w in zip(got.words, want.words):
        assert (g.points, g.content, g.direction) == (w.points, w.content, w.direction)
        np.testing.assert_allclose([g.det_score, g.rec_score],
                                   [w.det_score, w.rec_score], rtol=1e-4)
