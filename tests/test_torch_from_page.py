"""The device-page route of the port against the JAX package's, on the
same weights and pages, CPU, f32, with YOMITOKU_TPU_DEVICE_CROPS=1 on both
sides.

Models: PARSeq (D=48, depth 2, 32x48 canvas) on aligned lines (which the
JAX package crops with its separable program, the port with the gather)
and skewed ones, and at a narrow canvas, ids equal and probs within 2e-4; DBNet (dbnetv2_1
widths, 64x96) within one uint8 quantum; RT-DETRv2 (the table recognizer of
layout_small.yaml, 128x128, 20 queries) within 1e-4 of the largest value plus 1e-5, after
the gap between the k-th and (k+1)-th selection scores is checked.  Task
modules (the configs of test_torch_ocr.py and test_torch_layout.py):
quads, boxes and strings equal, scores to rtol 1e-4, with ``page=`` and
through OCR and LayoutAnalyzer (a module on another device than the
shared page uploads its own); width buckets forced to 16 against JAX and against the model
run directly at that width; the cost guard; the audit's gate; the
orientation fallback; a batch of aligned and skewed quads; and the AR
loop's state kept per (batch, memory length)."""

import unicodedata

import numpy as np
import pytest
import torch

from test_torch_device_crop import ALIGNED, QUADS as CROP_QUADS, text_page
from test_torch_layout import (  # noqa: F401  (analyzers: a fixture)
    _same_elements,
    _same_tables,
    analyzers,
)
from test_torch_ocr import QUADS, pipelines, synthetic_page  # noqa: F401
from test_torch_parseq import _pair
from test_torch_rtdetr import close, numpy_state, randomize_bn
from yomitoku_tpu.config import structured
from yomitoku_tpu.configs import TextDetectorDBNetV2_1Config
from yomitoku_tpu.models.dbnet import DBNet as JaxDBNet
from yomitoku_tpu.models.weights_convert import convert_dbnet
from yomitoku_tpu.ops import device_crop as jdc
from yomitoku_tpu_torch import text_recognizer as port_rec_module
from yomitoku_tpu_torch.models.dbnet import DBNet
from yomitoku_tpu_torch.models.parseq import PARSeq
from yomitoku_tpu_torch.ops import device_crop as dc


@pytest.fixture(autouse=True)
def device_crops(monkeypatch):
    monkeypatch.setenv("YOMITOKU_TPU_DEVICE_CROPS", "1")
    monkeypatch.delenv("YOMITOKU_TPU_HOST_CROPS", raising=False)
    monkeypatch.delenv("YOMITOKU_TPU_REC_WIDTH_BUCKETS", raising=False)


def _pages(img):
    """The same page as the JAX package's DevicePage and the port's."""
    return jdc.DevicePage(img), dc.DevicePage(img, "cpu")


# ------------------------------------------------------------------ models


@pytest.mark.parametrize("out_w", [None, 24])
@pytest.mark.parametrize("lines", ["aligned", "skewed"])
def test_parseq_from_page_matches_jax(monkeypatch, lines, out_w):
    """Aligned lines: the JAX package's separable program against the
    port's gather; with skewed ones both gather."""
    jm, port = _pair(monkeypatch)
    quads = ALIGNED if lines == "aligned" else CROP_QUADS
    jpage, page = _pages(text_page())
    mats, wh = dc.line_homographies(quads, (32, 48))
    want = jm.forward_tokens_from_page(jpage.dev, mats, wh, out_w=out_w)
    got = port.forward_tokens_from_page(page.dev, mats, wh, out_w=out_w)
    assert got[0].shape == want[0].shape == (len(quads), 7)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=2e-4)


def test_ar_state_kept_per_batch_and_memory_length(monkeypatch):
    """The same model decodes 8 lines at a narrow canvas, at the full one,
    then narrow again: each result equals a fresh model's, and each
    memory length keeps its own AR-loop state."""
    _, port = _pair(monkeypatch)
    _, page = _pages(text_page())
    quads = (ALIGNED * 2)[:8]
    mats, wh = dc.line_homographies(quads, (32, 48))
    fresh = {}
    for out_w in (24, None):
        model = PARSeq(port.cfg, device="cpu")
        model.load_state_dict(port.state_dict())
        fresh[out_w] = model.forward_tokens_from_page(page.dev, mats, wh, out_w=out_w)
    for out_w in (24, None, 24):
        ids, probs = port.forward_tokens_from_page(page.dev, mats, wh, out_w=out_w)
        np.testing.assert_array_equal(ids, fresh[out_w][0])
        np.testing.assert_array_equal(probs, fresh[out_w][1])
    assert sorted(port._ar_loops) == [(8, 12), (8, 24)]


@pytest.fixture(scope="module")
def det_pair():
    cfg = structured(TextDetectorDBNetV2_1Config)
    port = DBNet(cfg, device="cpu")
    randomize_bn(port)
    jm = JaxDBNet(cfg)
    jm.params = convert_dbnet(numpy_state(port), jm)
    return jm, port


def test_dbnet_from_page_within_one_quantum(det_pair):
    jm, port = det_pair
    img = text_page(150, 230)
    jpage, page = _pages(img)
    want = jm.forward_binary_from_page(jpage.dev, jpage.hw, (64, 96), as_u8=True)
    got = port.forward_binary_from_page(page.dev, page.hw, (64, 96))
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (1, 64, 96)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert got.std() > 0


def test_rtdetr_from_page_matches_jax(analyzers):
    """The table recognizer's model on the full page and three regions in
    one batch (the 4-table bucket)."""
    jax_la, port_la, img = analyzers
    jm = jax_la.table_structure_recognizer.model
    port = port_la.table_structure_recognizer.model
    jpage, page = _pages(img)
    mats, _ = dc.region_mats([(0, 0, 320, 240), (10, 20, 300, 200), (150, 60, 310, 230),
                              (0, 0, 1, 1)], (128, 128))
    want = jm.forward_from_page(jpage.dev, mats, (128, 128))
    seen = {}
    hook = port.decoder.enc_score_head.register_forward_hook(
        lambda m, i, out: seen.__setitem__("enc", out.numpy().max(-1)))
    try:
        got = port.forward_from_page(page.dev, mats, (128, 128))
    finally:
        hook.remove()
    k = port.decoder.num_queries
    for scores in seen["enc"]:
        order = np.argsort(-scores, kind="stable")
        assert scores[order[k - 1]] - scores[order[k]] > 1e-3
    close(got["pred_logits"].numpy(), want["pred_logits"])
    close(got["pred_boxes"].numpy(), want["pred_boxes"])
    assert got["pred_logits"].shape == (4, k, 3)


# ------------------------------------------------------------------ OCR modules


def test_detector_page_route_matches_jax(pipelines):
    jax_ocr, port = pipelines
    img = synthetic_page()
    jpage, page = _pages(img)
    want, _ = jax_ocr.detector(img, page=jpage)
    got, _ = port.detector(img, page=page)
    assert len(want.points) > 1
    assert got.points == want.points
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4)


def _same_lines(got, want):
    assert got.contents == want.contents
    assert got.points == want.points
    assert got.directions == want.directions
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4)


@pytest.mark.parametrize("shared", [True, False])
def test_recognizer_page_route_matches_jax(pipelines, shared):
    """Aligned, skewed and vertical quads (a mixed batch, which the JAX
    package splits between its two crop programs and the port gathers),
    with a shared page or one uploaded by the module."""
    jax_ocr, port = pipelines
    img = synthetic_page()
    jpage, page = _pages(img) if shared else (None, None)
    want, _ = jax_ocr.recognizer(img, QUADS, page=jpage)
    got, _ = port.recognizer(img, QUADS, page=page)
    assert len(got.contents) == len(QUADS)
    _same_lines(got, want)


def test_recognizer_page_route_never_builds_host_crops(pipelines, monkeypatch):
    _, port = pipelines

    def refuse(*args, **kwargs):
        raise AssertionError("the device route built a ParseqDataset")

    monkeypatch.setattr(port_rec_module, "ParseqDataset", refuse)
    got, _ = port.recognizer(synthetic_page(), QUADS)
    assert len(got.contents) == len(QUADS)


def test_mixed_batch_equals_singleton_runs(pipelines):
    """Per-line decodes do not depend on the batch: the mixed batch's lines
    equal each line run alone (the oracle)."""
    _, port = pipelines
    img = synthetic_page()
    mixed, _ = port.recognizer(img, QUADS)
    for i, q in enumerate(QUADS):
        one, _ = port.recognizer(img, [q])
        assert mixed.contents[i] == one.contents[0]
        assert mixed.directions[i] == one.directions[0]
        np.testing.assert_allclose(mixed.scores[i], one.scores[0], rtol=1e-4)


def test_ocr_device_route_matches_jax(pipelines, monkeypatch):
    jax_ocr, port = pipelines
    built = []
    monkeypatch.setattr("yomitoku_tpu_torch.ocr.DevicePage",
                        lambda img, device: built.append(device) or dc.DevicePage(img, device))
    img = synthetic_page()
    want, _ = jax_ocr(img)
    got, _ = port(img)
    assert built == [torch.device("cpu")]
    assert len(got.words) == len(want.words) > 1
    for g, w in zip(got.words, want.words):
        assert (g.points, g.content, g.direction) == (w.points, w.content, w.direction)
        np.testing.assert_allclose([g.det_score, g.rec_score], [w.det_score, w.rec_score],
                                   rtol=1e-4)


def test_ocr_recognizer_on_another_device_uploads_its_own_page(pipelines, monkeypatch):
    """A recognizer configured on another device than the detector is not
    handed the detector's page: it uploads the image to its own device.
    Here the recognizer's device reads as a second card while its model
    stays on the CPU, so its upload is recorded and made on the CPU."""
    jax_ocr, port = pipelines
    uploads = []

    def upload(img, device):
        uploads.append(torch.device(device))
        return dc.DevicePage(img, "cpu")

    monkeypatch.setattr("yomitoku_tpu_torch.text_recognizer.DevicePage", upload)
    rec = port.recognizer
    monkeypatch.setattr(rec, "device", torch.device("cuda", 1))
    handed = []
    call = type(rec).__call__
    monkeypatch.setattr(type(rec), "__call__", lambda self, img, pts=None, vis=None, page=None:
                        handed.append(page) or call(self, img, pts, vis=vis, page=page))
    img = synthetic_page()
    want, _ = jax_ocr(img)
    got, _ = port(img)
    assert handed == [None] and uploads == [torch.device("cuda", 1)]
    assert [(w.points, w.content) for w in got.words] == \
        [(w.points, w.content) for w in want.words]


def test_host_crops_switch_wins(pipelines, monkeypatch):
    """YOMITOKU_TPU_HOST_CROPS=1 takes OCR back to the host route: no page."""
    _, port = pipelines
    monkeypatch.setenv("YOMITOKU_TPU_HOST_CROPS", "1")

    def refuse(*args, **kwargs):
        raise AssertionError("a DevicePage was built under the host switch")

    monkeypatch.setattr("yomitoku_tpu_torch.ocr.DevicePage", refuse)
    got, _ = port(synthetic_page())
    assert len(got.words) > 1


# ------------------------------------------------------------------ width buckets


def _narrow_page():
    rng = np.random.RandomState(5)
    img = np.full((64, 96, 3), 255, np.uint8)
    img[8:18, 4:16] = rng.randint(0, 255, (10, 12, 3))    # narrow (w=12)
    img[30:40, 4:34] = rng.randint(0, 255, (10, 30, 3))   # wide (w=30)
    img[48:58, 40:52] = rng.randint(0, 255, (10, 12, 3))  # narrow again
    quads = [
        [[4, 8], [16, 8], [16, 18], [4, 18]],
        [[4, 30], [34, 30], [34, 40], [4, 40]],
        [[40, 48], [52, 48], [52, 58], [40, 58]],
    ]
    return img, quads


def test_width_buckets_match_jax_and_the_oracle(pipelines, monkeypatch):
    jax_ocr, port = pipelines
    img, quads = _narrow_page()
    base = port.recognizer._call_device(img, quads)
    monkeypatch.setenv("YOMITOKU_TPU_REC_WIDTH_BUCKETS", "16")
    assert port.recognizer._width_buckets() == [16]
    want = jax_ocr.recognizer._call_device(img, quads)
    got = port.recognizer._call_device(img, quads)
    assert got[0] == want[0] and got[2] == want[2] and got[3] == want[3]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
    # the wide line keeps the full canvas
    assert got[0][1] == base[0][1]
    assert got[1][1] == pytest.approx(base[1][1], rel=1e-6)
    # the narrow lines equal the model run directly at the 16-px canvas
    mats, wh = dc.line_homographies([quads[0], quads[2]], (32, 32))
    ids, probs = port.recognizer.model.forward_tokens_from_page(
        dc.DevicePage(img, "cpu").dev, mats, wh, out_w=16)
    o_preds, o_scores = port.recognizer.tokenizer.decode_ids(ids, probs)
    o_preds = [unicodedata.normalize("NFKC", p) for p in o_preds]
    assert [got[0][0], got[0][2]] == o_preds
    np.testing.assert_allclose([got[1][0], got[1][2]], o_scores, rtol=1e-6)


def test_width_bucket_env(pipelines, monkeypatch):
    rec = pipelines[1].recognizer
    assert rec._default_width_buckets() == [16]  # canvas 32, patch 8
    assert rec._auto_width_buckets is None and rec._width_buckets() is None
    monkeypatch.setattr(rec, "_auto_width_buckets", [16])
    assert rec._width_buckets() == [16]
    for off in ("0", "off", "none", "FALSE"):
        monkeypatch.setenv("YOMITOKU_TPU_REC_WIDTH_BUCKETS", off)
        assert rec._width_buckets() is None
    for env, want in (("8,16", [8, 16]), ("16,8", [8, 16]), ("12,64", None),
                      ("13,0,32,64", None)):
        monkeypatch.setenv("YOMITOKU_TPU_REC_WIDTH_BUCKETS", env)
        assert rec._width_buckets() == want


def test_router_cost_guard(pipelines, monkeypatch):
    """64 narrow + 64 wide lines would pad to 128 at 16 plus 128 at 32, more
    than one 128 at 32: one full-width run; 2 narrow + 1 wide split."""
    rec = pipelines[1].recognizer
    monkeypatch.setenv("YOMITOKU_TPU_REC_WIDTH_BUCKETS", "16")
    seen = []

    def fake_run(page, mats, valid_wh, points, out_w=None):
        seen.append((len(mats), out_w))
        n = len(mats)
        return ["x"] * n, [0.5] * n, ["horizontal"] * n

    monkeypatch.setattr(rec, "_run_batch_inference_page_w", fake_run)
    monkeypatch.setattr(rec._cfg.data, "batch_size", 128)
    mats = np.tile(np.eye(3, dtype=np.float32), (128, 1, 1))
    wh = np.zeros((128, 2), np.int32)
    wh[:64] = (10, 8)
    wh[64:] = (30, 8)
    pts = [[[0, 0], [1, 0], [1, 1], [0, 1]]] * 128
    rec._run_batch_inference_page(None, mats, wh, pts)
    assert seen == [(128, None)]
    seen.clear()
    out = rec._run_batch_inference_page(None, mats[:3], wh[62:65], pts[:3])
    assert sorted(seen) == [(1, None), (2, 16)]
    assert len(out[0]) == 3


def test_width_audit_gates_on_greedy_parity(pipelines, monkeypatch):
    rec = pipelines[1].recognizer
    calls = []

    def decode(fill_narrow):
        def fn(page, mats, wh, out_w=None):
            calls.append(out_w)
            ids = np.full((len(mats), 4), 3 if out_w is None else fill_narrow, np.int64)
            ids[:, -1] = 0  # EOS
            return ids, np.full((len(mats), 4), 0.9, np.float32)
        return fn

    monkeypatch.setattr(rec.model, "forward_tokens_from_page", decode(3))
    assert rec.audit_width_buckets() == [16]
    assert calls == [None, 16]
    monkeypatch.setattr(rec.model, "forward_tokens_from_page", decode(4))
    assert rec.audit_width_buckets() is None


def test_width_audit_runs_the_real_programs(pipelines):
    """Both programs run on the probe page and give a definite verdict
    (random weights make the verdict itself a matter of the seed)."""
    assert pipelines[1].recognizer.audit_width_buckets() in (None, [16])


def test_device_orientation_fallback_matches_jax(pipelines, monkeypatch):
    """The device route's 180-degree retry, at thresholds between the
    lines' scores (none at a score, where rtol 1e-4 could flip the retry)
    and above all of them, with width buckets on."""
    jax_ocr, port = pipelines
    img = synthetic_page()
    monkeypatch.setenv("YOMITOKU_TPU_REC_WIDTH_BUCKETS", "16")
    base, _ = port.recognizer(img, QUADS)
    s = sorted(base.scores)
    threshes = [(a * b) ** 0.5 for a, b in zip(s, s[1:])] + [2.0]
    replaced = 0
    for thresh in threshes:
        for rec in (jax_ocr.recognizer, port.recognizer):
            monkeypatch.setattr(rec, "rec_orientation_fallback", True)
            monkeypatch.setattr(rec, "rec_orientation_fallback_thresh", thresh)
        want, _ = jax_ocr.recognizer(img, QUADS)
        got, _ = port.recognizer(img, QUADS)
        _same_lines(got, want)
        replaced += got.contents != base.contents or got.scores != base.scores
    assert replaced > 0


# ------------------------------------------------------------------ layout modules


def test_layout_parser_page_route_matches_jax(analyzers):
    jax_la, port, img = analyzers
    jpage, page = _pages(img)
    want, _ = jax_la.layout_parser(img, page=jpage)
    got, _ = port.layout_parser(img, page=page)
    assert len(got.tables) >= 1 and len(got.paragraphs) >= 1
    for part in ("paragraphs", "figures", "tables"):
        _same_elements(getattr(got, part), getattr(want, part))


@pytest.mark.parametrize("n_tables", [4, 5])
def test_table_recognizer_page_route_matches_jax(analyzers, n_tables, monkeypatch):
    """4 and 5 tables, each run as one batch of the real tables (the JAX
    package pads 5 to its bucket of 8).  One box reaches past the page and
    is clamped."""
    jax_la, port, img = analyzers
    boxes = [[10, 10, 170, 120], [150, 60, 310, 230], [0, 0, 320, 240],
             [-5, 100, 200, 260], [40, 30, 280, 200]][:n_tables]
    seen = []
    forward = port.table_structure_recognizer.model.forward_from_page
    monkeypatch.setattr(port.table_structure_recognizer.model, "forward_from_page",
                        lambda page, mats, out_hw: seen.append(len(mats))
                        or forward(page, mats, out_hw))
    jpage, page = _pages(img)
    want, _ = jax_la.table_structure_recognizer(img, boxes, page=jpage)
    got, _ = port.table_structure_recognizer(img, boxes, page=page)
    assert seen == [n_tables]
    assert len(got) >= 1
    _same_tables(got, want)


def test_layout_analyzer_module_on_another_device_gets_its_own_page(analyzers,
                                                                    monkeypatch):
    """The table recognizer on another device than the caller's page gets
    the image uploaded to its own device; the layout parser keeps the
    shared page."""
    _, port, img = analyzers
    page = dc.DevicePage(img, "cpu")
    layout, _ = port.layout_parser(img)
    uploads, handed = [], {}

    class Module:
        def __init__(self, name, device, result):
            self.name, self.device, self.result = name, device, result

        def __call__(self, img, *args, vis=None, page=None):
            handed[self.name] = page
            return self.result, vis

    monkeypatch.setattr("yomitoku_tpu_torch.layout_analyzer.DevicePage",
                        lambda im, device: uploads.append(torch.device(device)) or "own")
    monkeypatch.setattr(port, "layout_parser", Module("layout_parser", "cpu", layout))
    monkeypatch.setattr(port, "table_structure_recognizer",
                        Module("table_structure_recognizer", torch.device("cuda", 1), []))
    port(img, page=page)
    assert handed == {"layout_parser": page, "table_structure_recognizer": "own"}
    assert uploads == [torch.device("cuda", 1)]


def test_layout_analyzer_page_route_matches_jax(analyzers):
    jax_la, port, img = analyzers
    jpage, page = _pages(img)
    want, _ = jax_la(img, page=jpage)
    got, _ = port(img, page=page)
    assert len(got.tables) >= 1
    _same_elements(got.paragraphs, want.paragraphs)
    _same_elements(got.figures, want.figures)
    _same_tables(got.tables, want.tables)
