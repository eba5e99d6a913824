"""The fused page program's pieces (yomitoku_tpu_torch/ops/fused_page.py)
against the JAX package's (yomitoku_tpu/ops/fused_page.py), CPU, f32, and
the program against its parts within the port.

Held against JAX: ``FusedDetLayout`` on the same weights and page (the
detector's map within one uint8 quantum, each of the layout's top-k rows
held to the one row of JAX's with its label, score within 1e-4 and box
within 1e-2 px); ``_split_wire`` on the same wire bytes
and ``consume_region_slots`` on the same wires and regions (slot hits,
the capped wire's saturation re-dispatched with a warning, unmatched and
invalid slots on the chunked route), equal; the slot selection on
hand-made layout rows (ties, boxes off the page, scores below the
threshold, other labels, more than four tables, none, degenerate boxes)
against the JAX program's own arithmetic (``FusedPageAnalysis._fwd`` with
its models stubbed), as sets keyed by box, with each slot's size and its
crop's mean colour (within 5e-3 on the 0-255 scale).  Within the port:
``dispatch_regions_from_page`` + ``collect_filtered_regions`` equal to
``filtered_regions_from_page``; the padded 1x1 slot's crop finite and
the slot dropped by its validity; the whole program's wire equal to the
detector, the layout parser and the region model called alone on the
same maps, with and without an executor."""

import logging
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_layout import LAYOUT_TARGETS, calibrate, share
from test_torch_rtdetr import numpy_state
from yomitoku_tpu import config as jax_config
from yomitoku_tpu.configs import (
    LayoutParserRTDETRv2V2Config as JaxLayoutConfig,
    TextDetectorDBNetV2_1Config as JaxDetConfig,
)
from yomitoku_tpu.models.dbnet import DBNet as JaxDBNet
from yomitoku_tpu.models.rtdetr import RTDETRv2 as JaxRTDETRv2
from yomitoku_tpu.models.weights_convert import convert_dbnet
from yomitoku_tpu.ops import device_crop as jdc
from yomitoku_tpu.ops import fused_page as jfp
from yomitoku_tpu.postprocessor.rtdetr_postprocessor import (
    RTDETRPostProcessor as JaxPostProcessor,
)
from yomitoku_tpu_torch import config as port_config
from yomitoku_tpu_torch import table_structure_recognizer as port_tsr
from yomitoku_tpu_torch.layout_parser import preprocess_rtdetr
from yomitoku_tpu_torch.configs import (
    LayoutParserRTDETRv2V2Config,
    TextDetectorDBNetV2_1Config,
)
from yomitoku_tpu_torch.models.dbnet import DBNet
from yomitoku_tpu_torch.models.rtdetr import RTDETRv2
from yomitoku_tpu_torch.ops import device_crop as dc
from yomitoku_tpu_torch.ops import fused_page as pfp
from yomitoku_tpu_torch.ops.separable_resize import sample_regions_separable
from yomitoku_tpu_torch.postprocessor.rtdetr_postprocessor import RTDETRPostProcessor

ROOT = Path(__file__).resolve().parents[1]
DET_YAML = ROOT / "tests" / "yaml" / "det_small.yaml"
LAYOUT_YAML = ROOT / "tests" / "yaml" / "layout_small.yaml"
DET_HW, LAY_HW, REGION_HW = (64, 96), (128, 128), (128, 128)


def page_image(h=150, w=230, seed=3):
    rng = np.random.RandomState(seed)
    page = np.full((h, w, 3), 255, np.uint8)
    for _ in range(14):
        x0, y0 = rng.randint(0, w - 60), rng.randint(0, h - 30)
        page[y0:y0 + 20, x0:x0 + 55] = rng.randint(0, 160, 3)
    return page


@pytest.fixture(scope="module")
def models():
    """The port's detector (det_small.yaml), layout parser and region
    model (layout_small.yaml; the layout's score head calibrated), and
    the JAX detector and layout parser on the same weights."""
    torch.manual_seed(0)
    det = DBNet(port_config.load_config(TextDetectorDBNetV2_1Config, DET_YAML), device="cpu")
    with torch.no_grad():
        det.decoder.binarize[6].weight.mul_(10.0)
    lay_cfg = port_config.load_config(LayoutParserRTDETRv2V2Config, LAYOUT_YAML)
    lay = RTDETRv2(lay_cfg, device="cpu")
    region = RTDETRv2(lay_cfg, device="cpu")
    img = page_image()
    calibrate(lay, preprocess_rtdetr(img, LAY_HW), LAYOUT_TARGETS)
    jdet = JaxDBNet(jax_config.load_config(JaxDetConfig, DET_YAML))
    jdet.params = convert_dbnet(numpy_state(det), jdet)
    jlay = JaxRTDETRv2(jax_config.load_config(JaxLayoutConfig, LAYOUT_YAML))
    share(lay, jlay)
    return dict(det=det, lay=lay, region=region, jdet=jdet, jlay=jlay, img=img)


def _pages(img):
    return jdc.DevicePage(img), dc.DevicePage(img, "cpu")


def test_fused_det_layout_matches_jax(models):
    img = models["img"]
    jpage, page = _pages(img)
    k = 20
    want_prob, want_packed = jfp.FusedDetLayout(models["jdet"], models["jlay"], k)(
        jpage, jpage.hw, DET_HW, LAY_HW)
    prog = pfp.FusedDetLayout(models["det"], models["lay"], k)
    got_prob, got_packed = prog(page, page.hw, DET_HW, LAY_HW)
    assert got_prob.dtype == np.uint8 and got_prob.shape == want_prob.shape == (1,) + DET_HW
    assert np.abs(got_prob.astype(int) - want_prob.astype(int)).max() <= 1
    assert got_prob.std() > 0
    # rows whose scores lie closer than the two sides' rounding may trade
    # places: each row is held to the one row of the other side with its
    # label, its score within 1e-4 and its box within 1e-2 px
    matched = [
        [j for j, w in enumerate(want_packed[0])
         if w[0] == g[0] and abs(w[1] - g[1]) <= 1e-4 and np.abs(w[2:] - g[2:]).max() <= 1e-2]
        for g in got_packed[0]]
    assert all(len(m) == 1 for m in matched), matched
    assert sorted(m[0] for m in matched) == list(range(k))
    with ThreadPoolExecutor(2) as pool:
        threaded = prog(page, page.hw, DET_HW, LAY_HW, executor=pool)
    np.testing.assert_array_equal(threaded[0], got_prob)
    np.testing.assert_array_equal(threaded[1], got_packed)


# ------------------------------------------------------------- host halves


def _programs(monkeypatch, cap, lay_k=5, tsr_k=10, max_tables=4):
    monkeypatch.setenv("YOMITOKU_TPU_FUSED_REGION_TOPK", str(cap))
    kwargs = dict(lay_top_k=lay_k, tsr_top_k=tsr_k, table_label=0, lay_thresh=0.5,
                  max_tables=max_tables)
    return (jfp.FusedPageAnalysis(JaxDBNet, None, None, **kwargs),
            pfp.FusedPageAnalysis(None, None, None, **kwargs))


@pytest.mark.parametrize("cap", [0, 4, 64])
def test_cap_and_wire_split_match_jax(monkeypatch, cap):
    jprog, prog = _programs(monkeypatch, cap)
    assert (prog.tsr_k, prog.tsr_full_k) == (jprog.tsr_k, jprog.tsr_full_k)
    rng = np.random.default_rng(cap)
    K, k, q, hw = prog.max_tables, prog.lay_k, prog.tsr_k, (6, 10)
    parts = [rng.integers(0, 256, hw[0] * hw[1]).astype(np.uint8)]
    for arr in (rng.normal(size=(1, k, 6)), rng.normal(size=(K, q, 6)),
                rng.integers(0, 500, (K, 4)), rng.integers(0, 2, K)):
        parts.append(np.asarray(arr, np.float32).reshape(-1).view(np.uint8))
    wire = np.concatenate(parts)
    want = jprog._split_wire(wire, hw)
    got = prog._split_wire(wire, hw)
    for name, g, w in zip(("prob", "packed", "packed_t", "sel", "valid"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _rows(scores, k):
    """(1, k, 6) region rows [label, score, x1, y1, x2, y2]."""
    rows = np.zeros((1, k, 6), np.float32)
    for i, s in enumerate(scores):
        rows[0, i] = [1.0, s, 1.0, 1.0, 5.0, 5.0]
    return rows


def _consume_both(monkeypatch, cap, tsr_k, region_data, packed_t, sel, valid):
    jprog, prog = _programs(monkeypatch, cap, tsr_k=tsr_k)
    want = jprog.consume_region_slots(region_data, packed_t, sel, valid,
                                      JaxPostProcessor(num_classes=8, num_top_queries=tsr_k),
                                      0.5)
    got = prog.consume_region_slots(region_data, packed_t, sel, valid,
                                    RTDETRPostProcessor(num_classes=8, num_top_queries=tsr_k),
                                    0.5)
    assert got[1:] == want[1:]
    for g, w in zip(got[0], want[0]):
        assert (g is None) == (w is None)
        if g is not None:
            for key in ("labels", "boxes", "scores"):
                np.testing.assert_array_equal(g[key], w[key])
    return got


REGIONS = [{"offset": (0, 0), "size": (10, 10)}, {"offset": (20, 0), "size": (10, 10)},
           {"offset": (5, 5), "size": (10, 10)}, {"offset": (0, 0), "size": (1, 1)}]


def test_consume_region_slots_matches_jax(monkeypatch, capfd):
    """Slot 0 saturated under the cap (re-dispatched, loudly), slot 1 kept,
    region 2 held by no slot, region 3's box held only by an invalid
    (padded) slot."""
    sel = np.array([[0, 0, 10, 10], [20, 0, 30, 10], [40, 40, 50, 50], [0, 0, 1, 1]], np.int64)
    valid = np.array([True, True, True, False])
    packed_t = np.stack([_rows([0.9, 0.8, 0.7, 0.6], 4), _rows([0.9, 0.8, 0.2, 0.1], 4),
                         _rows([0.9], 4), _rows([0.9], 4)])
    filtered, missing_idx, missing_data = _consume_both(
        monkeypatch, 4, 10, REGIONS, packed_t, sel, valid)
    assert missing_idx == [0, 2, 3] and missing_data == [REGIONS[i] for i in (0, 2, 3)]
    assert len(filtered[1]["scores"]) == 2
    assert capfd.readouterr().err.count("saturated") == 2  # JAX's and the port's


def test_uncapped_slot_keeps_its_full_list(monkeypatch, capfd):
    sel = np.array([[0, 0, 10, 10]], np.int64)
    filtered, missing_idx, _ = _consume_both(
        monkeypatch, 64, 4, REGIONS[:1], _rows([0.9, 0.8, 0.7, 0.6], 4)[None], sel,
        np.array([True]))
    assert missing_idx == [] and len(filtered[0]["scores"]) == 4
    assert "saturated" not in capfd.readouterr().err


# ------------------------------------------------------------ slot geometry


W, H = 230, 150
#: hand-made layout rows [label, score, x1, y1, x2, y2] (label 0: table,
#: threshold 0.5), each case padded to 12 rows with non-tables
SLOT_CASES = {
    "ties": [[0, 0.9, 10.7, 5.2, 80.9, 60.1], [0, 0.9, 100.0, 5.0, 180.5, 70.0],
             [0, 0.8, 10.0, 80.0, 90.0, 140.0], [1, 0.95, 0, 0, 50, 50]],
    "off_page": [[0, 0.9, -20.5, -3.0, 60.2, 40.0], [0, 0.8, 150.0, 90.0, 400.0, 300.0],
                 [0, 0.7, 240.0, 10.0, 260.0, 50.0], [0, 0.6, 10.0, -50.0, 40.0, -5.0]],
    "below_threshold": [[0, 0.45, 10.0, 10.0, 60.0, 60.0], [0, 0.55, 70.0, 10.0, 120.0, 60.0],
                        [2, 0.99, 0, 0, 200, 100], [0, 0.5, 10.0, 80.0, 60.0, 120.0]],
    "more_than_four": [[0, 0.9 - 0.05 * i, 5.0 + 30 * i, 10.0 + 3 * i, 30.0 + 30 * i,
                        60.0 + 5 * i] for i in range(7)],
    "none": [[1, 0.9, 0, 0, 50, 50], [3, 0.8, 10, 10, 40, 40]],
    "degenerate": [[0, 0.9, 50.0, 50.0, 40.0, 60.0], [0, 0.8, 30.2, 30.0, 30.9, 70.0],
                   [0, 0.7, 60.0, 20.0, 120.0, 90.0]],
}


def _slot_rows(case):
    rows = np.zeros((1, 12, 6), np.float32)
    rows[0, :, 0] = 5.0
    rows[0, :, 1] = 0.1
    for i, r in enumerate(SLOT_CASES[case]):
        rows[0, i] = r
    return rows


def _jax_slots(monkeypatch, packed, jpage):
    """The JAX program's wire for ``packed`` as the layout's top-k, its
    detector and models stubbed: the region rows carry each slot's (w, h)
    and its crop's mean colour."""
    import jax.numpy as jnp

    calls = []

    def topk(logits, boxes, sizes, k):
        calls.append(k)
        if len(calls) == 1:
            return jnp.asarray(packed)
        return jnp.concatenate([sizes, logits, jnp.zeros((sizes.shape[0], 1))], -1)[:, None]

    monkeypatch.setattr(jfp, "_topk_device", topk)
    monkeypatch.setattr(jfp, "DBNet", types.SimpleNamespace(
        _forward_from_page=lambda self, p, page, mat, hw: jnp.zeros((1,) + hw, jnp.uint8)))
    monkeypatch.setattr(jfp, "RTDETRv2", types.SimpleNamespace(
        _forward_from_page=lambda self, p, page, mat, hw: {"pred_logits": None,
                                                           "pred_boxes": None}))
    region = types.SimpleNamespace(dtype=jnp.float32, core=types.SimpleNamespace(
        apply=lambda params, x: {"pred_logits": x.mean(axis=(1, 2)) * 255.0,
                                 "pred_boxes": None}))
    prog = jfp.FusedPageAnalysis(JaxDBNet, None, region, lay_top_k=12, tsr_top_k=1,
                                 table_label=0, lay_thresh=0.5)
    wire = jfp.FusedPageAnalysis._fwd(
        prog, None, None, None, jpage.dev, None, (8, 8), None, (8, 8), REGION_HW,
        jnp.asarray([[W, H]], jnp.float32))
    _, _, packed_t, sel, valid = prog._split_wire(np.asarray(wire), (8, 8))
    return sel, valid, packed_t[:, 0, 0, :2], packed_t[:, 0, 0, 2:5]


@pytest.mark.parametrize("case", list(SLOT_CASES))
def test_slot_selection_matches_jax(monkeypatch, case):
    img = page_image()
    jpage, page = _pages(img)
    packed = _slot_rows(case)
    want_sel, want_valid, want_sizes, want_means = _jax_slots(monkeypatch, packed, jpage)
    sel, valid, mats, sizes = pfp.select_slots(
        torch.from_numpy(packed), dc.staged_wh(W, H, "cpu"), 0, 0.5, 4, REGION_HW)
    crops = sample_regions_separable(page.dev, mats, REGION_HW, flip_bgr=True)
    assert torch.isfinite(crops).all()
    sel = sel.numpy().astype(np.int64)
    valid = valid.numpy()
    assert valid.sum() == want_valid.sum()
    got = {tuple(b): (s, m) for b, v, s, m in zip(sel.tolist(), valid, sizes.numpy(),
                                                   crops.mean((1, 2)).numpy()) if v}
    want = {tuple(b): (s, m) for b, v, s, m in zip(want_sel.tolist(), want_valid,
                                                   want_sizes, want_means) if v}
    assert got.keys() == want.keys()
    for box, (s, m) in got.items():
        np.testing.assert_array_equal(s, want[box][0])
        np.testing.assert_allclose(m, want[box][1], atol=5e-3)
        assert s.tolist() == [box[2] - box[0], box[3] - box[1]]
    # padded and degenerate slots crop the 1x1 corner on both sides
    assert all(tuple(b) == (0, 0, 1, 1) for b, v in zip(sel.tolist(), valid) if not v)
    assert all(tuple(b) == (0, 0, 1, 1) for b, v in zip(want_sel.tolist(), want_valid)
               if not v)
    # the maps are the host's region_mats of the slots, bit for bit
    np.testing.assert_array_equal(mats.numpy(), dc.region_mats(sel.tolist(), REGION_HW)[0])


def test_slot_at_the_tie_edge_is_a_top_score():
    """Five tables, the fourth and fifth tied: the slots hold the three
    above the tie and one of the two."""
    rows = np.zeros((1, 12, 6), np.float32)
    rows[0, :, 0] = 5.0
    for i, s in enumerate([0.9, 0.8, 0.7, 0.6, 0.6]):
        rows[0, i] = [0, s, 10.0 + 40 * i, 10.0, 40.0 + 40 * i, 60.0]
    sel, valid, _, _ = pfp.select_slots(
        torch.from_numpy(rows), dc.staged_wh(W, H, "cpu"), 0, 0.5, 4, REGION_HW)
    x1 = sorted(int(b[0]) for b in sel.tolist())
    assert valid.all() and x1[:3] == [10, 50, 90] and x1[3] in (130, 170)


# ------------------------------------------------------------ within the port


def test_dispatch_and_collect_equal_filtered_regions(models, monkeypatch):
    img = models["img"]
    page = dc.DevicePage(img, "cpu")
    post = RTDETRPostProcessor(num_classes=6, num_top_queries=20)
    data = [{"offset": (0, 0), "size": (150, 230)}, {"offset": (10, 20), "size": (90, 120)},
            {"offset": (150, 60), "size": (80, 70)}]
    want = port_tsr.filtered_regions_from_page(models["region"], page, data, REGION_HW,
                                               post, 0.3)
    monkeypatch.setattr(dc, "REGION_CHUNK", 2)
    chunks = port_tsr.dispatch_regions_from_page(models["region"], page, data, REGION_HW)
    assert [len(sizes) for _, sizes in chunks] == [2, 1]
    assert all(isinstance(p["pred_logits"], torch.Tensor) for p, _ in chunks)
    got = port_tsr.collect_filtered_regions(chunks, post, 0.3)
    assert len(got) == 3 and any(len(g["scores"]) for g in got)
    for g, w in zip(got, want):
        for key in ("labels", "boxes", "scores"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, atol=1e-4)


def test_padded_slot_is_finite_and_dropped(monkeypatch):
    """The 1x1 corner's crop is finite; a host table at (0, 0, 1, 1) is
    not matched to a padded slot of that box."""
    page = dc.DevicePage(page_image(), "cpu")
    mats = torch.from_numpy(dc.region_mats([(0, 0, 1, 1)], REGION_HW)[0])
    crop = sample_regions_separable(page.dev, mats, REGION_HW, flip_bgr=True)
    assert torch.isfinite(crop).all() and crop.shape == (1,) + REGION_HW + (3,)
    _, prog = _programs(monkeypatch, 0, tsr_k=4)
    sel = np.array([[0, 0, 1, 1]] * 4, np.int64)
    filtered, missing_idx, _ = prog.consume_region_slots(
        [REGIONS[3]], np.stack([_rows([0.9], 4)] * 4), sel, np.zeros(4, bool),
        RTDETRPostProcessor(num_classes=8, num_top_queries=4), 0.5)
    assert filtered == [None] and missing_idx == [0]


def test_program_equals_its_parts(models, caplog):
    """The wire of the whole program against the detector, the layout
    parser's top-k and the region model on the host's maps of the slots,
    called alone: equal."""
    img = models["img"]
    page = dc.DevicePage(img, "cpu")
    post = RTDETRPostProcessor(num_classes=6, num_top_queries=20)
    prog = pfp.FusedPageAnalysis(models["det"], models["lay"], models["region"],
                                 lay_top_k=20, tsr_top_k=20, table_label=0, lay_thresh=0.3)
    with ThreadPoolExecutor(2) as pool:
        prob, packed, packed_t, sel, valid = prog(page, page.hw, DET_HW, LAY_HW, REGION_HW,
                                                  executor=pool)
    inline = prog(page, page.hw, DET_HW, LAY_HW, REGION_HW)
    for a, b in zip(inline, (prob, packed, packed_t, sel, valid)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        prob, models["det"].forward_binary_from_page(page.dev, page.hw, DET_HW))
    lay_mat = dc.staged_page_mat(page.hw, LAY_HW, "cpu")
    want_packed = post.topk_on_device(
        models["lay"].forward_from_page(page.dev, lay_mat, LAY_HW), [[W, H]]).numpy()
    np.testing.assert_array_equal(packed, want_packed)
    assert valid.sum() >= 2, "the layout kept fewer than two tables above 0.3"
    preds = models["region"].forward_from_page(
        page.dev, dc.region_mats(sel.tolist(), REGION_HW)[0], REGION_HW)
    sizes = [[x2 - x1, y2 - y1] for x1, y1, x2, y2 in sel.tolist()]
    want_t = post.topk_on_device(preds, sizes).numpy()
    np.testing.assert_array_equal(packed_t[:, 0], want_t)
    assert packed.shape == (1, 20, 6) and packed_t.shape == (4, 1, 20, 6)
    assert sel.dtype == np.int64 and valid.dtype == bool
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING]
