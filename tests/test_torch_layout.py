"""The layout slice as a whole: the port's LayoutParser, its
TableStructureRecognizer and LayoutAnalyzer against the JAX package's, on
the same weights, on a synthetic page; and the host helpers the port
repeats (the JAX modules import JAX) against the JAX functions on the same
inputs.  CPU, f32, config tests/yaml/layout_small.yaml (128x128, 20
queries) for both detectors.

Random weights find nothing a test can compare, so the fixture calibrates
each detector's eval-layer score-head bias from one port pass (each
class's median logit moved to a fixed target), then gives the port's
seeded weights to JAX through ``convert_rtdetr``.  Equal: the tables, the
paragraphs and the figures, boxes and rows/columns/cells; scores within
1e-4 (relative); boxes, which both sides truncate to int, within 1 px."""

import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from yomitoku_tpu import layout_parser as jax_lp
from yomitoku_tpu import table_structure_recognizer as jax_tsr
from yomitoku_tpu.layout_analyzer import LayoutAnalyzer as JaxLayoutAnalyzer
from yomitoku_tpu.models.weights_convert import convert_rtdetr
from yomitoku_tpu.postprocessor.rtdetr_postprocessor import (
    RTDETRPostProcessor as JaxPostProcessor,
)
from yomitoku_tpu.postprocessor.rtdetr_postprocessor import _topk_device
from yomitoku_tpu_torch import layout_parser, table_structure_recognizer
from yomitoku_tpu_torch.layout_analyzer import LayoutAnalyzer
from yomitoku_tpu_torch.layout_parser import LayoutParser
from yomitoku_tpu_torch.postprocessor.rtdetr_postprocessor import (
    RTDETRPostProcessor,
    topk_packed,
)

ROOT = Path(__file__).resolve().parents[1]
SMALL = str(ROOT / "tests/yaml/layout_small.yaml")
CONFIGS = {
    "layout_parser": {"path_cfg": SMALL, "from_pretrained": False},
    "table_structure_recognizer": {"path_cfg": SMALL, "from_pretrained": False},
}
#: score-head targets (logits): tables, figures, paragraphs and the roles;
#: rows, columns, spans
LAYOUT_TARGETS = [0.3, 0.2, 0.3, 0.0, -1.0, -1.0]
TSR_TARGETS = [0.0, 0.0, -2.0]


def synthetic_page():
    page = np.full((240, 320, 3), 255, np.uint8)
    for i in range(6):
        cv2.rectangle(page, (20, 20 + 30 * i), (300, 45 + 30 * i), (0, 0, 0), 1)
        cv2.putText(page, f"row {i}", (30, 38 + 30 * i),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1)
    cv2.line(page, (160, 20), (160, 195), (0, 0, 0), 1)
    return page


def calibrate(model, images, targets):
    """Set the eval layer's score-head bias so that each class's median
    logit over these images lands on its target."""
    head = model.decoder.dec_score_head[model.decoder.eval_idx]
    with torch.no_grad():
        head.bias.zero_()
        median = model(images)["pred_logits"].flatten(0, 1).median(0).values
        head.bias.copy_(torch.tensor(targets) - median)


def share(port_model, jax_model):
    sd = {k: v.numpy() for k, v in port_model.state_dict().items()}
    jax_model.params = convert_rtdetr(sd, jax_model)


@pytest.fixture(scope="module")
def analyzers():
    page = synthetic_page()
    port = LayoutAnalyzer(configs=CONFIGS, device="cpu")
    jax_la = JaxLayoutAnalyzer(configs=CONFIGS, device="cpu")
    lp, tsr = port.layout_parser, port.table_structure_recognizer
    calibrate(lp.model, lp.preprocess(page), LAYOUT_TARGETS)
    share(lp.model, jax_la.layout_parser.model)
    tables = [t.box for t in lp(page)[0].tables]
    crops = np.stack([d["array"] for d in tsr.preprocess(page, tables)])
    calibrate(tsr.model, crops, TSR_TARGETS)
    share(tsr.model, jax_la.table_structure_recognizer.model)
    return jax_la, port, page


def _same_elements(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.abs(np.subtract(g.box, w.box)).max() <= 1, (g.box, w.box)
        assert g.role == w.role
        np.testing.assert_allclose(g.score, w.score, rtol=1e-4)


def _same_tables(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.box == w.box
        assert (g.n_row, g.n_col, len(g.cells)) == (w.n_row, w.n_col, len(w.cells))
        for a, b in zip(g.cells, w.cells):
            assert (a.row, a.col, a.row_span, a.col_span) == (
                b.row, b.col, b.row_span, b.col_span)
            assert np.abs(np.subtract(a.box, b.box)).max() <= 1, (a.box, b.box)
        for part in ("rows", "cols", "spans"):
            _same_boxes(getattr(g, part), getattr(w, part))


def _same_boxes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.abs(np.subtract(g.box, w.box)).max() <= 1, (g.box, w.box)
        np.testing.assert_allclose(g.score, w.score, rtol=1e-4)


def test_layout_analyzer_matches_jax(analyzers):
    jax_la, port, page = analyzers
    want, _ = jax_la(page)
    got, vis = port(page)
    assert vis is None
    assert len(got.tables) >= 2 and len(got.paragraphs) >= 2
    assert sum(t.n_row * t.n_col for t in got.tables) > 0
    _same_elements(got.paragraphs, want.paragraphs)
    _same_elements(got.figures, want.figures)
    _same_tables(got.tables, want.tables)


def test_table_structure_recognizer_batches_given_boxes(analyzers):
    """The TSR alone on fixed table boxes: one batched forward for all."""
    jax_la, port, page = analyzers
    boxes = [[10, 10, 170, 120], [150, 60, 310, 230], [0, 0, 320, 240]]
    want, _ = jax_la.table_structure_recognizer(page, boxes)
    got, _ = port.table_structure_recognizer(page, boxes)
    assert len(got) >= 1
    _same_tables(got, want)


def test_visualization_matches_jax(analyzers):
    jax_la, port, page = analyzers
    for m in (jax_la.layout_parser, jax_la.table_structure_recognizer,
              port.layout_parser, port.table_structure_recognizer):
        m.visualize = True
    try:
        _, want = jax_la(page)
        _, got = port(page)
    finally:
        for m in (jax_la.layout_parser, jax_la.table_structure_recognizer,
                  port.layout_parser, port.table_structure_recognizer):
            m.visualize = False
    assert got.shape == page.shape
    assert np.mean(got != want) < 0.01  # only where a box moved by a pixel


def _boxes(rng, n):
    """Random boxes, some inside others and some equal to others."""
    x1, y1 = rng.randint(0, 200, n), rng.randint(0, 200, n)
    b = np.stack([x1, y1, x1 + rng.randint(5, 80, n), y1 + rng.randint(5, 80, n)], 1)
    b[1::4] = b[0::4][: len(b[1::4])] + [2, 2, -2, -2]
    b[2::5] = b[0::5][: len(b[2::5])]
    return b.tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_containment_filters_match_jax(seed):
    cats = ("tables", "paragraphs", "figures")

    def elements():
        rs = np.random.RandomState(seed)
        return {c: [{"box": b, "score": 0.5, "role": None}
                    for b in _boxes(rs, 12)] for c in cats}

    got = layout_parser.filter_contained_rectangles_within_category(elements())
    want = jax_lp.filter_contained_rectangles_within_category(elements())
    assert got == want
    got = layout_parser.filter_contained_rectangles_across_categories(
        elements(), "tables", "paragraphs")
    want = jax_lp.filter_contained_rectangles_across_categories(
        elements(), "tables", "paragraphs")
    assert got == want


@pytest.mark.parametrize("seed", [0, 1])
def test_cell_extraction_and_span_merge_match_jax(seed):
    rng = np.random.RandomState(seed)
    rows = sorted(([0, 10 * i, 200, 10 * i + 12] for i in range(6)), key=lambda b: b[1])
    cols = sorted(([30 * j, 0, 30 * j + 32, 70] for j in range(5)), key=lambda b: b[0])
    rows[2][1] += int(rng.randint(0, 3))
    spans = [[0, 0, 64, 24], [90, 30, 150, 70], [5, 5, 6, 6]]
    got = table_structure_recognizer.extract_cells(rows, cols)
    want = jax_tsr.extract_cells(rows, cols)
    assert got == want and len(got) > 0
    got = table_structure_recognizer.filter_contained_cells_within_spancell(got, spans)
    want = jax_tsr.filter_contained_cells_within_spancell(want, spans)
    assert got == want
    assert any(c["row_span"] > 1 or c["col_span"] > 1 for c in got)


def test_postprocessor_matches_jax():
    """Device top-k over queries x classes (no ties among the random
    scores), then the host threshold and clamp."""
    rng = np.random.RandomState(5)
    logits = rng.randn(3, 30, 6).astype(np.float32)
    boxes = rng.uniform(0.0, 1.0, (3, 30, 4)).astype(np.float32)
    sizes = np.array([[320, 240], [100, 300], [640, 640]], np.float32)
    want = np.asarray(_topk_device(logits, boxes, sizes, 30))
    got = topk_packed(*map(torch.from_numpy, (logits, boxes, sizes)), 30).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    port, jax_pp = RTDETRPostProcessor(6, 30), JaxPostProcessor(6, 30)
    out = port({"pred_logits": torch.from_numpy(logits),
                "pred_boxes": torch.from_numpy(boxes)}, sizes, 0.5)
    ref = jax_pp.filter_packed(want, sizes, 0.5)
    assert len(out) == 3
    for g, w in zip(out, ref):
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-6)


def test_cuda_device_raises_without_cuda():
    """device="cuda" never turns into a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        LayoutParser(path_cfg=SMALL, device="cuda", from_pretrained=False)


def test_layout_runs_without_jax():
    """Importing and running the layout slice on the CPU leaves jax and
    flax out of sys.modules."""
    script = f"""
import sys
import numpy as np
from yomitoku_tpu_torch import LayoutAnalyzer, LayoutParser, TableStructureRecognizer
from yomitoku_tpu_torch.ops import ms_deformable_attention
la = LayoutAnalyzer(configs={CONFIGS!r}, device="cpu")
page = np.full((96, 128, 3), 255, np.uint8)
page[20:60, 10:100] = 0
result, _ = la(page)
tables, _ = la.table_structure_recognizer(page, [[0, 0, 128, 96]])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "jaxlib"))
assert not bad, bad
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
