"""The slice as a whole: the port's TextDetector, TextRecognizer and OCR
against the JAX package's, on the same weights (JAX seeded init carried
across by ``state_dict_from_jax``), on a synthetic page, CPU, f32.

Small configs: the detector of tests/yaml/det_small.yaml (dbnetv2_1
weights, 64/96 resize; the port's seeded init given to JAX through
convert_dbnet) with its last transposed conv scaled by 10, so that
random weights give a structured map with several quads; the recognizer
of tests/yaml/rec_small.yaml (parseq-large-v4_1 charset, D=32; the JAX
seeded init given to the port through state_dict_from_jax).
Quads and strings must be equal; scores agree to rtol 1e-4.  The task
modules take the JAX package's arguments and return its (schema, vis)
pairs; visualisations are equal pixel for pixel, and the host route's
180-degree orientation fallback gives the same strings and scores."""

import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from yomitoku_tpu.document_analyzer import DocumentAnalyzer as JaxDocumentAnalyzer
from yomitoku_tpu.layout_analyzer import LayoutAnalyzer as JaxLayoutAnalyzer
from yomitoku_tpu.layout_parser import LayoutParser as JaxLayoutParser
from yomitoku_tpu.models.weights_convert import convert_dbnet
from yomitoku_tpu.ocr import OCR as JaxOCR
from yomitoku_tpu.table_structure_recognizer import (
    TableStructureRecognizer as JaxTableStructureRecognizer,
)
from yomitoku_tpu.text_detector import TextDetector as JaxTextDetector
from yomitoku_tpu.text_recognizer import TextRecognizer as JaxTextRecognizer
from yomitoku_tpu.utils import visualizer as jax_vis
from yomitoku_tpu_torch.data.functions import resize_with_padding
from yomitoku_tpu_torch.document_analyzer import DocumentAnalyzer
from yomitoku_tpu_torch.layout_analyzer import LayoutAnalyzer
from yomitoku_tpu_torch.layout_parser import LayoutParser
from yomitoku_tpu_torch.ocr import OCR
from yomitoku_tpu_torch.table_structure_recognizer import TableStructureRecognizer
from yomitoku_tpu_torch.text_detector import TextDetector
from yomitoku_tpu_torch.text_recognizer import TextRecognizer
from yomitoku_tpu_torch.utils import visualizer as port_vis
from yomitoku_tpu_torch.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {
    "text_detector": {"path_cfg": str(ROOT / "tests/yaml/det_small.yaml"),
                      "from_pretrained": False},
    "text_recognizer": {"path_cfg": str(ROOT / "tests/yaml/rec_small.yaml"),
                        "from_pretrained": False},
}
QUADS = [
    [[8, 4], [120, 4], [120, 22], [8, 22]],
    [[8, 30], [150, 30], [150, 48], [8, 48]],
    [[10, 55], [90, 58], [89, 74], [9, 71]],   # skewed
    [[150, 50], [170, 50], [170, 115], [150, 115]],  # vertical
]


def synthetic_page():
    page = np.full((120, 180, 3), 255, np.uint8)
    for i, y in enumerate(range(18, 110, 25)):
        cv2.putText(page, f"line {i} ABC", (10, y), cv2.FONT_HERSHEY_SIMPLEX,
                    0.6, (0, 0, 0), 2)
    return page


@pytest.fixture(scope="module")
def pipelines():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YOMITOKU_TPU_INT8_KV", "0")
        jax_ocr = JaxOCR(configs=CONFIGS, device="cpu")
        port = OCR(configs=CONFIGS, device="cpu")
        # detector: the port's seeded init, head scaled, to JAX
        det = port.detector.model
        with torch.no_grad():
            det.decoder.binarize[6].weight.mul_(10.0)
        sd = {k: v.numpy() for k, v in det.state_dict().items()}
        jax_ocr.detector.model.params = convert_dbnet(sd, jax_ocr.detector.model)
        # recognizer: the JAX seeded init, to the port
        rec = jax_ocr.recognizer.model
        assert not rec.int8_kv
        rec.params = rec.init_params(0)
        port.recognizer.model.load_state_dict(
            state_dict_from_jax(rec.params, port.recognizer.model)
        )
        yield jax_ocr, port


def test_detector_quads_equal(pipelines):
    jax_ocr, port = pipelines
    page = synthetic_page()
    want, _ = jax_ocr.detector(page)
    got, vis = port.detector(page)
    assert vis is None
    assert len(want.points) > 1
    assert got.points == want.points
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4)


def test_recognizer_strings_equal_on_given_quads(pipelines):
    jax_ocr, port = pipelines
    page = synthetic_page()
    want, _ = jax_ocr.recognizer(page, QUADS)
    got, vis = port.recognizer(page, QUADS)
    assert vis is None
    assert len(got.contents) == len(QUADS)
    assert got.contents == want.contents
    assert got.points == want.points
    assert got.directions == want.directions
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4)


def test_ocr_schema_equal(pipelines):
    jax_ocr, port = pipelines
    page = synthetic_page()
    want, _ = jax_ocr(page)
    got, vis = port(page)
    assert vis is None
    assert len(got.words) == len(want.words) > 1
    for g, w in zip(got.words, want.words):
        assert (g.points, g.content, g.direction) == (w.points, w.content, w.direction)
        np.testing.assert_allclose([g.det_score, g.rec_score],
                                   [w.det_score, w.rec_score], rtol=1e-4)


def test_port_runs_without_jax():
    """Importing and running the port (CPU forward of both models) leaves
    jax and flax out of sys.modules."""
    script = f"""
import sys
import numpy as np
from yomitoku_tpu_torch import OCR
ocr = OCR(configs={CONFIGS!r}, device="cpu")
page = np.full((64, 96, 3), 255, np.uint8)
page[20:40, 10:80] = 0
result, _ = ocr(page)
words, _ = ocr.recognizer(page, [[[10, 20], [80, 20], [80, 40], [10, 40]]])
assert len(words.contents) == 1
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


def test_reference_checkpoint_loads(tmp_path, monkeypatch):
    """A reference-layout pytorch_model.bin in the weight store loads as
    it is; the keys inference never reads (BatchNorm counters, DBNet's
    threshold head) are dropped."""
    monkeypatch.setenv("YOMITOKU_TPU_WEIGHTS", str(tmp_path))
    cfg = CONFIGS["text_detector"]["path_cfg"]
    src = TextDetector(path_cfg=cfg, device="cpu", from_pretrained=False).model
    sd = {k: v + 1.0 for k, v in src.state_dict().items()}
    sd["backbone.body.bn1.num_batches_tracked"] = torch.tensor(3)
    sd["decoder.thresh.0.weight"] = torch.zeros(4, 4, 3, 3)
    ckpt = tmp_path / "yomitoku-text-detector-dbnet-v2_1" / "pytorch_model.bin"
    ckpt.parent.mkdir()
    torch.save(sd, ckpt)
    det = TextDetector(path_cfg=cfg, device="cpu").model
    assert det.pretrained_source == "torch"
    for k, v in det.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


def test_cuda_device_raises_without_cuda():
    """device="cuda" never turns into a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TextRecognizer(path_cfg=CONFIGS["text_recognizer"]["path_cfg"],
                       device="cuda", from_pretrained=False)
    with pytest.raises(RuntimeError, match="cuda"):
        OCR(configs=CONFIGS, device="cuda")


# ---------------------------------------------------------------- the call API

API_PAIRS = [(TextDetector, JaxTextDetector), (TextRecognizer, JaxTextRecognizer),
             (OCR, JaxOCR), (LayoutParser, JaxLayoutParser),
             (TableStructureRecognizer, JaxTableStructureRecognizer),
             (LayoutAnalyzer, JaxLayoutAnalyzer), (DocumentAnalyzer, JaxDocumentAnalyzer)]


_NO_DEFAULT = object()


def _params(cls, method):
    """{name: default} of ``cls.method`` in the order of its source: read
    from the module's syntax tree, since instantiating a task module wraps
    its ``__call__`` in a (*args, **kwargs) timing observer."""
    tree = ast.parse(inspect.getsource(inspect.getmodule(cls)))
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.ClassDef) and n.name == cls.__name__)
    fn = next(n for n in node.body if isinstance(n, ast.FunctionDef) and n.name == method)
    args = fn.args.args[1:]  # without self
    defaults = [_NO_DEFAULT] * (len(args) - len(fn.args.defaults)) + [
        ast.literal_eval(d) for d in fn.args.defaults]
    return dict(zip((a.arg for a in args), defaults))


@pytest.mark.parametrize("method", ["__init__", "__call__"])
@pytest.mark.parametrize("port_cls, jax_cls", API_PAIRS,
                         ids=[p.__name__ for p, _ in API_PAIRS])
def test_task_signatures_match_jax(port_cls, jax_cls, method):
    """The same parameter names in the same order and, but for the device
    (CUDA here, the TPU there), the same defaults; ``dtype`` is the port's
    own extra."""
    got, want = _params(port_cls, method), _params(jax_cls, method)
    assert [n for n in got if n != "dtype"] == list(want)
    for name, default in want.items():
        if name != "device":
            assert got[name] == default, name
    if "device" in want:
        assert got["device"] == "cuda"


def _visualize_on(monkeypatch, *pipelines):
    for ocr in pipelines:
        monkeypatch.setattr(ocr.detector, "visualize", True)
        monkeypatch.setattr(ocr.recognizer, "visualize", True)


def test_visualize_matches_jax(pipelines, monkeypatch):
    """visualize=True: the detector's quads, the recognizer's text drawn on
    a given canvas or a copy of the page, and OCR's combined picture are
    equal to the JAX modules' on the same weights and page."""
    jax_ocr, port = pipelines
    _visualize_on(monkeypatch, jax_ocr, port)
    page = synthetic_page()
    (_, want), (_, got) = jax_ocr.detector(page), port.detector(page)
    assert got.shape == page.shape and not np.array_equal(got, page)
    np.testing.assert_array_equal(got, want)
    for canvas in (None, np.zeros_like(page)):
        _, want = jax_ocr.recognizer(page, QUADS, vis=canvas)
        _, got = port.recognizer(page, QUADS, vis=canvas)
        np.testing.assert_array_equal(got, want)
    (_, want), (_, got) = jax_ocr(page), port(page)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("as_u8", [True, False])
def test_det_visualizer_heatmap_matches_jax(as_u8):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)
    preds = rng.random((20, 30)).astype(np.float32)
    if as_u8:
        preds = (preds * 255).astype(np.uint8)
    quads = [[[2, 3], [30, 3], [30, 15], [2, 15]]]
    np.testing.assert_array_equal(
        port_vis.det_visualizer(img, quads, preds=preds, vis_heatmap=True),
        jax_vis.det_visualizer(img, quads, preds=preds, vis_heatmap=True))


def test_orientation_fallback_matches_jax(pipelines, monkeypatch):
    """The host route's 180-degree fallback: at thresholds around the
    lines' scores, both packages retry the same lines, keep the same
    rotated readings and return the same strings and scores; at one of
    them at least one line is replaced."""
    jax_ocr, port = pipelines
    page = synthetic_page()
    base, _ = port.recognizer(page, QUADS)
    ds, _ = port.recognizer.preprocess(page, QUADS)
    size = port.recognizer._cfg.data.img_size
    rotated = np.stack([resize_with_padding(cv2.rotate(r, cv2.ROTATE_180), size)
                        for r in ds.roi_images])
    _, r_scores, _ = port.recognizer._run_batch_inference(rotated, ds.valid_quads)
    # between a line's score and its rotated reading's (random weights
    # score ~1e-17), and above them all
    threshes = [(a * b) ** 0.5 for a, b in zip(base.scores, r_scores) if b > a]
    assert threshes, (base.scores, r_scores)
    threshes.append(2 * max(base.scores + r_scores))
    replaced = 0
    for thresh in threshes:
        for rec in (jax_ocr.recognizer, port.recognizer):
            monkeypatch.setattr(rec, "rec_orientation_fallback", True)
            monkeypatch.setattr(rec, "rec_orientation_fallback_thresh", thresh)
        want, _ = jax_ocr.recognizer(page, QUADS)
        got, _ = port.recognizer(page, QUADS)
        assert got.contents == want.contents
        assert got.directions == want.directions
        np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4)
        replaced += got.scores != base.scores
    assert replaced > 0


LAYOUT_SMALL = {"path_cfg": str(ROOT / "tests/yaml/layout_small.yaml"),
                "from_pretrained": False}


def _small_module(cls, num_devices):
    """``cls`` at the small configs on the CPU, and a call of it on the
    synthetic page -> its schema as a dict."""
    page = synthetic_page()
    if cls is TextDetector:
        m = cls(**CONFIGS["text_detector"], device="cpu", num_devices=num_devices)
        return m(page)[0].model_dump()
    if cls is TextRecognizer:
        m = cls(**CONFIGS["text_recognizer"], device="cpu", num_devices=num_devices)
        return m(page, QUADS)[0].model_dump()
    if cls is OCR:
        return cls(configs=CONFIGS, device="cpu", num_devices=num_devices)(page)[0].model_dump()
    if cls in (LayoutParser, TableStructureRecognizer):
        m = cls(**LAYOUT_SMALL, device="cpu", num_devices=num_devices)
        out = m(page) if cls is LayoutParser else m(page, [[10, 10, 150, 100]])
        return [x.model_dump() for x in out[0]] if isinstance(out[0], list) else \
            out[0].model_dump()
    layout = {"layout_parser": LAYOUT_SMALL, "table_structure_recognizer": LAYOUT_SMALL}
    if cls is LayoutAnalyzer:
        return cls(configs=layout, device="cpu", num_devices=num_devices)(page)[0].model_dump()
    return cls(configs={"ocr": CONFIGS, "layout_analyzer": layout}, device="cpu",
               num_devices=num_devices)(page)[0].model_dump()


@pytest.fixture
def one_thread():
    """One intra-op thread for the small models built here: more gain
    nothing, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cls", [TextDetector, TextRecognizer, OCR, LayoutParser,
                                 TableStructureRecognizer, LayoutAnalyzer,
                                 DocumentAnalyzer])
def test_num_devices_beyond_one_raises(cls, monkeypatch, one_thread):
    """``num_devices=2`` builds, as in the JAX package, and gives the
    result of ``num_devices=None`` (one CPU: no replica)."""
    monkeypatch.setenv("YOMITOKU_TPU_INT8_KV", "0")
    monkeypatch.setenv("YOMITOKU_TPU_NO_FUSED_PAGE", "1")
    assert _small_module(cls, 2) == _small_module(cls, None)


def test_one_device_accepted():
    det = TextDetector(path_cfg=CONFIGS["text_detector"]["path_cfg"], device="cpu",
                       from_pretrained=False, num_devices=1, infer_onnx=True)
    assert det.visualize is False
    for cls in (LayoutParser, TableStructureRecognizer):
        module = cls(**LAYOUT_SMALL, device="cpu", num_devices=1, infer_onnx=True)
        assert module.visualize is False


def test_layout_analyzer_passes_num_devices_to_both_modules(monkeypatch, one_thread):
    """LayoutAnalyzer merges ``num_devices`` into both entries, under each
    entry's own ``configs`` (the JAX analyzer's merge): each module counts
    its devices with what reached it, and every case builds and gives the
    result of one device."""
    import yomitoku_tpu_torch.parallel as par

    seen = []
    real = par.dp_mesh
    monkeypatch.setattr(par, "dp_mesh", lambda n, **k: seen.append(n) or real(n, **k))
    small = {"layout_parser": LAYOUT_SMALL, "table_structure_recognizer": LAYOUT_SMALL}
    page = synthetic_page()
    want = LayoutAnalyzer(configs=small, device="cpu", num_devices=1)(page)[0]
    assert seen == [1, 1]
    for name in small:
        seen.clear()
        got = LayoutAnalyzer(configs={**small, name: {**LAYOUT_SMALL, "num_devices": 2}},
                             device="cpu", num_devices=1)(page)[0]
        assert seen == ([2, 1] if name == "layout_parser" else [1, 2])
        assert got.model_dump() == want.model_dump()
        seen.clear()
        got = LayoutAnalyzer(configs={**small, name: {**LAYOUT_SMALL, "num_devices": 1}},
                             device="cpu", num_devices=2)(page)[0]
        assert seen == ([1, 2] if name == "layout_parser" else [2, 1])
        assert got.model_dump() == want.model_dump()


def test_ocr_configs_override_device():
    """Each module's configs entry merges over OCR's own arguments, so a
    ``device`` there wins (the JAX OCR's merge) instead of raising on a
    duplicate keyword."""
    configs = {name: {**cfg, "device": "cpu"} for name, cfg in CONFIGS.items()}
    ocr = OCR(configs=configs, device="cuda", visualize=True)
    assert ocr.detector.device.type == ocr.recognizer.device.type == "cpu"
    assert ocr.detector.visualize and ocr.recognizer.visualize
    # the same device in both places: a duplicate keyword before the merge
    ocr = OCR(configs={**CONFIGS, "text_detector": configs["text_detector"]}, device="cpu")
    assert ocr.detector.device.type == "cpu" and not ocr.detector.visualize
