"""The slice as a whole: the port's TextDetector, TextRecognizer and OCR
against the JAX package's, on the same weights (JAX seeded init carried
across by ``state_dict_from_jax``), on a synthetic page, CPU, f32.

Small configs: the detector of tests/yaml/det_small.yaml (dbnetv2_1
weights, 64/96 resize; the port's seeded init given to JAX through
convert_dbnet) with its last transposed conv scaled by 10, so that
random weights give a structured map with several quads; the recognizer
of tests/yaml/rec_small.yaml (parseq-large-v4_1 charset, D=32; the JAX
seeded init given to the port through state_dict_from_jax).
Quads and strings must be equal; scores agree to rtol 1e-4."""

import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from yomitoku_tpu.models.weights_convert import convert_dbnet
from yomitoku_tpu.ocr import OCR as JaxOCR
from yomitoku_tpu_torch.ocr import OCR
from yomitoku_tpu_torch.text_recognizer import TextRecognizer
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
    got = port.detector(page)
    assert len(want.points) > 1
    assert got.points == want.points
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4)


def test_recognizer_strings_equal_on_given_quads(pipelines):
    jax_ocr, port = pipelines
    page = synthetic_page()
    want, _ = jax_ocr.recognizer(page, QUADS)
    got = port.recognizer(page, QUADS)
    assert len(got.contents) == len(QUADS)
    assert got.contents == want.contents
    assert got.points == want.points
    assert got.directions == want.directions
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4)


def test_ocr_schema_equal(pipelines):
    jax_ocr, port = pipelines
    page = synthetic_page()
    want, _ = jax_ocr(page)
    got = port(page)
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
result = ocr(page)
words = ocr.recognizer(page, [[[10, 20], [80, 20], [80, 40], [10, 40]]])
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
    from yomitoku_tpu_torch.text_detector import TextDetector

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
