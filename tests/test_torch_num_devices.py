"""``num_devices`` as the JAX package reads it (``parallel.dp_mesh``), CPU:
every task class builds at None, 0, 1, -1, 2 and 99 and gives the result
that None gives (both analyzers and ``yomitoku_torch --num_devices``:
tests/test_torch_num_devices_analyzers.py).
One CPU is one device, so no value makes a replica here, as none does in
the JAX package on one device; tests/test_torch_parallel.py holds the
replicas.  Held: the schemas equal, and every module counted its devices
with the value on the CPU."""

from pathlib import Path

import pytest
import torch

from test_torch_ocr import CONFIGS as OCR_CONFIGS
from test_torch_ocr import LAYOUT_SMALL, _small_module
from test_torch_table_semantic import semantic_page
from yomitoku_tpu_torch import parallel
from yomitoku_tpu_torch.layout_analyzer import LayoutAnalyzer
from yomitoku_tpu_torch.layout_parser import LayoutParser
from yomitoku_tpu_torch.ocr import OCR
from yomitoku_tpu_torch.schemas import Element
from yomitoku_tpu_torch.table_cell_detector import CellDetector
from yomitoku_tpu_torch.table_structure_recognizer import TableStructureRecognizer
from yomitoku_tpu_torch.text_detector import TextDetector
from yomitoku_tpu_torch.text_recognizer import TextRecognizer

ROOT = Path(__file__).resolve().parents[1]
VALUES = [None, 0, 1, -1, 2, 99]
assert OCR_CONFIGS and LAYOUT_SMALL


def _cell_detector(num_devices):
    page = semantic_page()
    h, w = page.shape[:2]
    cd = CellDetector(path_cfg=str(ROOT / "tests/yaml/layout_small.yaml"),
                      from_pretrained=False, device="cpu", num_devices=num_devices)
    tables = [Element(id=None, box=[0, 0, w // 2, h // 2], score=0.9, role=None,
                      contents=None)]
    return [t.model_dump() for t in cd(page, tables)]


def _result(cls, num_devices):
    if cls is CellDetector:
        return _cell_detector(num_devices)
    return _small_module(cls, num_devices)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small models gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_WANT = {}


@pytest.fixture(autouse=True)
def one_route(monkeypatch):
    monkeypatch.setenv("YOMITOKU_TPU_INT8_KV", "0")
    monkeypatch.setenv("YOMITOKU_TPU_NO_FUSED_PAGE", "1")
    for name in ("YOMITOKU_TPU_DEVICE_CROPS", "YOMITOKU_TPU_HOST_CROPS"):
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("num_devices", VALUES[1:])
@pytest.mark.parametrize("cls", [TextDetector, TextRecognizer, OCR, LayoutParser,
                                 TableStructureRecognizer, LayoutAnalyzer, CellDetector],
                         ids=lambda c: c.__name__)
def test_num_devices_gives_the_one_device_result(cls, num_devices, monkeypatch):
    seen = []
    real = parallel.dp_mesh
    monkeypatch.setattr(parallel, "dp_mesh",
                        lambda n, **k: seen.append((n, k)) or real(n, **k))
    if cls not in _WANT:
        _WANT[cls] = _result(cls, None)
    got = _result(cls, num_devices)
    # every model-holding module counted its devices on the CPU
    assert seen and all(n == num_devices and k == {"device_type": "cpu"} for n, k in seen)
    assert got == _WANT[cls]
