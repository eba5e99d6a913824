"""``num_devices`` as the JAX package reads it, CPU: both analyzers and
``yomitoku_torch --num_devices`` build at None, 0, 1, -1, 2 and 99 and give
the result that None gives (the task classes:
tests/test_torch_num_devices.py).  Held: the schemas equal; the CLI's JSON
files equal but for the scores, within rtol 1e-4 (with ``num_devices``
above 1 the analyzer's ``batch`` takes the stage-batched page axis, whose
layout and table batches span both pages)."""

import sys
from pathlib import Path

import pytest
import torch

from test_torch_cli import _same_outputs
from test_torch_num_devices import VALUES, _WANT, one_route  # noqa: F401
from test_torch_ocr import _small_module
from test_torch_table_semantic import CONFIGS as TSP_CONFIGS
from test_torch_table_semantic import semantic_page
from yomitoku_tpu_torch import parallel
from yomitoku_tpu_torch.cli import main as port_main
from yomitoku_tpu_torch.document_analyzer import DocumentAnalyzer
from yomitoku_tpu_torch.table_semantic_parser import TableSemanticParser

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small models gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _result(cls, num_devices):
    if cls is DocumentAnalyzer:
        return _small_module(cls, num_devices)
    tsp = TableSemanticParser(configs=TSP_CONFIGS, device="cpu", visualize=False,
                              num_devices=num_devices)
    return tsp(semantic_page())[0].model_dump()


@pytest.mark.parametrize("num_devices", VALUES[1:])
@pytest.mark.parametrize("cls", [DocumentAnalyzer, TableSemanticParser],
                         ids=lambda c: c.__name__)
def test_num_devices_gives_the_one_device_result(cls, num_devices, monkeypatch):
    seen = []
    real = parallel.dp_mesh
    monkeypatch.setattr(parallel, "dp_mesh",
                        lambda n, **k: seen.append((n, k)) or real(n, **k))
    if cls not in _WANT:
        _WANT[cls] = _result(cls, None)
    got = _result(cls, num_devices)
    assert len(seen) == 4  # each of the four modules counted its devices
    assert all(n == num_devices and k == {"device_type": "cpu"} for n, k in seen)
    assert got == _WANT[cls]


def _cli(monkeypatch, out, num_devices):
    yaml = ROOT / "tests" / "yaml"
    argv = ["yomitoku_torch", str(ROOT / "demo" / "sample.pdf"), "-f", "json", "-o", str(out),
            "-d", "cpu", "--dpi", "40", "--td_cfg", str(yaml / "det_small.yaml"),
            "--tr_cfg", str(yaml / "rec_small.yaml"), "--lp_cfg", str(yaml / "layout_small.yaml"),
            "--tsr_cfg", str(yaml / "layout_small.yaml")]
    if num_devices is not None:
        argv += ["--num_devices", str(num_devices)]
    monkeypatch.setattr(sys, "argv", argv)
    port_main.main()


@pytest.fixture(scope="module")
def default_run(tmp_path_factory):
    """The CLI's files without ``--num_devices``."""
    out = tmp_path_factory.mktemp("cli") / "none"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YOMITOKU_TPU_INT8_KV", "0")
        mp.setenv("YOMITOKU_TPU_NO_FUSED_PAGE", "1")
        _cli(mp, out, None)
    return out


@pytest.mark.parametrize("num_devices", VALUES)
def test_cli_num_devices(default_run, tmp_path, monkeypatch, num_devices):
    """``yomitoku_torch --num_devices N`` builds its analyzer with N and
    writes the files of the run without the flag; above 1 the pages take
    ``_batch_dp``."""
    built, routed = [], []
    real_init, real_dp = DocumentAnalyzer.__init__, DocumentAnalyzer._batch_dp

    def init(self, *args, **kwargs):
        built.append(kwargs["num_devices"])
        real_init(self, *args, **kwargs)

    monkeypatch.setattr(DocumentAnalyzer, "__init__", init)
    monkeypatch.setattr(DocumentAnalyzer, "_batch_dp",
                        lambda self, imgs: routed.append(len(imgs)) or real_dp(self, imgs))
    _cli(monkeypatch, tmp_path / "n", num_devices)
    assert built == [num_devices]
    assert routed == ([2] if num_devices in (2, 99) else [])
    assert len(_same_outputs(default_run, tmp_path / "n")) == 2
