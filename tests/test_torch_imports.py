"""The port stands alone: importing ``yomitoku_tpu_torch`` and every one of
its submodules (and ``chip_smoke.py``) loads neither the JAX package nor
JAX, checked in a fresh interpreter; and no file of the port, nor
``chip_smoke.py``, names either in an import statement (checked on the
source, so a lazy import inside a function is caught too)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "yomitoku_tpu_torch"
FORBIDDEN = ("yomitoku_tpu", "jax", "jaxlib", "flax")

_PROBE = """
import importlib, json, pkgutil, sys
sys.path.insert(0, {root!r})
import yomitoku_tpu_torch
names = [m.name for m in pkgutil.walk_packages(yomitoku_tpu_torch.__path__,
                                               "yomitoku_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
print(json.dumps({{"modules": names, "loaded": sorted(sys.modules)}}))
"""


def _top(name):
    return name.split(".")[0]


@pytest.fixture(scope="module")
def probe():
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_importing_the_port_loads_no_jax(probe):
    bad = [m for m in probe["loaded"] if _top(m) in FORBIDDEN]
    assert not bad, bad


def test_every_submodule_was_imported(probe):
    files = {p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".")
             .removesuffix(".__init__") for p in PORT.rglob("*.py")}
    assert files == set(probe["modules"]) | {"yomitoku_tpu_torch"}
    assert set(probe["modules"]) <= set(probe["loaded"])


def _sources():
    return sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")) + [
        "chip_smoke.py"]


def _imported_names(path):
    tree = ast.parse((ROOT / path).read_text(encoding="utf-8"), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
                and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", _sources())
def test_source_imports_nothing_of_jax(path):
    bad = [n for n in _imported_names(path) if _top(n) in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_keeps_its_own_resources():
    for name in ("charset.txt", "charsetv2.txt", "MPLUS1p-Medium.ttf"):
        assert (PORT / "resource" / name).is_file()
    assert (PORT / "csrc" / "dbnet_post.cpp").is_file()


def test_document_analyzer_imports_without_lxml(tmp_path):
    """The HTML exporter imports lxml where it prints the document, so the
    analyzer and the other exporters import and run on a machine without
    it; only ``to_html`` needs it."""
    script = f"""
import sys
sys.modules["lxml"] = None  # import lxml raises ImportError
sys.path.insert(0, {str(ROOT)!r})
import yomitoku_tpu_torch.document_analyzer
from yomitoku_tpu_torch.schemas import DocumentAnalyzerSchema, ParagraphSchema
doc = DocumentAnalyzerSchema(paragraphs=[ParagraphSchema(
    box=[0, 0, 10, 10], contents="a", direction="horizontal", order=0, role=None)],
    tables=[], words=[], figures=[])
doc.to_markdown({str(tmp_path / "d.md")!r})
doc.to_csv({str(tmp_path / "d.csv")!r})
doc.to_json({str(tmp_path / "d.json")!r})
try:
    doc.to_html({str(tmp_path / "d.html")!r})
except ImportError:
    print("ok")
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("ok")
