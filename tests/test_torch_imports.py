"""The port stands alone: importing ``yomitoku_tpu_torch`` and every one of
its submodules (and ``chip_smoke.py``) loads neither the JAX package nor
JAX, checked in a fresh interpreter (the MCP server under a stubbed
``mcp``, its optional extra); no file of the port, nor ``chip_smoke.py``,
names either in an import statement or in the literal name given to
``__import__`` or ``importlib.import_module`` (checked on the source, so a
lazy import inside a function is caught too); and a call that reaches
code only a PDF with an embedded CFF font runs (``render._read_index_names``)
loads neither."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "yomitoku_tpu_torch"
FORBIDDEN = ("yomitoku_tpu", "jax", "jaxlib", "flax")

#: the optional ``mcp`` extra, stubbed so that the MCP server module imports
_MCP_STUB = """
import os, sys, types
os.environ.setdefault("RESOURCE_DIR", ".")
for _n in ("mcp", "mcp.server", "mcp.server.fastmcp"):
    sys.modules[_n] = types.ModuleType(_n)

class _FastMCP:
    def __init__(self, name):
        pass

    def tool(self):
        return lambda fn: fn

    def resource(self, uri):
        return lambda fn: fn

sys.modules["mcp.server.fastmcp"].FastMCP = _FastMCP
sys.modules["mcp.server.fastmcp"].Context = object
"""

_PROBE = _MCP_STUB + """
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


def _string_imports(source, filename="<source>"):
    """The literal module names given to ``__import__`` or
    ``import_module`` (``importlib.import_module``, or imported by name),
    positionally or as ``name=``."""
    for node in ast.walk(ast.parse(source, filename=filename)):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        called = func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", None)
        if called not in ("__import__", "import_module"):
            continue
        args = list(node.args[:1]) + [k.value for k in node.keywords if k.arg == "name"]
        for arg in args:
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value


def _forbidden(name):
    return not name.startswith(".") and _top(name) in FORBIDDEN


@pytest.mark.parametrize("snippet,bad", [
    ('__import__("yomitoku_tpu.data.pdf.fonts", fromlist=["_read_index"])', True),
    ('x = __import__(\n    "yomitoku_tpu.native"\n).fill_edges', True),
    ('import importlib\nimportlib.import_module("jax.numpy")', True),
    ('from importlib import import_module\nimport_module(name="flax.linen")', True),
    ('importlib.import_module("jaxlib")', True),
    ('__import__("yomitoku_tpu_torch.data.pdf.fonts", fromlist=["_read_index"])', False),
    ('importlib.import_module(".document_analyzer", __name__)', False),
    ('importlib.import_module(_LAZY[name], __name__)', False),
    ('__import__("numpy")', False),
])
def test_string_import_check_catches(snippet, bad):
    assert any(_forbidden(n) for n in _string_imports(snippet)) == bad


@pytest.mark.parametrize("path", _sources())
def test_source_has_no_string_import_of_jax(path):
    source = (ROOT / path).read_text(encoding="utf-8")
    bad = [n for n in _string_imports(source, path) if _forbidden(n)]
    assert not bad, f"{path} imports {bad} by name"


def test_cff_index_names_load_no_jax():
    """``render._read_index_names``, the path an embedded CFF font's string
    INDEX takes, in a fresh interpreter: it reads the INDEX through the
    port's own ``fonts._read_index`` and loads nothing of JAX."""
    script = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from yomitoku_tpu_torch.data.pdf import render
# count 2, offSize 1, offsets 1 4 6, data "abc" "de"; then one more byte
data = bytes([0, 2, 1, 1, 4, 6]) + b"abcde" + b"!"
names, pos = render._read_index_names(data, 0)
empty, pos0 = render._read_index_names(bytes([0, 0]), 0)
print(json.dumps({{"names": [n.decode() for n in names], "pos": pos, "empty": len(empty),
                  "pos0": pos0, "loaded": sorted(sys.modules)}}))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["names"] == ["abc", "de"] and got["pos"] == 11
    assert got["empty"] == 0 and got["pos0"] == 2
    bad = [m for m in got["loaded"] if _top(m) in FORBIDDEN]
    assert not bad, bad
    assert "yomitoku_tpu_torch.data.pdf.fonts" in got["loaded"]


def test_port_keeps_its_own_resources():
    for name in ("charset.txt", "charsetv2.txt", "MPLUS1p-Medium.ttf"):
        assert (PORT / "resource" / name).is_file()
    for name in ("dbnet_post", "rasterizer", "ccitt", "jbig2"):
        assert (PORT / "csrc" / f"{name}.cpp").is_file()


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
