"""The port's CLI (``yomitoku_tpu_torch.cli.main``) against the JAX CLI
on demo/sample.pdf at 40 dpi, with the same seed-0 weights at small
configs: each CLI module's ``DocumentAnalyzer`` is monkeypatched to hand
back a prebuilt analyzer (the pair of tests/test_torch_document_analyzer.py:
detector head scaled, recognizer shared, score heads calibrated; JAX on
its unfused route, the full memory-K/V cache), and the arguments each CLI
built it with are held to the expected ones.  Every format, ``--combine``,
``--pages``, ``-v``, ``--ignore_line_break``, ``--figure`` and ``--lite``:
the same file names, the files byte-equal, except the JSON's scores,
which two frameworks compute to rtol 1e-4 (as the analyzer test holds
them); every other byte of the JSON is equal.  Then the port's error
paths, its directory loop (a corrupt file skipped with its traceback; a
kernel build failure or a CUDA error ends the run), and the MCP server
under a stubbed ``mcp`` against the JAX one."""

import asyncio
import copy
import json
import logging
import re
import sys
import types
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from test_torch_document_analyzer import CONFIGS
from test_torch_layout import LAYOUT_TARGETS, TSR_TARGETS, calibrate, share
from test_torch_pdf import builtin_pdf_backend  # noqa: F401  (autouse)
from yomitoku_tpu import document_analyzer as jax_da
from yomitoku_tpu.cli import main as jax_main
from yomitoku_tpu.models.weights_convert import convert_dbnet
from yomitoku_tpu_torch import document_analyzer as port_da
from yomitoku_tpu_torch.cli import main as port_main
from yomitoku_tpu_torch.data import load_pdf
from yomitoku_tpu_torch.ops._build import KernelBuildError
from yomitoku_tpu_torch.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
SAMPLE = ROOT / "demo" / "sample.pdf"
DPI = 40


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX analyzer, port analyzer, the rendered pages): the detector at
    256 px so that sample.pdf's pages hold a few words each."""
    det_yaml = tmp_path_factory.mktemp("cfg") / "det_256.yaml"
    det_yaml.write_text("data:\n  shortest_size: 256\n  limit_size: 384\n")
    configs = copy.deepcopy(CONFIGS)
    configs["ocr"]["text_detector"]["path_cfg"] = str(det_yaml)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YOMITOKU_TPU_INT8_KV", "0")
        jax = jax_da.DocumentAnalyzer(configs=configs, device="cpu")
        port = port_da.DocumentAnalyzer(configs=configs, device="cpu")
    pages = list(load_pdf(SAMPLE, dpi=DPI))
    det = port.text_detector.model
    with torch.no_grad():
        det.decoder.binarize[6].weight.mul_(10.0)
    sd = {k: v.numpy() for k, v in det.state_dict().items()}
    jax.text_detector.model.params = convert_dbnet(sd, jax.text_detector.model)
    rec = jax.text_recognizer.model
    rec.params = rec.init_params(0)
    port.text_recognizer.model.load_state_dict(
        state_dict_from_jax(rec.params, port.text_recognizer.model))
    lp, tsr = port.layout.layout_parser, port.layout.table_structure_recognizer
    calibrate(lp.model, lp.preprocess(pages[0]), LAYOUT_TARGETS)
    share(lp.model, jax.layout.layout_parser.model)
    tables = [t.box for t in lp(pages[0])[0].tables]
    calibrate(tsr.model, np.stack([d["array"] for d in tsr.preprocess(pages[0], tables)]),
              TSR_TARGETS)
    share(tsr.model, jax.layout.table_structure_recognizer.model)
    return jax, port, pages


@pytest.fixture(autouse=True)
def unfused(monkeypatch):
    """The JAX package's unfused route, which the port takes; the host
    route on both."""
    monkeypatch.setenv("YOMITOKU_TPU_NO_FUSED_PAGE", "1")
    for name in ("YOMITOKU_TPU_HOST_CROPS", "YOMITOKU_TPU_DEVICE_CROPS",
                 "YOMITOKU_TPU_REC_WIDTH_BUCKETS"):
        monkeypatch.delenv(name, raising=False)


def _modules(da):
    return (da, da.text_detector, da.text_recognizer, da.layout.layout_parser,
            da.layout.table_structure_recognizer)


def _inject(monkeypatch, module, analyzer):
    """The CLI module's DocumentAnalyzer -> a factory that records its
    arguments and hands back ``analyzer`` with the CLI's options set."""
    seen = []

    def make(**kwargs):
        seen.append(kwargs)
        for m in _modules(analyzer):
            m.visualize = kwargs["visualize"]
        for name in ("ignore_meta", "reading_order", "ignore_ruby", "ruby_threshold"):
            setattr(analyzer, name, kwargs[name])
        return analyzer

    monkeypatch.setattr(module, "DocumentAnalyzer", make)
    return seen


def _run(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", ["yomitoku", *map(str, argv)])
    module.main()


def _expected_kwargs(device, vis=False, lite=False):
    rec = {"path_cfg": None,
           "model_name": "parseq-tiny" if lite else "parseq-large-v4_1"}
    det = {"path_cfg": None, "model_name": "dbnetv2_1-lite" if lite else "dbnetv2_1"}
    return dict(
        configs={"ocr": {"text_detector": det, "text_recognizer": rec},
                 "layout_analyzer": {"layout_parser": {"path_cfg": None},
                                     "table_structure_recognizer": {"path_cfg": None}}},
        visualize=vis, device=device, num_devices=None, ignore_meta=False,
        reading_order="auto", ignore_ruby=False, ruby_threshold=1.0)


_SCORE = re.compile(r'("(?:det_|rec_)?score": )(-?[0-9.eE+-]+)')


def _same_json(got, want):
    """Equal but for the scores' values, which agree to rtol 1e-4."""
    assert _SCORE.sub(r"\1S", got) == _SCORE.sub(r"\1S", want)
    g = [float(m.group(2)) for m in _SCORE.finditer(got)]
    w = [float(m.group(2)) for m in _SCORE.finditer(want)]
    np.testing.assert_allclose(g, w, rtol=1e-4)
    return len(g)


def _same_outputs(jax_dir, port_dir):
    files = sorted(p.relative_to(jax_dir) for p in jax_dir.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(port_dir) for p in port_dir.rglob("*")
                           if p.is_file())
    assert files
    for rel in files:
        want, got = (jax_dir / rel).read_bytes(), (port_dir / rel).read_bytes()
        assert got, rel
        if rel.suffix == ".json":
            _same_json(got.decode("utf-8"), want.decode("utf-8"))
        else:
            assert got == want, rel
    return files


_CASES = {
    "json": ["-f", "json"],
    "md": ["-f", "md"],
    "csv": ["-f", "csv"],
    "html": ["-f", "html"],
    "pdf": ["-f", "pdf"],
    "json_combine": ["-f", "json", "--combine"],
    "md_combine": ["-f", "md", "--combine"],
    "csv_combine": ["-f", "csv", "--combine"],
    "html_combine": ["-f", "html", "--combine"],
    "pdf_combine": ["-f", "pdf", "--combine", "--pdf_quality", "low"],
    "json_page_1": ["-f", "json", "--pages", "1"],
    "md_vis_figure": ["-f", "md", "-v", "--figure", "--figure_letter"],
    "json_ignore_line_break": ["-f", "json", "--ignore_line_break"],
    "markdown_ignore_line_break": ["-f", "markdown", "--ignore_line_break", "--combine"],
    "json_lite": ["-f", "json", "--lite", "--reading_order", "left2right"],
}


@pytest.mark.parametrize("case", list(_CASES))
def test_cli_matches_jax(pair, tmp_path, monkeypatch, case):
    jax, port, pages = pair
    flags = _CASES[case]
    runs = {}
    try:
        for name, module, analyzer in (("jax", jax_main, jax), ("port", port_main, port)):
            seen = _inject(monkeypatch, module, analyzer)
            out = tmp_path / name
            _run(monkeypatch, module, [SAMPLE, *flags, "-o", out, "-d", "cpu",
                                       "--dpi", DPI])
            assert len(seen) == 1
            runs[name] = seen[0]
    finally:
        for m in _modules(port) + _modules(jax):
            m.visualize = False
    want = _expected_kwargs("cpu", vis="-v" in flags, lite="--lite" in flags)
    if "--reading_order" in flags:
        want["reading_order"] = "left2right"
    assert runs["port"] == runs["jax"] == want
    files = _same_outputs(tmp_path / "jax", tmp_path / "port")
    names = [f.name for f in files]
    if case == "json_page_1":
        assert names == ["demo_sample_p1.json"]
    elif "--combine" in flags:
        assert f"demo_sample.{flags[1].replace('markdown', 'md')}" in names
    if case == "md_vis_figure":
        assert {"demo_sample_p1_ocr.jpg", "demo_sample_p2_layout.jpg"} <= set(names)
    if flags[1] == "json":
        # not vacuous: the pages hold words
        for f in files:
            doc = json.loads((tmp_path / "port" / f).read_text(encoding="utf-8"))
            docs = doc if isinstance(doc, list) else [doc]
            assert all(d["words"] for d in docs), f


def test_cli_pdf_text_layer_holds_words(pair, tmp_path, monkeypatch):
    """The port's combined searchable PDF re-opened with its own parser:
    two pages whose text layers hold the words of the JSON run."""
    import chip_smoke
    from yomitoku_tpu_torch.schemas import DocumentAnalyzerSchema

    _, port, _ = pair
    _inject(monkeypatch, port_main, port)
    for flags in (["-f", "pdf", "--combine"], ["-f", "json"]):
        _run(monkeypatch, port_main, [SAMPLE, *flags, "-o", tmp_path, "-d", "cpu",
                                      "--dpi", DPI])
    layer = chip_smoke.text_layer(tmp_path / "demo_sample.pdf")
    assert len(layer) == 2
    for i, shown in enumerate(layer, 1):
        doc = DocumentAnalyzerSchema.model_validate(json.loads(
            (tmp_path / f"demo_sample_p{i}.json").read_text(encoding="utf-8")))
        missing, placed = chip_smoke.words_missing_from_layer(shown, doc)
        assert missing == [] and placed > 0


@pytest.mark.parametrize("case", ["missing", "format", "encoding", "font_path"])
def test_cli_argument_errors_match_jax(tmp_path, monkeypatch, case):
    argv = {
        "missing": [tmp_path / "none.pdf"],
        "format": [SAMPLE, "-f", "xml"],
        "encoding": [SAMPLE, "--encoding", "latin-1"],
        "font_path": [SAMPLE, "-f", "pdf", "--font_path", tmp_path / "none.ttf"],
    }[case]
    errors = []
    for module in (jax_main, port_main):
        seen = _inject(monkeypatch, module, None)
        with pytest.raises(Exception) as info:
            _run(monkeypatch, module, [*argv, "-o", tmp_path, "-d", "cpu"])
        assert seen == []  # raised before any analyzer was built
        errors.append(info.value)
    assert type(errors[0]) is type(errors[1]) and str(errors[0]) == str(errors[1])
    assert isinstance(errors[1], {"missing": FileNotFoundError, "format": ValueError,
                                  "encoding": ValueError,
                                  "font_path": FileNotFoundError}[case])


@pytest.mark.parametrize("flags,error", [
    (["-d", "tpu"], (RuntimeError, ValueError)),
    (["-d", "cpu", "--num_devices", "2"], NotImplementedError),
    (["-d", "cpu", "--num_devices", "-1"], NotImplementedError),
    ([], RuntimeError),  # the default, "cuda", where there is no card
])
def test_port_cli_device_errors(tmp_path, monkeypatch, flags, error):
    """Only cuda and cpu, one card; CUDA asked for without a card raises,
    never running on the CPU instead."""
    if not flags:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seen = _inject(monkeypatch, port_main, None)
    with pytest.raises(error):
        _run(monkeypatch, port_main, [SAMPLE, "-o", tmp_path, *flags])
    assert seen == []
    assert port_main.build_parser().parse_args(["x"]).device == "cuda"


class _Catch(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


def test_port_cli_directory_loop(pair, tmp_path, monkeypatch):
    """A file that fails to parse is logged with its traceback and
    skipped, the others are processed; a KernelBuildError or a CUDA error
    raised by the analyzer ends the run; any other error of a file is
    skipped."""
    _, port, pages = pair
    src = tmp_path / "in"
    (src / "sub").mkdir(parents=True)
    (src / "bad.pdf").write_bytes(b"not a pdf at all" * 10)
    cv2.imwrite(str(src / "sub" / "page.png"), pages[0])
    _inject(monkeypatch, port_main, port)
    catch = _Catch()
    port_main.logger.addHandler(catch)
    try:
        _run(monkeypatch, port_main, [src, "-f", "md", "-o", tmp_path / "out", "-d", "cpu"])
    finally:
        port_main.logger.removeHandler(catch)
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["sub_page_p1.md"]
    skipped = [r for r in catch.records if r.getMessage().startswith("Skipped file")]
    assert len(skipped) == 1 and "bad.pdf" in skipped[0].getMessage()
    assert skipped[0].exc_info and skipped[0].exc_info[0] is ValueError

    for raised, ends in ((KernelBuildError("nvcc failed"), True),
                         (RuntimeError("fused_mlp: CUDA error 700 (an illegal memory "
                                       "access was encountered)"), True),
                         (torch.cuda.OutOfMemoryError("out of memory"), True),
                         (ValueError("a page the analyzer refuses"), False)):
        def fail(imgs, *args, exc=raised, **kwargs):
            raise exc
        monkeypatch.setattr(port, "batch", fail)
        out = tmp_path / f"out_{type(raised).__name__}"
        if ends:
            with pytest.raises(type(raised)):
                _run(monkeypatch, port_main, [src, "-f", "md", "-o", out, "-d", "cpu"])
        else:
            _run(monkeypatch, port_main, [src, "-f", "md", "-o", out, "-d", "cpu"])
            assert list(out.iterdir()) == []
        monkeypatch.undo()
        _inject(monkeypatch, port_main, port)


def test_is_device_fault():
    fault = port_main.is_device_fault
    assert fault(KernelBuildError("g++ failed"))
    assert fault(RuntimeError("CUDA error: device-side assert triggered"))
    assert fault(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    try:
        try:
            raise KernelBuildError("nvcc failed")
        except KernelBuildError as e:
            raise ValueError("while loading a page") from e
    except ValueError as chained:
        assert fault(chained)
    for exc in (ValueError("Failed to open the PDF file"), OSError("truncated"),
                RuntimeError("a CPU error"), KeyError("Root")):
        assert not fault(exc)


# ------------------------------------------------------------ MCP server

@pytest.fixture(scope="module")
def mcp_servers(pair, tmp_path_factory):
    """Both MCP server modules imported under a stubbed ``mcp`` package
    (the optional extra is not installed), RESOURCE_DIR holding a PNG of
    sample.pdf's first page, each server's analyzer the prebuilt one."""
    jax, port, pages = pair
    res = tmp_path_factory.mktemp("resources")
    cv2.imwrite(str(res / "page.png"), pages[0])
    fastmcp = types.ModuleType("mcp.server.fastmcp")

    class FastMCP:
        def __init__(self, name):
            self.tools, self.resources = {}, {}

        def tool(self):
            def deco(fn):
                self.tools[fn.__name__] = fn
                return fn
            return deco

        def resource(self, uri):
            def deco(fn):
                self.resources[uri] = fn
                return fn
            return deco

    class Context:
        async def info(self, *a, **k):
            pass

        async def report_progress(self, *a, **k):
            pass

    fastmcp.FastMCP, fastmcp.Context = FastMCP, Context
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "mcp", types.ModuleType("mcp"))
        mp.setitem(sys.modules, "mcp.server", types.ModuleType("mcp.server"))
        mp.setitem(sys.modules, "mcp.server.fastmcp", fastmcp)
        mp.setenv("RESOURCE_DIR", str(res))
        for name in ("yomitoku_tpu.cli.mcp_server", "yomitoku_tpu_torch.cli.mcp_server"):
            mp.delitem(sys.modules, name, raising=False)
        from yomitoku_tpu.cli import mcp_server as jax_srv
        from yomitoku_tpu_torch.cli import mcp_server as port_srv

        jax_srv.analyzer, port_srv.analyzer = jax, port
        yield jax_srv, port_srv, Context
        for name in ("yomitoku_tpu.cli.mcp_server", "yomitoku_tpu_torch.cli.mcp_server"):
            sys.modules.pop(name, None)


@pytest.mark.parametrize("fmt", ["json", "markdown", "html", "csv"])
def test_mcp_process_ocr_matches_jax(mcp_servers, fmt):
    jax_srv, port_srv, Context = mcp_servers
    for srv in (jax_srv, port_srv):  # the options the server's own analyzer has
        for m in _modules(srv.analyzer):
            m.visualize = False
        srv.analyzer.ignore_meta = srv.analyzer.ignore_ruby = False
        srv.analyzer.reading_order, srv.analyzer.ruby_threshold = "auto", 2.0
    got, want = (asyncio.run(srv.process_ocr(Context(), filename="page.png",
                                             output_format=fmt))
                 for srv in (port_srv, jax_srv))
    assert isinstance(got, str) and got
    if fmt == "json":
        assert _same_json(got, want) > 0
        assert json.loads(got)[0]["words"]
    else:
        assert got == want


def test_mcp_server_surface(mcp_servers):
    jax_srv, port_srv, Context = mcp_servers
    got, want = (asyncio.run(srv.get_file_list()) for srv in (port_srv, jax_srv))
    assert sorted(got) == sorted(want) == ["page.png"]
    assert set(port_srv.mcp.tools) == set(jax_srv.mcp.tools) == {"process_ocr"}
    assert set(port_srv.mcp.resources) == {"file://list"}
    with pytest.raises(ValueError, match="Unsupported output format"):
        asyncio.run(port_srv.process_ocr(Context(), filename="page.png",
                                         output_format="xml"))
    # the server builds its analyzer once, on the card
    built = []
    prebuilt = port_srv.analyzer
    try:
        port_srv.analyzer = None
        port_srv.DocumentAnalyzer = lambda **kw: built.append(kw) or prebuilt
        for _ in range(2):
            assert asyncio.run(port_srv.load_analyzer(Context())) is prebuilt
    finally:
        port_srv.analyzer = prebuilt
    assert built == [{"visualize": False, "device": "cuda"}]
