"""The port's extractor and extraction CLIs against the JAX package's:
the schema, the normalizer, the resolver, the prompt and
``run_rule_extraction`` on the same semantic parse (a hand-made page of
key-value items, a grid and paragraphs, and a parse ``_finalize`` makes
of generated cells), ``run_extraction`` with ``call_llm`` stubbed on both
sides, ``call_llm`` itself against a stubbed ``openai`` (no request leaves
the process), and both CLIs (``cli.extract_rule``, ``cli.extract``) on
demo/sample_table.png with the parser pair of
tests/test_torch_table_semantic.py injected through each module's
``TableSemanticParser`` (its cell filters pinned, so that the page holds a
grid and key-value items): the same files, byte for byte.  Then the port
CLIs' argument errors, ``-d tpu`` raising, and the file loop (a file that
fails to load skipped with its traceback; a kernel build failure ending
the run)."""

import json
import sys
import types
from dataclasses import asdict
from pathlib import Path

import cv2
import numpy as np
import pytest

from test_torch_cli import _Catch
from test_torch_table_semantic import _finalized, parsers, unfused  # noqa: F401
from yomitoku_tpu.cli import extract as jax_extract
from yomitoku_tpu.cli import extract_rule as jax_rule
from yomitoku_tpu.extractor import llm_client as jax_llm
from yomitoku_tpu.extractor import normalizer as jax_norm
from yomitoku_tpu.extractor import pipeline as jax_pipeline
from yomitoku_tpu.extractor import prompt as jax_prompt
from yomitoku_tpu.extractor import resolver as jax_resolver
from yomitoku_tpu.extractor import rule_pipeline as jax_rules
from yomitoku_tpu.extractor import schema as jax_xschema
from yomitoku_tpu.schemas import table_semantic_parser as jax_schema
from yomitoku_tpu_torch.cli import extract as port_extract
from yomitoku_tpu_torch.cli import extract_rule as port_rule
from yomitoku_tpu_torch.extractor import llm_client as port_llm
from yomitoku_tpu_torch.extractor import normalizer as port_norm
from yomitoku_tpu_torch.extractor import pipeline as port_pipeline
from yomitoku_tpu_torch.extractor import prompt as port_prompt
from yomitoku_tpu_torch.extractor import resolver as port_resolver
from yomitoku_tpu_torch.extractor import rule_pipeline as port_rules
from yomitoku_tpu_torch.extractor import schema as port_xschema
from yomitoku_tpu_torch.ops._build import KernelBuildError
from yomitoku_tpu_torch.schemas import table_semantic_parser as port_schema
from yomitoku_tpu_torch.utils.synthetic_heads import pinned_filter_packed

ROOT = Path(__file__).resolve().parents[1]
SAMPLE = ROOT / "demo" / "sample_table.png"
SIDES = {
    "jax": dict(schema=jax_schema, xschema=jax_xschema, rules=jax_rules,
                pipeline=jax_pipeline, prompt=jax_prompt, resolver=jax_resolver,
                norm=jax_norm, llm=jax_llm),
    "port": dict(schema=port_schema, xschema=port_xschema, rules=port_rules,
                 pipeline=port_pipeline, prompt=port_prompt, resolver=port_resolver,
                 norm=port_norm, llm=port_llm),
}


def _cell(cid, box, contents, role="cell"):
    return dict(id=cid, box=box, contents=contents, role=role, row=None, col=None,
                row_span=None, col_span=None, meta={})


#: a page of two tables (key-value items, a grid) and two paragraphs
HAND_MADE = {
    "tables": [
        {
            "id": "t0", "style": "border", "box": [0, 0, 300, 160],
            "cells": {
                "c0": _cell("c0", [0, 0, 100, 30], "会社名", "header"),
                "c1": _cell("c1", [100, 0, 300, 30], "テスト株式会社"),
                "c2": _cell("c2", [0, 30, 100, 60], "合計", "header"),
                "c3": _cell("c3", [100, 30, 300, 60], "１，２３４円"),
                "c4": _cell("c4", [0, 100, 150, 130], "品名", "header"),
                "c5": _cell("c5", [150, 100, 300, 130], "価格", "header"),
                "c6": _cell("c6", [0, 130, 150, 160], "りんご"),
                "c7": _cell("c7", [150, 130, 300, 160], "１００円"),
            },
            "kv_items": [
                {"id": "kv0", "key": ["c0"], "value": "c1", "box": [0, 0, 300, 30]},
                {"id": "kv1", "key": ["c2"], "value": "c3", "box": [0, 30, 300, 60]},
            ],
            "grids": [{"id": "g0", "box": [0, 100, 300, 160], "n_row": 2, "n_col": 2,
                       "col_headers": [["c4"], ["c5"]],
                       "data": [["c4", "c5"], ["c6", "c7"]]}],
        },
        {
            "id": "t1", "style": "border", "box": [0, 200, 300, 260],
            "cells": {
                "c8": _cell("c8", [0, 200, 100, 230], "電話番号", "header"),
                "c9": _cell("c9", [100, 200, 300, 230], "０９０－１２３４－５６７８"),
                "c10": _cell("c10", [0, 230, 100, 260], "日付", "header"),
                "c11": _cell("c11", [100, 230, 300, 260], "令和6年1月15日"),
            },
            "kv_items": [
                {"id": "kv0", "key": ["c8"], "value": "c9", "box": [0, 200, 300, 230]},
                {"id": "kv1", "key": ["c10"], "value": "c11", "box": [0, 230, 300, 260]},
            ],
            "grids": [],
        },
    ],
    "paragraphs": [
        {"id": "p0", "box": [320, 0, 600, 40], "score": 0.9, "role": None,
         "contents": "〒１２３－４５６７ 東京都千代田区"},
        {"id": "p1", "box": [320, 50, 600, 90], "score": 0.9, "role": None,
         "contents": "担当 やまだ たろう"},
    ],
    "words": [
        {"points": [[320, 0], [600, 0], [600, 40], [320, 40]],
         "content": "〒１２３－４５６７ 東京都千代田区", "direction": "horizontal",
         "rec_score": 0.9, "det_score": 0.8},
        {"points": [[100, 0], [300, 0], [300, 30], [100, 30]],
         "content": "テスト株式会社", "direction": "horizontal",
         "rec_score": 0.9, "det_score": 0.8},
    ],
}

FIELDS = [
    {"name": "company", "cell_id": "c1"},
    {"name": "company_bbox", "bbox": [90, 0, 310, 35]},
    {"name": "total", "description": "合計", "normalize": "numeric"},
    {"name": "phone", "description": "電話番号", "normalize": "phone_jp"},
    {"name": "date", "description": "日付", "type": "date", "normalize": "date_jp"},
    {"name": "date8", "description": "日付", "normalize": "date_yyyymmdd"},
    {"name": "apple", "description": "りんご"},
    {"name": "address", "description": "東京都"},
    {"name": "postal", "regex": r"〒[０-９－]+", "normalize": "postal_code_jp"},
    {"name": "reading", "description": "担当", "normalize": "katakana"},
    {"name": "missing", "description": "存在しないキー"},
    {"name": "items", "structure": "table", "columns": [
        {"name": "item", "description": "品名"},
        {"name": "price", "description": "価格", "normalize": "numeric"},
        {"name": "by_id", "cell_id": "c5"}]},
    {"name": "nothing", "structure": "table", "columns": [{"name": "x", "description": "無"}]},
]


def _schemas(data=HAND_MADE):
    return {side: m["schema"].TableSemanticParserSchema.model_validate(
        json.loads(json.dumps(data))) for side, m in SIDES.items()}


def _extraction(side, fields=FIELDS):
    return SIDES[side]["xschema"].ExtractionSchema.model_validate({"fields": fields})


def _files(path):
    return {p.relative_to(path).as_posix(): p.read_bytes()
            for p in sorted(path.rglob("*")) if p.is_file()}


YAML = """
fields:
  - name: company
    description: 会社名
    type: string
  - name: total
    description: 合計金額
    type: number
    normalize: numeric
    merge_values: true
    separator: "|"
  - name: items
    structure: table
    columns:
      - name: item
        description: 品名
        cell_id: c4
      - name: price
        type: number
        normalize: numeric
        bbox: [0, 0, 10, 10]
"""


def test_extraction_schema_matches_jax(tmp_path):
    path = tmp_path / "schema.yaml"
    path.write_text(YAML, encoding="utf-8")
    want = jax_xschema.ExtractionSchema.from_yaml(str(path))
    got = port_xschema.ExtractionSchema.from_yaml(str(path))
    assert got.model_dump() == want.model_dump()
    assert len(got.fields) == 3 and got.fields[2].columns[0].cell_id == "c4"


TEXTS = ["a b　c", "１，２３４円", "-1,234.5", "０９０－１２３４－５６７８", "0312345678",
         "〒１２３４５６７", "令和6年1月15日", "平成31年4月30日", "R6.1.15", "2024年1月15日",
         "2024/1/15", "14:05", "9時5分", "14:05:09", "ＡＢＣ−１２３", "フリガナかな123",
         "ふりがなカナ123", "", "abc", "昭和64年1月7日", "H1.1.8"]


@pytest.mark.parametrize("rule", sorted(jax_norm._REGISTRY) + [None, "nope"])
def test_normalizer_matches_jax(rule):
    assert list(port_norm._REGISTRY) == list(jax_norm._REGISTRY)
    for text in TEXTS + [123, 4.5]:
        assert port_norm.apply_normalize(text, rule) == jax_norm.apply_normalize(text, rule)


LLM_RESULTS = [
    {"name": "company", "value": "テスト株式会社", "cell_ids": ["c1"], "confidence": "high"},
    {"name": "total", "value": "１，２３４円", "cell_ids": ["c3", "p0"]},
    {"name": "word", "value": "x", "cell_ids": ["w1", "unknown"]},
    {"name": "items", "structure": "table", "records": [
        {"item": {"value": "りんご", "cell_ids": ["c6"]},
         "price": {"value": "１００円", "cell_ids": ["c7"]}}]},
    {"name": "empty", "value": "", "cell_ids": []},
]


def test_resolver_matches_jax():
    out = {}
    for side, schema in _schemas().items():
        r = SIDES[side]["resolver"]
        lookup = r.build_lookup(schema)
        out[side] = ([asdict(f) for f in r.resolve_fields(LLM_RESULTS, lookup)],
                     sorted(lookup))
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("table_id", [None, "t0", "t1"])
def test_prompt_matches_jax(table_id):
    out = {}
    for side, schema in _schemas().items():
        out[side] = SIDES[side]["prompt"].build_messages(
            schema, _extraction(side), table_id=table_id)
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("options", [{}, {"simple": True}, {"no_normalize": True},
                                     {"visualize": True}])
def test_rule_extraction_matches_jax(options, tmp_path):
    img = np.full((300, 640, 3), 255, np.uint8)
    out = {}
    for side, schema in _schemas().items():
        outdir = tmp_path / side
        result = SIDES[side]["rules"].run_rule_extraction(
            schema, img, _extraction(side), outdir=str(outdir), filename="page", **options)
        out[side] = (result, _files(outdir))
    assert out["port"] == out["jax"]
    if not options:
        fields = out["port"][0]["fields"]
        assert fields["total"]["value"] == "1234" and fields["items"]["records"]


@pytest.mark.parametrize("layout", ["grid_and_kv", "kv_columns", "span"])
def test_rule_extraction_on_a_parse_matches_jax(layout, tmp_path):
    """On the parse ``_finalize`` makes of generated cells: the fields
    name the first table's cells by id, key and column header."""
    want, _ = _finalized(layout, 0)
    data = json.loads(json.dumps(want.model_dump()))
    table = data["tables"][0]
    header = next(c for c in table["cells"].values() if c["role"] == "header")
    value = next(c for c in table["cells"].values() if c["role"] == "cell")
    fields = [{"name": "by_id", "cell_id": value["id"]},
              {"name": "by_key", "description": header["contents"]},
              {"name": "by_box", "bbox": value["box"]},
              {"name": "by_regex", "regex": r"c\d_\d+"},
              {"name": "grid", "structure": "table", "columns": [
                  {"name": "first", "cell_id": header["id"]},
                  {"name": "second", "description": header["contents"]}]}]
    out = {}
    for side, schema in _schemas(data).items():
        outdir = tmp_path / side
        result = SIDES[side]["rules"].run_rule_extraction(
            schema, np.zeros((800, 900, 3), np.uint8), _extraction(side, fields),
            outdir=str(outdir), filename="page", visualize=True)
        out[side] = (result, _files(outdir))
    assert out["port"] == out["jax"]
    assert out["port"][0]["fields"]["by_id"]["value"] == value["contents"]


@pytest.mark.parametrize("options", [{}, {"simple": True}, {"prompt_only": True},
                                     {"visualize": True, "table_id": "t0"}])
def test_run_extraction_matches_jax(options, tmp_path, monkeypatch):
    """``run_extraction`` with ``call_llm`` stubbed on both sides: the
    same messages reach it and the same files come out."""
    img = np.full((300, 640, 3), 255, np.uint8)
    out = {}
    for side, schema in _schemas().items():
        calls = []

        def call_llm(messages, model, **kwargs):
            calls.append((messages, model, kwargs))
            return {"results": json.loads(json.dumps(LLM_RESULTS))}

        monkeypatch.setattr(SIDES[side]["pipeline"], "call_llm", call_llm)
        outdir = tmp_path / side
        result = SIDES[side]["pipeline"].run_extraction(
            schema, img, _extraction(side), model="m", api_base="http://localhost:1/v1",
            outdir=str(outdir), filename="page", **options)
        out[side] = (result, calls, _files(outdir) if outdir.exists() else {})
    assert out["port"] == out["jax"]
    assert bool(out["port"][1]) != bool(options.get("prompt_only"))


class _Completions:
    def __init__(self, replies, seen):
        self.replies, self.seen = replies, seen

    def create(self, **kwargs):
        self.seen.append(kwargs)
        reply = self.replies.pop(0)
        if isinstance(reply, Exception):
            raise reply
        message = types.SimpleNamespace(content=reply)
        return types.SimpleNamespace(choices=[types.SimpleNamespace(message=message)])


@pytest.mark.parametrize("replies", [
    ['{"results": [{"name": "a", "value": "1"}]}'],
    ['```json\n{"results": []}\n```'],
    [ValueError("response_format"), 'text {"results": [{"name": "b"}]} tail'],
])
def test_call_llm_matches_jax(replies, monkeypatch):
    """``call_llm`` against a stubbed ``openai`` module: the request's
    arguments, the JSON fence stripping and the plain-text fallback."""
    out = {}
    for side in SIDES:
        seen = []
        stub = types.ModuleType("openai")
        stub.OpenAI = lambda **kw: types.SimpleNamespace(
            kw=kw, chat=types.SimpleNamespace(completions=_Completions(list(replies), seen)))
        monkeypatch.setitem(sys.modules, "openai", stub)
        try:
            result = SIDES[side]["llm"].call_llm([{"role": "user", "content": "x"}], "m",
                                                 api_base="http://localhost:1/v1")
        except Exception as e:  # both sides must fail alike
            result = repr(e)
        out[side] = (result, seen)
    assert out["port"] == out["jax"]


def test_call_llm_without_openai_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "openai", None)
    with pytest.raises(ImportError, match="openai package is required"):
        port_llm.call_llm([{"role": "user", "content": "x"}], "m")


# ----------------------------------------------------------------- the CLIs


CLI_SCHEMA = """
fields:
  - name: first
    cell_id: c1
  - name: box
    bbox: [0, 0, 400, 400]
  - name: any_text
    regex: ".+"
  - name: grid
    structure: table
    columns:
      - name: a
        cell_id: c0
      - name: b
        cell_id: c2
"""


@pytest.fixture
def injected(parsers, monkeypatch):  # noqa: F811
    """Each CLI module's TableSemanticParser hands back the prebuilt
    parser of its package (pinned cells), recording its arguments; the
    page is demo/sample_table.png."""
    jax, port, _, _ = parsers
    built = {"jax": [], "port": []}
    for side, parser, modules in (("jax", jax, (jax_rule, jax_extract)),
                                  ("port", port, (port_rule, port_extract))):
        cd = parser.cell_detector
        monkeypatch.setattr(cd.postprocessor, "filter_packed", pinned_filter_packed(cd))

        def make(_parser=parser, _built=built[side], **kwargs):
            _built.append(kwargs)
            _parser.visualize = kwargs["visualize"]
            return _parser

        for module in modules:
            monkeypatch.setattr(module, "TableSemanticParser", make)
    yield built
    for parser in (jax, port):
        parser.visualize = True


def _run(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["yomitoku_extract", *map(str, argv)])
    module.main()


CLI_CASES = {
    "rule": ([], (jax_rule, port_rule)),
    "rule_vis_simple": (["-v", "--simple"], (jax_rule, port_rule)),
    "rule_no_normalize": (["--no-normalize", "--pages", "1"], (jax_rule, port_rule)),
    "llm": (["-m", "model", "--api_base", "http://localhost:1/v1", "--table_id", "t0"],
            (jax_extract, port_extract)),
    "llm_prompt_only_vis": (["-m", "model", "--prompt-only", "-v"],
                            (jax_extract, port_extract)),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_clis_match_jax(case, injected, tmp_path, monkeypatch):
    """Both CLIs on demo/sample_table.png: the same files, byte for byte
    (the extracted fields name cells of the pinned grid)."""
    flags, modules = CLI_CASES[case]
    schema = tmp_path / "schema.yaml"
    schema.write_text(CLI_SCHEMA, encoding="utf-8")
    seen = {}
    for pipeline in (jax_pipeline, port_pipeline):
        monkeypatch.setattr(pipeline, "call_llm", lambda messages, model, _p=pipeline, **kw:
                            seen.setdefault(_p.__name__, (messages, model, kw)) and
                            {"results": [{"name": "first", "value": "v", "cell_ids": ["c1"]}]})
    outs = {}
    for side, module in zip(("jax", "port"), modules):
        out = tmp_path / side
        _run(module, [SAMPLE, "-s", schema, "-o", out, *flags, "-d", "cpu"], monkeypatch)
        outs[side] = _files(out)
    assert outs["port"] == outs["jax"]
    assert injected["port"] == injected["jax"] == [
        {"configs": {}, "device": "cpu", "visualize": "-v" in flags}]
    names = set(outs["port"])
    if "prompt_only" not in case:
        assert "sample_table_p1_extract.json" in names
        fields = json.loads(outs["port"]["sample_table_p1_extract.json"])
        assert fields
    if "-v" in flags:
        assert {"sample_table_p1_layout.jpg", "sample_table_p1_ocr.jpg"} <= names
    if case.startswith("llm") and "prompt_only" not in case:
        assert seen["yomitoku_tpu.extractor.pipeline"] == seen[
            "yomitoku_tpu_torch.extractor.pipeline"]


@pytest.mark.parametrize("module", [port_rule, port_extract])
def test_cli_errors(module, tmp_path, monkeypatch):
    schema = tmp_path / "schema.yaml"
    schema.write_text(CLI_SCHEMA, encoding="utf-8")
    model = ["-m", "m"] if module is port_extract else []
    with pytest.raises(FileNotFoundError, match="Input path"):
        _run(module, [tmp_path / "absent.png", "-s", schema, *model], monkeypatch)
    with pytest.raises(FileNotFoundError, match="Schema file"):
        _run(module, [SAMPLE, "-s", tmp_path / "absent.yaml", *model], monkeypatch)
    with pytest.raises(SystemExit):
        _run(module, [SAMPLE, *model], monkeypatch)  # -s is required
    with pytest.raises((RuntimeError, ValueError), match="tpu"):
        _run(module, [SAMPLE, "-s", schema, "-d", "tpu", *model], monkeypatch)
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            _run(module, [SAMPLE, "-s", schema, *model], monkeypatch)  # -d cuda
    if module is port_extract:
        with pytest.raises(SystemExit):
            _run(module, [SAMPLE, "-s", schema], monkeypatch)  # -m is required


def test_cli_default_device_is_cuda(monkeypatch):
    for module in (port_rule, port_extract):
        seen = {}
        monkeypatch.setattr(module, "resolve_device",
                            lambda d: seen.setdefault("device", d) and (_ for _ in ()).throw(
                                RuntimeError("stop")))
        with pytest.raises(RuntimeError, match="stop"):
            _run(module, [SAMPLE, "-s", ROOT / "pyproject.toml", "-m", "m"]
                 if module is port_extract else [SAMPLE, "-s", ROOT / "pyproject.toml"],
                 monkeypatch)
        assert seen["device"] == "cuda"


def test_cli_file_loop(tmp_path, monkeypatch):
    """A directory: a file that fails to load is logged with its traceback
    and skipped; a kernel build failure ends the run."""
    schema = tmp_path / "schema.yaml"
    schema.write_text(CLI_SCHEMA, encoding="utf-8")
    inputs = tmp_path / "in"
    inputs.mkdir()
    (inputs / "a_broken.png").write_bytes(b"not an image")
    cv2.imwrite(str(inputs / "b_page.png"), np.full((64, 96, 3), 255, np.uint8))

    class Parser:
        def __init__(self, fail):
            self.fail, self.pages = fail, 0

        def batch(self, imgs):
            if self.fail:
                raise KernelBuildError("nvcc failed")
            self.pages += len(imgs)
            return [(port_schema.TableSemanticParserSchema(tables=[], paragraphs=[],
                                                           words=[]), None, None)
                    for _ in imgs]

    ok = Parser(fail=False)
    monkeypatch.setattr(port_rule, "TableSemanticParser", lambda **kw: ok)
    catch = _Catch()
    port_rule.logger.addHandler(catch)
    try:
        _run(port_rule, [inputs, "-s", schema, "-o", tmp_path / "out", "-d", "cpu"],
             monkeypatch)
    finally:
        port_rule.logger.removeHandler(catch)
    assert ok.pages == 1 and (tmp_path / "out" / "b_page_p1_extract.json").exists()
    failed = [r for r in catch.records if r.getMessage().startswith("Failed to process")]
    assert len(failed) == 1 and "a_broken.png" in failed[0].getMessage()
    assert failed[0].exc_info and failed[0].exc_info[0] is ValueError
    monkeypatch.setattr(port_rule, "TableSemanticParser", lambda **kw: Parser(fail=True))
    with pytest.raises(KernelBuildError):
        _run(port_rule, [inputs, "-s", schema, "-o", tmp_path / "out2", "-d", "cpu"],
             monkeypatch)


def test_cli_helpers_match_jax(tmp_path):
    for text in ("1", "1,3", "2-4", "1-2,5,7-8"):
        assert port_rule.parse_pages(text) == jax_rule.parse_pages(text)
    (tmp_path / "d").mkdir()
    for name in ("a.png", "b.PDF", "c.txt", "d/e.jpg"):
        (tmp_path / name).write_bytes(b"x")
    assert port_rule.collect_files(tmp_path) == jax_rule.collect_files(tmp_path)
    assert port_rule.collect_files(tmp_path / "a.png") == [tmp_path / "a.png"]
