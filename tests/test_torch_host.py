"""The port's own copies of the host modules against their JAX-package
originals, on the same inputs (CPU, seeded numpy): preprocessing, the
recognizer's crops, the DBNet postprocessor (the port's own native build
against the JAX package's), the tokenizer, configs, schemas, the box
utilities, the visualisers, stage accounting, the timing observer and the
weight-store lookup.

Tolerance: equal outright (arrays bit for bit, lists and dicts by ==),
since both sides run the same numpy / OpenCV / C++ code on the same
inputs."""

import dataclasses
import json
import os

import cv2
import numpy as np
import pytest

import yomitoku_tpu.configs as jax_configs
import yomitoku_tpu.schemas as jax_schemas
import yomitoku_tpu_torch.configs as port_configs
import yomitoku_tpu_torch.schemas as port_schemas
from yomitoku_tpu import base as jax_base
from yomitoku_tpu import config as jax_config
from yomitoku_tpu import weights as jax_weights
from yomitoku_tpu.data import dataset as jax_dataset
from yomitoku_tpu.data import functions as jax_fn
from yomitoku_tpu.postprocessor import dbnet_postprocessor as jax_dbpost
from yomitoku_tpu.postprocessor import parseq_tokenizer as jax_tok
from yomitoku_tpu.utils import misc as jax_misc
from yomitoku_tpu.utils import stagetrace as jax_stagetrace
from yomitoku_tpu.utils import visualizer as jax_vis
from yomitoku_tpu_torch import base as port_base
from yomitoku_tpu_torch import config as port_config
from yomitoku_tpu_torch import weights as port_weights
from yomitoku_tpu_torch.constants import ROOT_DIR
from yomitoku_tpu_torch.data import dataset as port_dataset
from yomitoku_tpu_torch.data import functions as port_fn
from yomitoku_tpu_torch.ops import _build
from yomitoku_tpu_torch.postprocessor import dbnet_postprocessor as port_dbpost
from yomitoku_tpu_torch.postprocessor import parseq_tokenizer as port_tok
from yomitoku_tpu_torch.utils import misc as port_misc
from yomitoku_tpu_torch.utils import stagetrace as port_stagetrace
from yomitoku_tpu_torch.utils import visualizer as port_vis


def _page(h=240, w=320, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), dtype=np.uint8)


# ------------------------------------------------------------ preprocessing


@pytest.mark.parametrize("h,w", [(333, 517), (2339, 1654), (64, 4000), (1280, 960)])
def test_resize_shortest_edge_matches_jax(h, w):
    img = _page(h, w, seed=h)
    assert port_fn.shortest_edge_size(h, w, 1280, 1600) == jax_fn.shortest_edge_size(
        h, w, 1280, 1600)
    np.testing.assert_array_equal(port_fn.resize_shortest_edge(img, 1280, 1600),
                                  jax_fn.resize_shortest_edge(img, 1280, 1600))


def test_imagenet_statistics_match_jax():
    assert port_fn.IMAGENET_MEAN == jax_fn.IMAGENET_MEAN
    assert port_fn.IMAGENET_STD == jax_fn.IMAGENET_STD


QUADS = [
    [[10, 20], [110, 20], [110, 52], [10, 52]],      # axis-aligned
    [[30, 60], [150, 75], [146, 105], [26, 90]],     # skewed
    [[200, 10], [232, 10], [232, 190], [200, 190]],  # vertical: rotated
    [[300, 200], [330, 200], [330, 230], [300, 230]],  # past the right edge
    [[5, 5], [6, 5]],                                 # malformed
]


@pytest.mark.parametrize("i", range(len(QUADS)))
def test_crop_functions_match_jax(i):
    img = _page()
    quad = QUADS[i]
    assert bool(port_fn.validate_quads(img, quad)) == bool(jax_fn.validate_quads(img, quad))
    if not jax_fn.validate_quads(img, quad):
        return
    roi = port_fn.extract_roi_with_perspective(img, quad)
    np.testing.assert_array_equal(roi, jax_fn.extract_roi_with_perspective(img, quad))
    rot = port_fn.rotate_text_image(roi, 2)
    np.testing.assert_array_equal(rot, jax_fn.rotate_text_image(roi, 2))
    np.testing.assert_array_equal(port_fn.resize_with_padding(rot, (32, 80)),
                                  jax_fn.resize_with_padding(rot, (32, 80)))


def test_parseq_dataset_crops_match_jax():
    img = _page()
    cfg_p = port_config.load_config(port_configs.TextRecognizerPARSeqConfig)
    cfg_j = jax_config.load_config(jax_configs.TextRecognizerPARSeqConfig)
    got = port_dataset.ParseqDataset(cfg_p, img, QUADS, num_workers=2)
    want = jax_dataset.ParseqDataset(cfg_j, img, QUADS, num_workers=2)
    assert got.valid_quads == want.valid_quads and len(got) == len(want) == 3
    np.testing.assert_array_equal(got.as_u8_array(), want.as_u8_array())
    empty = port_dataset.ParseqDataset(cfg_p, img, QUADS[-1:], num_workers=1)
    np.testing.assert_array_equal(empty.as_u8_array(), jax_dataset.ParseqDataset(
        cfg_j, img, QUADS[-1:], num_workers=1).as_u8_array())


# ---------------------------------------------------------- postprocessors


def _prob_map(seed=3, h=96, w=160):
    """Blobs of text-like rectangles, some rotated, plus noise."""
    rng = np.random.RandomState(seed)
    m = np.zeros((h, w), np.float32)
    for _ in range(6):
        cx, cy = rng.randint(15, w - 15), rng.randint(10, h - 10)
        box = cv2.boxPoints(((cx, cy), (rng.randint(8, 40), rng.randint(4, 12)),
                             rng.uniform(-30, 30)))
        cv2.fillPoly(m, [box.astype(np.int32)], float(rng.uniform(0.6, 1.0)))
    return np.clip(m + rng.rand(h, w).astype(np.float32) * 0.2, 0, 1)


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_dbnet_postprocessor_native_matches_jax(wire, monkeypatch):
    monkeypatch.delenv("YOMITOKU_TPU_NO_NATIVE_POST", raising=False)
    prob = _prob_map()
    if wire == "uint8":
        prob = np.round(prob * 255).astype(np.uint8)
    args = dict(min_size=2, thresh=0.3, box_thresh=0.5, max_candidates=100,
                unclip_ratio=2.0)
    got = port_dbpost.DBnetPostProcessor(**args)({"binary": prob[None]}, (480, 800))
    want = jax_dbpost.DBnetPostProcessor(**args)({"binary": prob[None]}, (480, 800))
    assert port_dbpost.DBnetPostProcessor._native_ok is True
    assert len(got[0]) >= 3
    assert got == want


def test_dbnet_native_builds_into_the_port():
    """The port's contour library comes from its own csrc/ and lands under
    build/yomitoku_tpu_torch/, never in the JAX package's native/_build."""
    lib = _build.host_library("dbnet_post")
    path = os.path.realpath(lib._name)
    assert path.startswith(os.path.realpath(_build.BUILD_DIR))
    assert "yomitoku_tpu/native" not in path
    assert (_build.CSRC / "dbnet_post.cpp").is_file()


def test_dbnet_postprocessor_cv2_fallback_matches_jax(monkeypatch):
    monkeypatch.setenv("YOMITOKU_TPU_NO_NATIVE_POST", "1")
    prob = _prob_map(seed=4)
    args = dict(min_size=2, thresh=0.3, box_thresh=0.5, max_candidates=100,
                unclip_ratio=1.6)
    got = port_dbpost.DBnetPostProcessor(**args)({"binary": prob[None]}, (96, 160))
    want = jax_dbpost.DBnetPostProcessor(**args)({"binary": prob[None]}, (96, 160))
    assert len(got[0]) >= 3 and got == want


@pytest.mark.parametrize("charset_cfg", ["TextRecognizerPARSeqConfig",
                                         "TextRecognizerPARSeqV2Config"])
def test_tokenizer_matches_jax(charset_cfg):
    charset = port_misc.load_charset(getattr(port_configs, charset_cfg)().charset)
    assert charset == jax_misc.load_charset(getattr(jax_configs, charset_cfg)().charset)
    pt, jt = port_tok.ParseqTokenizer(charset), jax_tok.ParseqTokenizer(charset)
    assert len(pt) == len(jt) and (pt.eos_id, pt.bos_id, pt.pad_id) == (
        jt.eos_id, jt.bos_id, jt.pad_id)
    rng = np.random.RandomState(5)
    dists = rng.rand(6, 12, len(pt) - 2).astype(np.float32)
    dists[1, 4, 0] = 50.0  # an EOS mid-row
    dists /= dists.sum(-1, keepdims=True)
    assert pt.decode(dists) == jt.decode(dists)
    assert pt.decode(dists, raw=True) == jt.decode(dists, raw=True)
    labels = [charset[3:9], charset[100:101], charset[40:52]]
    np.testing.assert_array_equal(pt.encode(labels), jt.encode(labels))


# ------------------------------------------------------- configs, schemas


def _config_pairs():
    return [n for n in port_configs.__all__ if n.endswith("Config")]


@pytest.mark.parametrize("name", _config_pairs())
def test_configs_match_jax(name):
    """Each default config equals the JAX package's, but for resource paths,
    which point into the port (same files by content)."""
    got = port_config.load_config(getattr(port_configs, name))
    want = jax_config.load_config(getattr(jax_configs, name))
    for key in ("charset", "font"):
        for g, w in ((got, want), (got.get("visualize", {}), want.get("visualize", {}))):
            if key in w:
                assert g[key].startswith(ROOT_DIR) and os.path.isfile(g[key])
                with open(g[key], "rb") as a, open(w[key], "rb") as b:
                    assert a.read() == b.read()
                g[key] = w[key]
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


def test_load_config_yaml_merge_matches_jax(tmp_path):
    y = tmp_path / "c.yaml"
    y.write_text("max_label_length: 20\ndecoder:\n  depth: 2\n")
    got = port_config.load_config(port_configs.TextRecognizerPARSeqConfig, y)
    want = jax_config.load_config(jax_configs.TextRecognizerPARSeqConfig, y)
    assert got.max_label_length == want.max_label_length == 20
    assert got.decoder.depth == want.decoder.depth == 2
    y.write_text("no_such_key: 1\n")
    for mod, cfgs in ((port_config, port_configs), (jax_config, jax_configs)):
        with pytest.raises(KeyError):
            mod.load_config(cfgs.TextRecognizerPARSeqConfig, y)


SCHEMAS = ["Element", "TableCellSchema", "TableLineSchema",
           "TableStructureRecognizerSchema", "LayoutAnalyzerSchema",
           "WordPrediction", "TextDetectorSchema", "OCRSchema",
           "LayoutParserSchema", "TextRecognizerSchema"]


@pytest.mark.parametrize("name", SCHEMAS)
def test_schema_fields_match_jax(name):
    got = getattr(port_schemas, name).model_json_schema()
    want = getattr(jax_schemas, name).model_json_schema()
    assert got == want


def test_schema_validators_match_jax():
    for mod in (port_schemas, jax_schemas):
        ok = mod.WordPrediction(points=[[0, 0], [4, 0], [4, 2], [0, 2]],
                                content="a", direction="horizontal",
                                rec_score=0.5, det_score=0.9)
        assert ok.points[2] == [4, 2]
        with pytest.raises(Exception):
            mod.WordPrediction(points=[[0, 0], [4, 0]], content="a",
                               direction="horizontal", rec_score=0.5, det_score=0.9)
        with pytest.raises(Exception):
            mod.Element(box=[0, 0, 1], score=0.5, role=None)
        with pytest.raises(Exception):  # extra fields are forbidden
            mod.TextDetectorSchema(points=[], scores=[], extra=1)
    a = port_schemas.TextDetectorSchema(points=[[[1, 2], [3, 2], [3, 4], [1, 4]]],
                                        scores=[0.7])
    b = jax_schemas.TextDetectorSchema(points=[[[1, 2], [3, 2], [3, 4], [1, 4]]],
                                       scores=[0.7])
    assert a.model_dump() == b.model_dump()


# ------------------------------------------------------------ utilities


def _boxes(seed, n):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(1, 80, (n, 2))
    return np.concatenate([xy, xy + wh], 1)


def test_box_utilities_match_jax():
    a, b = _boxes(6, 12), _boxes(7, 15)
    b[:3] = a[:3] + [1.5, 1.5, -1.5, -1.5]  # nested boxes
    np.testing.assert_array_equal(port_misc.containment_matrix(a, b),
                                  jax_misc.containment_matrix(a, b))
    np.testing.assert_array_equal(port_misc.overlap_ratio_matrix(a, b),
                                  jax_misc.overlap_ratio_matrix(a, b))
    for i in range(len(a)):
        for j in range(len(b)):
            assert port_misc.calc_intersection(a[i], b[j]) == jax_misc.calc_intersection(a[i], b[j])
            assert port_misc.is_contained(a[i], b[j]) == jax_misc.is_contained(a[i], b[j])
    flags = [k % 3 != 0 for k in range(len(a))]
    assert port_misc.filter_by_flag(list(range(len(a))), flags) == jax_misc.filter_by_flag(
        list(range(len(a))), flags)


def test_visualizers_match_jax():
    img = _page()
    els = dict(paragraphs=[dict(id=None, box=[10, 10, 90, 40], score=0.9,
                                role="section_headings", contents=None)],
               tables=[dict(id=None, box=[20, 50, 200, 180], score=0.8, role=None,
                            contents=None)],
               figures=[])
    got = port_vis.layout_visualizer(port_schemas.LayoutParserSchema(**els), img)
    want = jax_vis.layout_visualizer(jax_schemas.LayoutParserSchema(**els), img)
    np.testing.assert_array_equal(got, want)
    cell = dict(col=1, row=2, col_span=1, row_span=2, box=[30, 60, 90, 100],
                contents=None)
    table = dict(box=[20, 50, 200, 180], n_row=3, n_col=2, rows=[], cols=[],
                 spans=[], cells=[cell], order=0)
    got = port_vis.table_visualizer(img, port_schemas.TableStructureRecognizerSchema(**table))
    want = jax_vis.table_visualizer(img, jax_schemas.TableStructureRecognizerSchema(**table))
    np.testing.assert_array_equal(got, want)


def test_stagetrace_matches_jax():
    results = []
    for mod in (port_stagetrace, jax_stagetrace):
        with mod.segment("rec", "dispatch", nbytes=5):  # no collector: free
            pass
        with mod.collect() as stats:
            for n in (3, 4):
                with mod.segment("rec", "dispatch", nbytes=n):
                    pass
            with mod.segment("det", "sync"):
                pass
        results.append((dict(stats.bytes), dict(stats.counts)))
    assert results[0] == results[1] == (
        {("rec", "dispatch"): 7, ("det", "sync"): 0},
        {("rec", "dispatch"): 2, ("det", "sync"): 1})


def test_model_catalog_matches_jax():
    out = []
    for mod in (port_base, jax_base):
        cat = mod.BaseModelCatalog()
        cat.register("parseq", "cfg", "model")
        with pytest.raises(ValueError):
            cat.register("parseq", "cfg", "model")
        with pytest.raises(ValueError):
            cat.get("nope")
        out.append((cat.get("PARSeq"), cat.list_model()))
    assert out[0] == out[1]


def test_observer_records_a_torch_profiler_trace(tmp_path, monkeypatch):
    """Under YOMITOKU_TPU_PROFILE the port's observer writes a torch.profiler
    Chrome trace per call under <dir>/<Module>/; otherwise it only times."""

    class Module:
        pass

    calls = []
    fn = port_base.observer(Module, lambda x: calls.append(x) or x * 2)
    monkeypatch.delenv("YOMITOKU_TPU_PROFILE", raising=False)
    assert fn(3) == 6 and not (tmp_path / "Module").exists()
    monkeypatch.setenv("YOMITOKU_TPU_PROFILE", str(tmp_path))
    assert fn(4) == 8 and calls == [3, 4]
    traces = list((tmp_path / "Module").glob("*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
    assert fn._is_observer


def test_weight_store_lookup_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("YOMITOKU_TPU_WEIGHTS", str(tmp_path))
    cfg = port_config.load_config(port_configs.TextRecognizerPARSeqLargeV41Config)
    assert port_weights.weights_dir() == jax_weights.weights_dir() == tmp_path
    assert port_weights._repo_name(cfg) == jax_weights._repo_name(cfg)
    assert port_weights._find_torch_checkpoint(cfg) is None
    sub = tmp_path / port_weights._repo_name(cfg)
    sub.mkdir()
    import torch

    torch.save({"w": torch.arange(6.0).reshape(2, 3)}, sub / "pytorch_model.bin")
    found = port_weights._find_torch_checkpoint(cfg)
    assert found == jax_weights._find_torch_checkpoint(cfg) == sub / "pytorch_model.bin"
    got, want = port_weights.load_torch_state_dict(found), jax_weights.load_torch_state_dict(found)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["w"], want["w"])


def test_config_dataclasses_are_the_ports_own():
    for name in _config_pairs():
        cls = getattr(port_configs, name)
        assert dataclasses.is_dataclass(cls)
        assert cls.__module__.startswith("yomitoku_tpu_torch.")
