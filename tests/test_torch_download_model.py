"""The port's ``cli/download_model.py`` and ``utils/graph.py`` against the
JAX package's, with no network: ``huggingface_hub`` is a stand-in in
``sys.modules`` (or missing), and the weight store is a temporary
``$YOMITOKU_TPU_WEIGHTS``.

- A stand-in ``snapshot_download`` writes a seed-0 ``parseq-tiny``
  state_dict (narrowed to D 32) into the repo's directory of the store,
  and ``weights.load_pretrained`` then loads it into a model of other
  weights, which ends equal to the seed-0 one.
- Where the import or the download fails, both packages warn, word for
  word, with the directory to place the checkpoint in, and return False.
- ``main`` downloads every default model, or the one ``--name`` names.
- ``Node`` builds the same links and prints the same as JAX's."""

import sys
import types
from pathlib import Path

import pytest
import torch

from yomitoku_tpu.cli import download_model as jax_dm
from yomitoku_tpu.utils.graph import Node as JaxNode
from yomitoku_tpu_torch import configs, weights
from yomitoku_tpu_torch.cli import download_model as dm
from yomitoku_tpu_torch.config import structured
from yomitoku_tpu_torch.models.parseq import PARSeq
from yomitoku_tpu_torch.utils.graph import Node

TINY = configs.TextRecognizerPARSeqTinyConfig


def _tiny_cfg():
    cfg = structured(TINY)
    cfg.encoder.depth = 1
    cfg.encoder.embed_dim = 32
    cfg.encoder.num_heads = 2
    cfg.decoder.embed_dim = 32
    cfg.decoder.num_heads = 2
    cfg.data.img_size = [16, 32]
    return cfg


def _hub(monkeypatch, snapshot_download):
    hub = types.ModuleType("huggingface_hub")
    hub.snapshot_download = snapshot_download
    monkeypatch.setitem(sys.modules, "huggingface_hub", hub)


def _said(monkeypatch, module):
    """The messages ``module``'s logger gives, by level."""
    said = {"info": [], "warning": []}
    for level, out in said.items():
        monkeypatch.setattr(module.logger, level, out.append)
    return said


def test_download_fills_the_store(tmp_path, monkeypatch):
    monkeypatch.setenv("YOMITOKU_TPU_WEIGHTS", str(tmp_path))
    cfg = _tiny_cfg()
    src = PARSeq(cfg, device="cpu")  # seed 0
    calls = []

    def snapshot_download(repo, local_dir):
        calls.append((repo, Path(local_dir)))
        Path(local_dir).mkdir(parents=True)
        torch.save(src.state_dict(), Path(local_dir) / "pytorch_model.bin")

    _hub(monkeypatch, snapshot_download)
    monkeypatch.setitem(dm._BY_NAME, TINY.__name__, TINY)
    said = _said(monkeypatch, dm)
    assert dm.download_one(TINY.__name__) is True
    dest = tmp_path / "yomitoku-text-recognizer-parseq-tiny"
    assert calls == [("KotaroKinoshita/yomitoku-text-recognizer-parseq-tiny", dest)]
    assert said == {"info": [f"downloaded {calls[0][0]} -> {dest}"], "warning": []}
    dst = PARSeq(cfg, device="cpu")
    dst.init_weights(seed=1)
    assert not torch.equal(dst.head.weight, src.head.weight)
    weights.load_pretrained(dst, cfg)
    assert dst.pretrained_source == "torch"
    for name, value in src.state_dict().items():
        assert torch.equal(dst.state_dict()[name], value), name


@pytest.mark.parametrize("failure", ["no_module", "no_network"])
def test_failure_warns_where_to_place_the_checkpoint(tmp_path, monkeypatch, failure):
    monkeypatch.setenv("YOMITOKU_TPU_WEIGHTS", str(tmp_path))
    if failure == "no_module":
        monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    else:
        def snapshot_download(repo, local_dir):
            raise OSError(f"cannot reach the hub for {repo}")

        _hub(monkeypatch, snapshot_download)
    name = "TextRecognizerPARSeqLargeV41Config"
    said = _said(monkeypatch, dm)
    jax_said = _said(monkeypatch, jax_dm)
    assert dm.download_one(name) is False
    assert jax_dm.download_one(name) is False
    assert said == jax_said and not said["info"] and len(said["warning"]) == 1
    assert (f"place its torch checkpoint (model.safetensors or pytorch_model.bin) under "
            f"{tmp_path / 'yomitoku-text-recognizer-parseq-large-v4_1'}/ manually"
            in said["warning"][0])


@pytest.mark.parametrize("argv", [[], ["--name", "TableCellParserRTDETRv2BetaConfig"]])
def test_main_downloads_the_default_models(monkeypatch, argv):
    assert [c.__name__ for c in configs.DEFAULT_CONFIGS] == \
        [c.__name__ for c in jax_dm.DEFAULT_CONFIGS]
    assert list(dm._BY_NAME) == list(jax_dm._BY_NAME)
    asked = []
    monkeypatch.setattr(dm, "download_one", asked.append)
    monkeypatch.setattr(sys, "argv", ["yomitoku_torch_download_model", *argv])
    dm.main()
    assert asked == ([argv[1]] if argv else list(dm._BY_NAME))


def test_main_refuses_an_unknown_name(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["yomitoku_torch_download_model", "--name", "nope"])
    with pytest.raises(SystemExit):
        dm.main()


def _graph(cls):
    nodes = [cls(0, {"contents": "a"}), cls(1, {"contents": "b"}), cls(2, {"box": [0]})]
    nodes[0].add_link(nodes[1])
    nodes[0].add_link(nodes[1])  # a second link to the same child adds nothing
    nodes[0].add_link(nodes[2])
    nodes[2].add_link(nodes[1])
    return nodes


def test_node_behaves_as_jax():
    got, want = _graph(Node), _graph(JaxNode)
    for g, w in zip(got, want):
        assert repr(g) == repr(w)
        assert (g.id, g.prop, g.is_locked) == (w.id, w.prop, w.is_locked)
        assert [c.id for c in g.children] == [c.id for c in w.children]
        assert [p.id for p in g.parents] == [p.id for p in w.parents]
    assert [repr(n) for n in got] == ["a", "b", "table"]
