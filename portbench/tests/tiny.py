"""A cell small enough for the CPU: full-width DBNet on a 400x300 page,
a one-block PARSeq of width 32, float32, with a BENCHMARK.json of its
own in a temporary root beside the real configurations, mixes and
metric readers."""

import json
import shutil
from pathlib import Path

from portbench.core.harness import ROOT

REC_YAML = """encoder:
  depth: 1
  embed_dim: 32
  num_heads: 2
  patch_size: [8, 8]
decoder:
  embed_dim: 32
  num_heads: 2
max_label_length: 8
data:
  img_size: [32, 128]
  batch_size: 8
"""
DET_YAML = """data:
  shortest_size: 256
  limit_size: 320
"""
TRAFFIC = {"page_hw": [400, 300], "pool": 2, "clients": 2, "columns": 2, "rows": 6,
           "margin": [20, 20], "column_gap": 20, "row_pitch": 40, "glyphs": [2, 5],
           "glyph_h": [26, 30], "glyph_w": [13, 17], "advance": 19, "paint_value": 230}
#: the float32 program on the CPU against the float32 reference
LIMITS = {"det_map_q": 1.0, "ar_gap": 1e-3, "refine_gap": 1e-3}


def write_root(tmp: Path, limits=LIMITS):
    """-> (root, workload name) of a tiny cell under ``tmp``: the real
    portbench files copied beside a configuration ``tiny`` and a mix
    ``tiny``."""
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp / "rec.yaml").write_text(REC_YAML)
    (tmp / "det.yaml").write_text(DET_YAML)
    cfg = json.loads((ROOT / "portbench/configs/ocr-large.json").read_text())
    cfg["dtype"], cfg["int8_kv"], cfg["limits"] = "float32", False, dict(limits)
    cfg["text_detector"].update(shortest_size=256, limit_size=320, path_cfg=str(tmp / "det.yaml"))
    cfg["text_recognizer"].update(embed_dim=32, depth=1, num_heads=2, decoder_embed_dim=32,
                                  decoder_num_heads=2, max_label_length=8, img_size=[32, 128],
                                  batch_size=8, path_cfg=str(tmp / "rec.yaml"))
    (tmp / "portbench/configs/tiny.json").write_text(json.dumps(cfg))
    (tmp / "portbench/traffic/tiny.json").write_text(json.dumps(TRAFFIC))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test", "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.tiny", "config": "tiny", "traffic": "tiny",
                               "chips": 1, "why": "test"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp, "tiny.tiny"
