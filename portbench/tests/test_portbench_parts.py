"""The benchmark's parts on the CPU: the traffic generator's line counts,
the bound and operation arithmetic against hand counts, files found by
name, and what the harness and the reference import."""

import hashlib
import json
import subprocess
import sys

import numpy as np
import pytest

from portbench.core import harness, pages, peaks
from portbench.core.harness import ROOT
from portbench.reference import quads as ref_quads

SEEDS = (0, 1, 2**31 + 3, 2**33 + 17)


def _cell(name):
    traffic = json.loads((ROOT / f"portbench/traffic/{name}.json").read_text())
    config = json.loads((ROOT / "portbench/configs/ocr-large.json").read_text())
    return traffic, config["text_detector"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mix", ["statement", "prose"])
def test_traffic_line_count_is_planned(mix, seed):
    """Every page carries exactly columns x rows lines, and the program's
    postprocessor finds exactly those, at the reference's quads."""
    from yomitoku_tpu_torch.postprocessor.dbnet_postprocessor import DBnetPostProcessor

    traffic, det = _cell(mix)
    page = pages.make_page(traffic, det, seed, 3)
    n = traffic["columns"] * traffic["rows"]
    assert len(page.lines) == len(page.cores) == n
    post = DBnetPostProcessor(det["min_size"], det["thresh"], det["box_thresh"],
                              det["max_candidates"], det["unclip_ratio"])
    quads, scores = post({"binary": page.map}, page.image.shape[:2])
    want = ref_quads.expected_quads(page.cores, page.map.shape[1:], page.image.shape[:2],
                                    det["unclip_ratio"])
    assert sorted(map(str, quads)) == sorted(map(str, want.tolist()))
    assert np.allclose(scores, traffic["paint_value"] / 255.0, atol=1e-6)


def test_seed_moves_glyphs_not_work():
    traffic, det = _cell("statement")
    a, b = (pages.make_page(traffic, det, s, 0) for s in (5, 6))
    assert a.image.shape == b.image.shape and len(a.lines) == len(b.lines)
    assert not np.array_equal(a.image, b.image)
    assert np.array_equal(a.image, pages.make_page(traffic, det, 5, 0).image)


def test_bound_and_flop_arithmetic_hand_counts():
    # attention sublayer at B 2, L 4, D 8: projections 8*2*4*64 = 4096,
    # QK^T and PV 4*2*16*8 = 1024; bytes 2*(2*64 x + out + 4*64 w + 6*8)
    assert peaks.attn_block_ln(2, 4, 8) == (5120, 2 * (128 + 256 + 48))
    # MLP sublayer at M 4, D 8, hidden 32: 4*4*8*32; 2*(2*32 + 2*256 + 32 + 24)
    assert peaks.mlp_ln(4, 8, 32) == (4096, 2 * (64 + 512 + 32 + 24))
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    # one-block PARSeq, D 8 (mlp 32), 2x4 patches on 2x8 (N 2), 3 classes,
    # max label 1 (L 2), one AR step
    c = {"embed_dim": 8, "decoder_embed_dim": 8, "patch_size": [2, 4], "img_size": [2, 8],
         "mlp_ratio": 4, "depth": 1, "max_label_length": 1, "num_tokens": 5,
         "decoder_mlp_ratio": 4}
    patch = 2 * 2 * 24 * 8                                # 768
    block = 8 * 2 * 64 + 4 * 4 * 8 + 4 * 2 * 8 * 32      # 1024 + 128 + 2048
    per_pos = 12 * 64 + 4 * 8 * 32 + 2 * 8 * 3           # 768 + 1024 + 48
    ar = 4 * 2 * 64 + per_pos + 4 * 1 * 8 + 4 * 2 * 8     # memory K/V, one step
    refine = 2 * (per_pos + 4 * 2 * 8 + 4 * 2 * 8)
    assert peaks.parseq_line_flops(c, 1) == patch + block + ar + refine


def test_dbnet_flops_counts_the_convolutions():
    """The counter's total at 64x64 equals the convolutions' 2 * out pixels
    * cin * kh * kw * cout summed over the reference's layers."""
    import torch
    import torch.nn.functional as F

    from portbench.reference import dbnet
    from portbench.reference.precision import Precision

    config = json.loads((ROOT / "portbench/configs/ocr-large.json").read_text())
    det = config["text_detector"]
    total = 0

    class Counting(Precision):
        def conv2d(self, x, w, b=None, stride=1, padding=0, dilation=1):
            nonlocal total
            y = F.conv2d(x, w, b, stride, padding, dilation)
            total += 2 * y[0, 0].numel() * w.numel()
            return y

        def conv_transpose2d(self, x, w, b=None, stride=1):
            nonlocal total
            total += 2 * x[0, 0].numel() * w.numel()
            return F.conv_transpose2d(x, w, b, stride)

    params = {n: torch.zeros(s) for n, s, _, _ in dbnet.param_spec(det)}
    for n in params:
        if n.endswith("running_var"):
            params[n] += 1.0
    dbnet.forward(params, torch.zeros(1, 3, 64, 64), Counting())
    assert peaks.dbnet_flops(det, (64, 64)) == total


def _digest(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_traffic_and_metric_found_by_name(tmp_path):
    """A configuration, a mix and a metric reader added as files, with
    BENCHMARK.json entries, are found by name; no file that was there
    changes."""
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "portbench")
    cfg = json.loads((tmp_path / "portbench/configs/ocr-middle.json").read_text())
    (tmp_path / "portbench/configs/extra.json").write_text(json.dumps(cfg))
    mix = json.loads((tmp_path / "portbench/traffic/prose.json").read_text())
    mix["rows"] = 40
    (tmp_path / "portbench/traffic/sparse.json").write_text(json.dumps(mix))
    (tmp_path / "portbench/metrics/extra.pages.py").write_text(
        "def read(r):\n    return r.pages * 2\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "extra", "source": "s", "file": "portbench/configs/extra.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "extra.sparse", "config": "extra", "traffic": "sparse",
                               "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "extra.pages", "unit": "pages", "better": "higher",
                               "source": "host_clock", "layer": "whole page",
                               "moves": "pages_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    got, wl, config, traffic = harness.load_cell("extra.sparse", tmp_path)
    assert config == cfg and traffic == mix and wl["config"] == "extra"

    class R:
        pages, spans, stages, stretch, flops, seconds = 7, {}, {}, None, 0, 1.0

        class lock:
            held = waited = 0.0

        def op_roofline(self, label, cost):
            return None

    out = harness.read_per_layer(got, R(), tmp_path)
    assert out["extra.pages"] == {"value": 14.0, "unit": "pages"}
    # readers that find nothing to read leave their metrics out
    assert set(out) == {"extra.pages"}
    after = _digest(tmp_path / "portbench")
    assert all(after[p] == d for p, d in before.items())


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    """The harness with the program it drives (imported as a run does)
    loads no module whose whole top-level name is jax, jaxlib, flax or
    yomitoku_tpu."""
    top = _modules_after(
        "import sys; sys.path.insert(0, 'portbench')\n"
        "import run; run.cache_dirs()\n"
        "from portbench.core import harness, judge, trace, pages, peaks, weights\n"
        "import yomitoku_tpu_torch.ocr, yomitoku_tpu_torch.utils.stagetrace\n"
        "import importlib.util, pathlib\n"
        "for p in pathlib.Path('portbench/metrics').glob('*.py'):\n"
        "    s = importlib.util.spec_from_file_location('m' + str(hash(p)), p)\n"
        "    s.loader.exec_module(importlib.util.module_from_spec(s))\n")
    assert "yomitoku_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "yomitoku_tpu"}


def test_reference_imports_nothing_of_the_program():
    top = _modules_after("from portbench.reference import dbnet, parseq, pages, quads, precision")
    assert not top & {"yomitoku_tpu_torch", "jax", "jaxlib", "flax", "yomitoku_tpu"}


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ocr-large.statement",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def _stretch(**ranges):
    return {"ranges": ranges, "busy_s": 1.0}


def _whole():
    return [harness.PageRecord(n, 0) for n in range(harness.STRETCH_PAGES)]


@pytest.mark.parametrize("ranges, calls, problem", [
    ({"mlp_ln": [1e-3, 2e-3]}, {"mlp_ln": 2}, None),
    ({"mlp_ln": []}, {}, None),                  # an op the program no longer calls
    ({"mlp_ln": [0.0, 0.0]}, {"mlp_ln": 2}, None),  # its kernels not visible: silent
    ({"mlp_ln": [1e-3]}, {"mlp_ln": 2}, "1 mlp_ln ranges recorded for 2 calls"),
    ({"mlp_ln": [1e-3, 0.0]}, {"mlp_ln": 2}, "mlp_ln: 1 of 2 ranges lost their kernels"),
])
def test_stretch_problem_reads_lost_records_not_the_implementation(ranges, calls, problem):
    class Ops:
        shapes = {k: [(1, 2, 3)] * n for k, n in calls.items()}

    assert harness.stretch_problem(_stretch(**ranges), Ops(), _whole()) == problem


def test_silent_roofline_where_the_op_never_ran():
    r = harness.Readings.__new__(harness.Readings)
    r.stretch = {"shapes": {}, "ranges": {"mlp_ln": []}}
    assert r.op_roofline("mlp_ln", lambda *s: (1.0, 1.0)) is None


def test_row_steps_hand_count():
    import torch

    tgt = torch.tensor([[9, 4, 0, 5, 5], [9, 4, 4, 4, 0], [9, 3, 3, 3, 3]])
    assert harness.row_steps(tgt).tolist() == [2, 4, 5]
    assert int(harness.row_steps(tgt)[:2].max()) == 4


def test_program_without_a_read_entry_fails_loudly():
    class Det:
        def forward_from_page(self, *a):
            pass

    class Rec:
        def forward_tokens_from_page(self, *a):
            pass

    program = harness.Program.__new__(harness.Program)
    program.det_model, program.rec_model = Det(), Rec()
    with pytest.raises(harness.SetupError, match=r"Rec\._ar_cached"):
        program.install([])


def test_op_ranges_skip_an_entry_the_program_dropped(monkeypatch):
    from yomitoku_tpu_torch.models.layers import attention

    from portbench.core import trace

    monkeypatch.delattr(attention, "fused_mlp_ln")
    ops = trace.OpRanges()
    ops.install()
    try:
        assert [name for _, name, _ in ops._undo] == ["fused_attention_block_ln_packed"]
    finally:
        ops.uninstall()


def test_sample_numbers_drawn_from_the_seed():
    from portbench.core import judge

    a = judge.sample_numbers(2**33 + 5, 40)
    assert a == judge.sample_numbers(2**33 + 5, 40) and len(a) == judge.SAMPLE
    assert all(0 <= n < 40 for n in a)
    assert judge.sample_numbers(7, 0) == {0}
