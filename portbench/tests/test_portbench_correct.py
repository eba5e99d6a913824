"""``correct`` on the CPU, at the tiny cell (tiny.py): the run as it is
comes out correct; each fault the OCR cell can have, planted in the timed
path, makes it false; the control (the reference in float8 in the
program's place) reads above the limits."""

import time

import pytest
import torch

from portbench.core import harness, judge

import tiny

SEED = 2**31 + 29


def _run(tmp_path, tamper=None):
    root, wl = tiny.write_root(tmp_path)
    result, checks = harness.run_cell(wl, SEED, 8.0, False, time.perf_counter(),
                                      device="cpu", root=root, tamper=tamper)
    assert result["attempted"] > 0
    return result, {name: (v, lim) for name, v, lim in checks}


def test_tiny_run_is_correct(tmp_path):
    result, checks = _run(tmp_path)
    assert result["correct"], checks
    assert list(result)[-1] == "checks"


def _ar_unchanged(stage, a, b):
    """The AR loop's step returns its state unchanged: the reset state
    [BOS, PAD, ...] (BOS = num_tokens - 2, PAD = num_tokens - 1)."""
    if stage == "ar":
        a = torch.full_like(a, 7120)
        a[:, 0] = 7119
    return a, b


def _half_batch(stage, a, b):
    """Half of each batch left out: its ids those of the other half."""
    if stage == "final":
        a, h = a.copy(), (len(a) + 1) // 2
        a[h:] = a[:len(a) - h]
    return a, b


def _token_altered(stage, a, b):
    """One token altered where it is produced."""
    if stage == "final":
        a = a.copy()
        a[0, 1] = (a[0, 1] + 1) % 7000 + 1
    return a, b


@pytest.mark.parametrize("fault", [_ar_unchanged, _half_batch, _token_altered])
def test_fault_comes_out_not_correct(tmp_path, fault):
    result, checks = _run(tmp_path, tamper=fault)
    assert not result["correct"], checks


def test_control_reads_above_the_limits(tmp_path):
    """The float8 reference in the program's place fails a number."""
    root, wl = tiny.write_root(tmp_path)
    _, _, config, traffic = harness.load_cell(wl, root)
    session = harness.Session(config, traffic, "cpu")
    session.seed(SEED)
    clients = harness.Clients(traffic["clients"], session.program, session.pool)
    try:
        clients.keep = judge.sample_numbers(SEED, 2)
        clients.warm(1)
        clients.window(6.0)
        clients.wait()
    finally:
        clients.close()
    inside = [r for r in clients.records if r.error is None]
    checks = judge.judge(config, traffic, session.pool, inside, clients.keep,
                         session.det_w, session.rec_w, "cpu", control=True)
    deep = {name: v for name, v, _ in checks if isinstance(v, tuple)}
    assert all(prog <= tiny.LIMITS[name] for name, (prog, _) in deep.items()), deep
    assert any(ctrl > tiny.LIMITS[name] for name, (_, ctrl) in deep.items()), deep


def test_sampled_page_not_completed_is_not_correct(tmp_path):
    """A sampled page that never completed in the window is counted."""
    root, wl = tiny.write_root(tmp_path)
    _, _, config, traffic = harness.load_cell(wl, root)
    checks = judge.judge(config, traffic, [], [], frozenset({3}), {}, {}, "cpu")
    assert ("unsampled", 1, 0) in checks
