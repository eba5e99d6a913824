"""The metrics that read the program's own stage spans
(``utils/stagetrace.py``), at the tiny cell (tiny.py) run traced on the
CPU: each is in the result line, beside the outside metrics it pairs
with.  The card's metrics (rooflines, idle share) read a device trace the
CPU has not, and stay out."""

import time

from portbench.core import harness

import tiny

SEED = 2**31 + 31
SPANS = ("page.self_ms", "det.span_ms", "rec.span_ms", "parseq.ar_span_ms",
         "parseq.done_wait_ms")


def test_tiny_traced_run_reads_the_program_spans(tmp_path):
    root, wl = tiny.write_root(tmp_path)
    result, _ = harness.run_cell(wl, SEED, 4.0, True, time.perf_counter(), device="cpu",
                                 root=root)
    assert result["failed"] == 0
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(SPANS) <= set(m), sorted(set(SPANS) - set(m))
    assert not {"kernel.attn_block_ln_roofline", "kernel.mlp_ln_roofline",
                "device.idle_share"} & set(m)
    # The spans and the timed calls cover the same calls: every page of the
    # window, and each client's page that ends after it.  The span metrics
    # divide by the window's pages, the timed calls by their calls.
    calls = result["attempted"]
    pages = calls - tiny.TRAFFIC["clients"]
    assert pages >= 1
    for span, timed in (("det.span_ms", "det.page_ms"), ("rec.span_ms", "rec.page_ms")):
        assert 0 < m[span] * pages <= m[timed] * calls, (span, m)
    assert 0 < m["parseq.done_wait_ms"] < m["parseq.ar_span_ms"] < m["rec.span_ms"]
    assert m["page.self_ms"] > 0
