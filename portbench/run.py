"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``portbench/configs/<name>.json``) and a traffic mix
(``portbench/traffic/<name>.json``).  The run loads and warms up the
program, drives the mix's clients for ``--seconds``, judges what they
got, and prints one JSON line last on standard output.  With ``--trace
1`` the line holds the per-layer metrics (``portbench/metrics``), else
the end-to-end ones.  The numbers compared for ``correct`` are printed
beside their limits as the last lines on standard error and under
``checks``, the line's last key.

It runs on the machine it is started on and needs a CUDA card: without
one, or with fewer than the cell asks for, it exits 2 and prints no
result.  Build and kernel caches stay in fixed directories under
``build/`` in this checkout.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules the run may never hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "yomitoku_tpu")


def cache_dirs():
    """Every build and kernel cache in a fixed directory of the checkout."""
    build = ROOT / "build"
    os.environ["YOMITOKU_TPU_NATIVE_DIR"] = str(build / "yomitoku_tpu_torch")
    os.environ["TRITON_CACHE_DIR"] = str(build / "portbench" / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "portbench" / "nv")
    os.environ["USE_FLAX"] = "0"


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench.core import harness

    _, wl, _, _ = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"portbench: {wl['chips']} CUDA card(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    log = lambda msg: print(f"portbench: {msg}", file=sys.stderr, flush=True)  # noqa: E731
    result, checks = harness.run_cell(args.workload, args.seed, args.seconds,
                                      bool(args.trace), T_PROCESS, log=log)
    found = forbidden_loaded()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
