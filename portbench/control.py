"""The readings the correctness limits are set from, for one cell.

    python3 portbench/control.py --workload <name> --seeds 1,2,... --control 3 --seconds 6

One process builds the cell's program once; for each seed it loads that
seed's weights and pages, runs the cell's clients for a short window at
the cell's own load, and reads every number the run compares (the
sampled pages' deep checks, module ``core/judge.py``).  For the first
``--control`` seeds it also reads the control: the reference in float8
put in the program's place, on the same pages and tokens.  Each side is
held to the configuration's limits by the run's own rule (every number
at or under its limit): ``correct`` is the program's verdict,
``control.correct`` the control's, which has to come out false.  One JSON
line per seed on standard output.  The benchmark's own runs never run
this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the numbers the control replaces; the others stay the program's
DEEP = ("det_map_q", "ar_gap", "refine_gap")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from run import cache_dirs

    cache_dirs()
    import torch

    from portbench.core import harness, judge

    if not torch.cuda.is_available():
        print("portbench: no CUDA card", file=sys.stderr)
        return 2
    _, _, config, traffic = harness.load_cell(args.workload)
    session = harness.Session(config, traffic, "cuda")
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        session.seed(seed)
        clients = harness.Clients(traffic["clients"], session.program, session.pool)
        try:
            clients.keep = judge.sample_numbers(seed, int(0.5 * args.seconds / clients.warm(1)))
            start = clients.window(args.seconds)
            clients.wait()
        finally:
            clients.close()
        end = start + args.seconds
        records = sorted(clients.records, key=lambda r: r.number)
        inside = [r for r in records if r.t1 <= end and r.error is None]
        checks = judge.judge(config, traffic, session.pool, inside, clients.keep,
                             session.det_w, session.rec_w, "cuda", control=i < args.control)
        failed = sum(r.error is not None for r in records)
        row = {"seed": seed, "pages": len(inside), "failed": failed}
        sound = bool(inside) and not failed
        for side, pick in (("", 0), ("control.", 1)):
            if side and i >= args.control:
                break
            read = [(name, v[pick] if isinstance(v, tuple) else v, lim) for name, v, lim in checks]
            row.update({side + name: v for name, v, _ in read if side == "" or name in DEEP})
            row[side + "correct"] = sound and all(v <= lim for _, v, lim in read)
        row["seconds"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
