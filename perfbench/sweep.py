"""The knee of a served cell: the highest offered rate whose backlog does
not grow over the window.

    python3 perfbench/sweep.py --workload <served cell> --rates 1000,2000,... \\
        [--seconds 5] [--seeds 1,2] [--out sweep_<cell>.json]

runs the cell's traffic at each rate in turn, once a seed, in one
process, and prints a line a run: the requests, the rate completed, the
median and 95th percentile latency, and the backlog (requests due and not
yet answered, sampled at each flush) over the first and the last quarter
of the window. A rate is sustained where, on every seed, the backlog does
not grow (the last quarter's mean is at most 1.5 times the first's plus
one microbatch) and the window takes at most 2 % longer than its
arrivals. The knee is the highest rate sustained; the rate a cell is run
at is written into its traffic file by hand: 4/5 of the knee.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path[:] = [os.path.join(_ROOT, "src"), _ROOT] + [
    p for p in sys.path if os.path.abspath(p or ".") != _HERE]

import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402


def backlog_grows(backlog, window_s: float, max_requests: int) -> tuple:
    """(first quarter's mean backlog, last quarter's, grows)."""
    t = np.array([b[0] for b in backlog])
    b = np.array([b[1] for b in backlog], dtype=float)
    first = b[t <= window_s / 4]
    last = b[t >= 3 * window_s / 4]
    f = float(first.mean()) if len(first) else 0.0
    la = float(last.mean()) if len(last) else float(b[-1])
    return f, la, la > 1.5 * f + max_requests


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    from perfbench import harness, spec
    if not torch.cuda.is_available():
        print("the sweep runs on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    rows = []
    for rate, seed in [(float(r), int(s)) for r in args.rates.split(",")
                       for s in args.seeds.split(",")]:
        cell = spec.resolve(args.workload)
        cell.traffic["rate_per_s"] = rate
        trail: dict = {}
        out = harness.run_cell(cell, seed, args.seconds, trace=False,
                               device=device, t_start=time.perf_counter(),
                               trail=trail)
        f, la, grows = backlog_grows(trail["backlog"], args.seconds,
                                     int(cell.traffic["max_requests"]))
        row = {"rate_per_s": rate, "seed": seed, "requests": out.attempted,
               "completed_per_s": out.attempted / trail["window_s"],
               "window_s": trail["window_s"],
               "p50_ms": out.e2e["request_p50_ms"],
               "p95_ms": out.e2e["request_p95_ms"],
               "backlog_first": f, "backlog_last": la, "grows": bool(grows),
               "sustained": bool(not grows and trail["window_s"]
                                 <= 1.02 * args.seconds),
               "correct": out.correct,
               "failed_checks": {k: v for k, (v, lim) in out.checks.items()
                                 if not v <= lim}}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del out
        torch.cuda.empty_cache()
    rates = sorted({r["rate_per_s"] for r in rows})
    held = [x for x in rates
            if all(r["sustained"] for r in rows if r["rate_per_s"] == x)]
    knee = max(held) if held else None
    summary = {"workload": args.workload, "seconds": args.seconds,
               "seeds": args.seeds, "device": torch.cuda.get_device_name(0),
               "knee_per_s": knee, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps({"knee_per_s": knee}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
