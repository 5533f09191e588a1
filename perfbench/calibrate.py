"""The readings that a cell's limits are set from.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,...,12 \\
        [--seconds 3] [--out readings_<cell>.json]

runs the cell once a seed, in one process, at the cell's own sizes and
load for a short window, and prints for each seed the numbers that decide
``correct`` as the program gives them and as the control gives them: the
plain reference computed in TF32 (the precision just below the
configuration's float32), put in the program's place on the same
answers. The largest reading of the program over the seeds is the lower
reading of a limit, the smallest of the control the upper one. A sliding
cell also reads a planted fault (its factor one request's fold behind)
and the witnesses of its factor's drift (the worst answer of young and
of old factors; the program's own refactorization of the end window).
"""
from __future__ import annotations

import time

import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path[:] = [os.path.join(_ROOT, "src"), _ROOT] + [
    p for p in sys.path if os.path.abspath(p or ".") != _HERE]

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    from perfbench import harness, spec
    if not torch.cuda.is_available():
        print("the readings are taken on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.resolve(args.workload)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        out = harness.run_cell(cell, seed, args.seconds, trace=False,
                               device=device, t_start=time.perf_counter(),
                               control=True)
        row = {"seed": seed, "correct": out.correct,
               "program": dict(out.values),
               "control": out.control, "checked": out.ctx.checked,
               "attempted": out.attempted, "e2e": out.e2e}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del out
        torch.cuda.empty_cache()
    keys = rows[0]["program"].keys()
    lower = {k: max(r["program"][k] for r in rows) for k in keys}
    upper = {k: min(r["control"][k] for r in rows)
             for k in keys if k in rows[0]["control"]}
    # the planted faults' and the witnesses' readings: least and most
    others = {k: [min(r["control"][k] for r in rows),
                  max(r["control"][k] for r in rows)]
              for k in rows[0]["control"] if k not in keys}
    summary = {"workload": args.workload, "seconds": args.seconds,
               "device": torch.cuda.get_device_name(0), "lower": lower,
               "control_least": upper, "others": others, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps({"lower": lower, "control_least": upper,
                      "others": others}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
