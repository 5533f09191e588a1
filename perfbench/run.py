"""One run of one benchmark cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``) names its
configuration and traffic mix; the run draws every input from the seed
on the card, warms up the cell's shapes, measures for ``--seconds``
(``--trace 1``: under the profiler), compares a sample of what the timed
path produced with the plain reference, and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared beside its limit. The same numbers end
standard error.

Exit codes: 0 a result was printed; 2 no card, or fewer cards than the
cell needs; 3 the run loaded JAX or the JAX package; 4 the profile was
incomplete; 1 anything else. Only exit 0 prints a result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# run as a script, this folder heads sys.path: put the checkout's root and
# its src/ there instead, so that modules are found by their full names
_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path[:] = [os.path.join(_ROOT, "src"), _ROOT] + [
    p for p in sys.path if os.path.abspath(p or ".") != _HERE]

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
# libraries that load JAX by themselves when they find it stay off it
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's or the JAX package's: ``repro_torch`` is not
    ``repro``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(cell, outcome, *, trace: bool, device_info: dict) -> dict:
    """The result's JSON object, ``checks`` last."""
    from perfbench import spec
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(outcome.ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(outcome.e2e[m["name"]]),
                                  "unit": m["unit"]}
    line = {"correct": bool(outcome.correct),
            "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": metrics,
            "device": device_info}
    if trace:
        data = outcome.ctx.trace
        line["breakdown"] = {"device_ops": data.top_ops(),
                             "idle_gaps": data.idle_gaps()}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in outcome.checks.items()}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench import spec

    cell = spec.resolve(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    return report(cell, args, torch.device("cuda", 0))


def report(cell, args, device) -> int:
    """The run after the look for the card: the cell on ``device``, its
    checks on standard error, its result as the last line of standard
    output. Returns the exit code."""
    import torch
    from perfbench import harness
    from perfbench.tracing import IncompleteProfile

    outcome = harness.run_cell(cell, args.seed, args.seconds,
                               trace=bool(args.trace), device=device,
                               t_start=T_START)
    on_card = device.type == "cuda"
    info = {"platform": "gpu" if on_card else device.type,
            "kind": torch.cuda.get_device_name(device) if on_card
            else device.type,
            "count": cell.chips,
            "memory_peak_bytes": int(outcome.ctx.memory_peak)}
    if args.trace:
        try:
            harness.check_complete(outcome.ctx)
        except IncompleteProfile as err:
            print(f"incomplete profile: {err}", file=sys.stderr)
            return 4
        info["busy_s"] = outcome.ctx.trace.busy_s
        info["window_s"] = outcome.ctx.trace.window_s
        info["power_limit_w"] = power_limit_w() if on_card else None
    line = result_line(cell, outcome, trace=bool(args.trace),
                       device_info=info)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, (v, lim) in outcome.checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
