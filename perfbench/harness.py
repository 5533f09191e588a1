"""What every driver of the benchmark shares.

A cell's traffic file (``traffic/<mix>.json``) names its driver and holds
its parameters. The driver is ``drivers/<driver>.py``, found by name
(``spec.driver``), with

    run(cell, seed, seconds, *, trace, device, t_start, control, trail)
        -> Outcome

It draws its inputs from ``--seed`` with the helpers here, warms up its
shapes, ends set-up with ``settle``, measures for ``seconds``, and
compares a sample of the answers with the plain reference
(``reference/algorithm1.py``), each compared number held to its limit
(``limits/<workload>.json``).

Every input is drawn from the seed: the windows, vectors and rows on the
device by ``torch.Generator``\\ s, in the configuration's ``dtype``; the
arrivals on the host by numpy. The arrivals of every seed are the same
set of gaps — the quantiles of the exponential distribution at the mix's
rate — in the seed's order, so a seed changes the order of the work and
its data, never its amount.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import time
from types import SimpleNamespace
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from perfbench import spec
from perfbench import tracing as tr

__all__ = ["Outcome", "arrivals", "check_complete", "clock", "dtype_of",
           "launches", "normal", "peak", "run_cell", "settle", "substream",
           "warmup_widths"]

clock = time.perf_counter

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def substream(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of ``seed`` (any integer)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64),
                                 int.from_bytes(tag.encode(), "little")])
    return int(ss.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(substream(seed, tag))


def dtype_of(config: dict, supported: Sequence[str]) -> str:
    """The configuration's ``dtype``, which the driver must support."""
    dt = config["dtype"]
    if dt not in supported:
        raise ValueError(f"dtype {dt!r} is not one this driver runs "
                         f"({', '.join(supported)})")
    return dt


def normal(shape, device: torch.device, seed: int, tag: str,
           scale: float = 1.0, dtype: str = "float32") -> torch.Tensor:
    """N(0, scale²) draws in one call, on ``device``, in ``dtype`` (drawn
    in float32 and rounded once)."""
    g = torch.Generator(device=device)
    g.manual_seed(substream(seed, tag))
    t = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    if scale != 1.0:
        t.mul_(scale)
    return t if dtype == "float32" else t.to(DTYPES[dtype])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def settle(device: torch.device) -> None:
    """The end of set-up: the card idle, and every object that set-up made
    (the loaded program, its inputs, the schedule) frozen out of the
    collector's generations (``gc.freeze``), as a long-running server
    does once it has started. Without it the served cells' windows showed
    a few flushes a run stalled by 40–105 ms (PERF.md)."""
    sync(device)
    gc.collect()
    gc.freeze()


def arrivals(rate: float, seconds: float, seed: int,
             burst: int = 1) -> np.ndarray:
    """Due times (s) of requests offered at ``rate`` a second over
    ``seconds``, in bursts of ``burst`` requests due at one moment, the
    bursts a Poisson stream: the N = rate·seconds/burst exponential gaps at
    the midpoints of N equal bands of probability, in an order drawn from
    ``seed``."""
    burst = max(1, int(burst))
    n = max(1, int(round(rate * seconds / burst)))
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u) * burst / rate
    times = np.cumsum(rng(seed, "arrivals").permutation(gaps))
    return np.repeat(times, burst)


def warmup_widths(max_requests: int) -> tuple:
    """The microbatch widths a warm-up flushes: the powers of two under
    ``max_requests``, then ``max_requests`` twice."""
    widths = [1 << i for i in range(max(0, max_requests - 1).bit_length())
              if 1 << i < max_requests]
    return tuple(widths) + (max_requests, max_requests)


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: Dict[str, float]
    values: Dict[str, float]          # every number the run computed
    limits: Dict[str, float]          # those that decide ``correct``
    ctx: SimpleNamespace              # what the per-layer readers read
    control: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        missing = [k for k in self.limits if k not in self.values]
        if missing:
            raise KeyError(f"the run did not compute {missing}")

    @property
    def checks(self) -> Dict[str, tuple]:
        """name -> (value, limit)."""
        return {k: (float(self.values[k]), float(lim))
                for k, lim in self.limits.items()}

    @property
    def correct(self) -> bool:
        return all(math.isfinite(v) and v <= lim
                   for v, lim in self.checks.values())


def launches() -> dict:
    """The program's launch counters, by kernel family. (The modules by
    their full names: ``repro_torch.kernels`` exports functions under some
    of the same names.)"""
    cholesky, cholupdate, gram, ngd_apply, serve_solve = (
        importlib.import_module(f"repro_torch.kernels.{name}")
        for name in ("cholesky", "cholupdate", "gram", "ngd_apply",
                     "serve_solve"))
    k = serve_solve.kernels_launched()
    return {"gram": gram.ROUTES["wgmma"] + gram.ROUTES["cuda_cores"],
            "cholesky": cholesky.LAUNCHES["cholesky"],
            "trisolve": serve_solve.LAUNCHES["trisolve"]
            + serve_solve.LAUNCHES["serve_solve"],
            "ngd_apply": ngd_apply.LAUNCHES["ngd_apply"],
            "cross": k["cross_scalar"] + k["cross_vector"]
            + k["cross_tensor_cores"],
            "serve_apply": k["apply_scalar"] + k["apply_vector"],
            "cholupdate": cholupdate.LAUNCHES["cholupdate"]}


def delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


def peak(device: torch.device, chips: int = 1) -> int:
    """The peak of allocated bytes on the fullest of the cell's cards."""
    if device.type != "cuda":
        return 0
    return max(int(torch.cuda.max_memory_allocated(i)) for i in range(chips))


def run_cell(cell, seed: int, seconds: float, *, trace: bool,
             device: torch.device, t_start: float, control: bool = False,
             trail: Optional[dict] = None) -> Outcome:
    """One run of ``cell`` by its mix's driver: inputs from ``seed``,
    warm-up, the window of ``seconds``, then the comparison (with
    ``control``, also the control's and the planted faults' readings on
    the same answers). ``trail``, a dict, receives the driver's schedule
    and timings."""
    driver = spec.driver(cell.traffic["driver"], root=cell.root)
    with torch.no_grad():
        return driver(cell, seed, seconds, trace=trace, device=device,
                      t_start=t_start, control=control, trail=trail)


def check_complete(ctx) -> None:
    """Raise ``tracing.IncompleteProfile`` unless the capture holds every
    kernel that the program's counters say it launched in the window, and
    some device time."""
    data = ctx.trace
    if data is None or data.busy_s <= 0.0:
        raise tr.IncompleteProfile("the capture holds no device time")
    seen = data.counts()
    short = {k: (seen.get(k, 0), v) for k, v in ctx.launches.items()
             if seen.get(k, 0) != v}
    if short:
        raise tr.IncompleteProfile(
            "kernels in the capture against launches counted: "
            + ", ".join(f"{k} {a} of {b}" for k, (a, b) in short.items()))
