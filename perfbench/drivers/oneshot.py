"""``oneshot``: Algorithm 1 as a trainer calls it.

``ops.chol_solve_fused(S, v, λ)`` on a window of a device pool of at least
``pool_min`` windows and ``pool_bytes`` bytes, a right-hand side from a
pool of ``v_pool`` vectors each solve, dispatched ahead with at most
``in_flight`` solves unfinished and no read of a result. The window
closes at a sync and counts the solves dispatched in it, all finished by
then. Every ``check_every``-th solve (from an offset drawn from the seed)
is kept and compared with the float64 reference.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from perfbench import harness as hn
from perfbench import tracing as tr
from perfbench.reference import algorithm1 as ref

DTYPES = ("float32", "bfloat16")


def run(cell, seed, seconds, *, trace, device, t_start, control=False,
        trail=None):
    from repro_torch.kernels import ops

    cfg, tf = cell.config, cell.traffic
    n, m, lam = int(cfg["n"]), int(cfg["m"]), float(cfg["damping"])
    dt = hn.dtype_of(cfg, DTYPES)
    win_bytes = n * m * torch.finfo(hn.DTYPES[dt]).bits // 8
    pool = max(int(tf["pool_min"]), -(-int(tf["pool_bytes"]) // win_bytes))
    vp = int(tf["v_pool"])
    S = hn.normal((pool, n, m), device, seed, "windows", 1.0 / math.sqrt(m),
                  dt)
    V = hn.normal((vp, m), device, seed, "rhs")
    depth = int(tf["in_flight"])
    every = int(tf["check_every"])
    offset = int(hn.rng(seed, "check").integers(every))

    # warm-up: the one shape this cell solves
    for i in range(2):
        ops.chol_solve_fused(S[i % pool], V[i % vp], lam)
    hn.sync(device)

    cap = tr.Capture(device) if trace else None
    layers = tr.Layers(cap)
    for name in ("gram_sv", "cholesky", "trisolve", "ngd_apply"):
        layers.wrap(ops, name, f"pb.{name}")
    before = hn.launches()
    kept: Dict[int, torch.Tensor] = {}
    events: List[Optional[torch.cuda.Event]] = [None] * depth
    hn.settle(device)
    if cap is not None:
        cap.__enter__()
    try:
        hn.sync(device)
        t0 = hn.clock()
        setup_s = t0 - t_start
        i = 0
        with tr.label(cap, tr.WINDOW):
            while hn.clock() - t0 < seconds:
                slot = i % depth
                if events[slot] is not None:
                    with tr.label(cap, "pb.wait"):
                        events[slot].synchronize()
                x = ops.chol_solve_fused(S[i % pool], V[i % vp], lam)
                if i % every == offset:
                    kept[i] = x
                if device.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record()
                    events[slot] = ev
                i += 1
            hn.sync(device)
        t1 = hn.clock()
    finally:
        if cap is not None:
            cap.__exit__(None, None, None)
        layers.restore()
    after = hn.launches()
    solves = i
    window_s = t1 - t0
    memory_peak = hn.peak(device, cell.chips)
    if trail is not None:
        trail.update(solves=solves, window_s=window_s, t0=t0)

    # the comparison: each kept x against the float64 reference
    del events
    by_window: Dict[int, List[int]] = {}
    for j in kept:
        by_window.setdefault(j % pool, []).append(j)
    errs, ctl = [], []
    for p, idx in sorted(by_window.items()):
        Vc = torch.stack([V[j % vp] for j in idx], dim=1)
        X64 = ref.factor(S[p], lam, "float64").solve(Vc)
        errs += [ref.rel_err(kept[j], X64[:, a]) for a, j in enumerate(idx)]
        if control:
            Xc = ref.factor(S[p], lam, ref.CONTROL[dt]).solve(Vc)
            ctl += [ref.rel_err(Xc[:, a], X64[:, a]) for a in range(len(idx))]
    values = {"x_err": max(errs) if errs else float("inf")}
    lim = cell.limits.get("x_err", math.inf)
    failed = sum(e > lim for e in errs) + (not errs)
    ctx = SimpleNamespace(
        config=cfg, traffic=tf, solves=solves, window_s=window_s,
        layers=layers.calls, launches=hn.delta(before, after),
        memory_peak=memory_peak, checked=len(errs),
        trace=cap.data() if cap is not None else None)
    ctl = {"x_err": max(ctl), "checked": len(ctl)} if control else {}
    return hn.Outcome(attempted=solves, failed=failed,
                      e2e={"solve_ms": 1e3 * window_s / max(solves, 1),
                           "setup_s": setup_s},
                      values=values, limits=cell.limits, ctx=ctx,
                      control=ctl)
