"""``serve``: resident-factor serving under an open loop.

``SolveServer`` over a frozen window (``rows_per_request`` 0) or one that
each request's score rows slide FIFO (``OnlineAdaptation`` with the mix's
``adaptation`` settings), microbatches of at most ``max_requests``.
Requests are offered at ``rate_per_s``, in Poisson bursts of ``burst``
(default 1); each carries one right-hand side at the resident damping
from a pool of ``v_pool`` vectors. The loop submits whatever is due, then
calls ``flush()``; each request is timed from its due time to the return
of the flush that answered it. ``check_requests`` answers, drawn from the
seed, are compared with the float64 reference, each against the window
its microbatch saw; with rows, also the resident window, Gram and factor
at the window's end, against the replayed FIFO.
"""
from __future__ import annotations

import math
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from perfbench import harness as hn
from perfbench import tracing as tr
from perfbench.reference import algorithm1 as ref

DTYPES = ("float32", "bfloat16")
# the answers a witness of the factor's drift sorts by the microbatches
# their factor had folded since its last refresh
YOUNG, OLD = 8, 48


def run(cell, seed, seconds, *, trace, device, t_start, control=False,
        trail=None):
    from repro_torch.kernels import ops
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve import (OnlineAdaptation, SolveServer,
                                   TokenBudgetBatcher, init_serve_state)

    cfg, tf = cell.config, cell.traffic
    n, m, lam = int(cfg["n"]), int(cfg["m"]), float(cfg["damping"])
    dt = hn.dtype_of(cfg, DTYPES)
    rate = float(tf["rate_per_s"])
    k_rows = int(tf.get("rows_per_request", 0))
    max_req = int(tf["max_requests"])
    due = hn.arrivals(rate, seconds, seed, int(tf.get("burst", 1)))
    N = len(due)
    # warm-up flushes: every microbatch width the batcher forms, then one
    # queue as long as the load's longest, so that the allocator holds
    # what a long flush needs before the window
    warm_queues = hn.warmup_widths(max_req) + (int(tf.get("warm_queue", 0)),)
    warm = sum(warm_queues)
    G = warm + N                                   # requests in all
    rng = hn.rng(seed, "requests")
    vp = int(tf["v_pool"])
    vidx = np.concatenate([np.arange(warm) % vp, rng.integers(0, vp, N)])
    K = min(int(tf["check_requests"]), N)
    check = set((warm + rng.choice(N, size=K, replace=False)).tolist())

    S0 = hn.normal((n, m), device, seed, "window", 1.0 / math.sqrt(m), dt)
    V = hn.normal((vp, m), device, seed, "rhs")
    rows = hn.normal((G, k_rows, m), device, seed, "rows",
                     1.0 / math.sqrt(m), dt) if k_rows else None

    # traced runs: the server's own spans, for its microbatch solve times
    tracer = Tracer(max_events=1 << 22) if trace else None
    adapt = OnlineAdaptation(**tf["adaptation"]) if k_rows else None
    # a sliding window is the program's to change: it gets its own copy
    server = SolveServer(init_serve_state(S0.clone() if k_rows else S0, lam),
                         batcher=TokenBudgetBatcher(max_requests=max_req),
                         adaptation=adapt, monitor_drift=False, fused=True,
                         tracer=tracer)

    flushes: List[List[int]] = []
    uid_of: Dict[int, int] = {}
    kept: Dict[int, torch.Tensor] = {}

    def submit(g):
        uid = server.submit(V[vidx[g]],
                            rows=None if rows is None else rows[g])
        uid_of[uid] = g

    def flush(queue):
        results = server.flush()
        flushes.append(queue)
        for r in results:
            g = uid_of.pop(r.uid)
            if g in check:
                kept[g] = r.x.clone()
        return len(results)

    g = 0
    for w in warm_queues:
        queue = list(range(g, g + w))
        for q in queue:
            submit(q)
        flush(queue)
        g += w
    if adapt is not None:
        server.refresh()
    hn.sync(device)
    spans0 = len(tracer.events()) if tracer is not None else 0

    cap = tr.Capture(device) if trace else None
    layers = tr.Layers(cap)
    layers.wrap(ops, "serve_solve", "pb.serve_solve",
                shape=lambda S, L, V, lam, **kw: (int(V.shape[-1]),))
    if adapt is not None:
        layers.wrap(adapt, "fold", "pb.fold")
        layers.wrap(adapt, "maybe_refresh", "pb.maintain")
    ages: List[int] = []
    aging = control and adapt is not None
    if aging:
        # the witness of the factor's drift: each microbatch's age (the
        # microbatches since the factor's refresh, this one included)
        maintain = adapt.maybe_refresh

        def aged(state, **kw):
            ages.append(int(state.age))
            return maintain(state, **kw)
        adapt.maybe_refresh = aged
    st0 = server.stats
    before = hn.launches()
    sub_t = np.full(N, np.nan)
    done_t = np.full(N, np.nan)
    backlog, flush_log = [], []
    hn.settle(device)
    if cap is not None:
        cap.__enter__()
    try:
        hn.sync(device)
        t0 = hn.clock()
        setup_s = t0 - t_start
        i, answered = 0, 0
        with tr.label(cap, tr.WINDOW):
            while answered < N:
                now = hn.clock() - t0
                if due[i] > now:            # nothing due, nothing pending
                    with tr.label(cap, "pb.idle"):
                        if due[i] - now > 2e-3:
                            time.sleep(due[i] - now - 1e-3)
                        while hn.clock() - t0 < due[i]:
                            pass
                    continue
                queue = []
                with tr.label(cap, "pb.submit"):
                    while i < N and due[i] <= hn.clock() - t0:
                        submit(warm + i)
                        sub_t[i] = hn.clock() - t0
                        queue.append(warm + i)
                        i += 1
                backlog.append((hn.clock() - t0,
                                int(np.searchsorted(due, hn.clock() - t0,
                                                    side="right"))
                                - answered))
                t_flush = hn.clock() - t0
                with tr.label(cap, "pb.flush"):
                    got = flush(queue)
                t_done = hn.clock() - t0
                flush_log.append((t_flush, t_done, got))
                done_t[answered:answered + got] = t_done
                answered += got
            hn.sync(device)
        t1 = hn.clock()
    finally:
        if cap is not None:
            cap.__exit__(None, None, None)
        layers.restore()
        if aging:
            vars(adapt).pop("maybe_refresh", None)
    after = hn.launches()
    st1 = server.stats
    window_s = t1 - t0
    memory_peak = hn.peak(device, cell.chips)
    solve_ms = [ev["dur"] / 1e3 for ev in tracer.events()[spans0:]
                if ev["name"] == "device_solve"] if tracer is not None else []
    state = server.state
    S_end, W_end, L_end = state.S, state.W, state.L
    age_end = int(state.age)
    L_fresh = None
    if control and adapt is not None:
        # a second witness: the program's own refactorization of the
        # window it ends with
        server.refresh()
        L_fresh = server.state.L
    del server, state
    if trail is not None:
        trail.update(due=due, done=done_t, sub=sub_t, backlog=backlog,
                     flushes=flush_log, window_s=window_s, t0=t0)

    lat = (done_t - due) * 1e3
    lag = (sub_t - due) * 1e3
    unanswered = int(np.isnan(lat).sum())
    values, ctl = {"unanswered": unanswered}, {}
    errs, cerrs = _errors(S0, V, vidx, rows, kept, flushes, max_req, lam,
                          ref.CONTROL[dt] if control else None)
    for out, e in ((values, errs), (ctl, cerrs)):
        if not e and out is ctl:
            continue
        for key in ("x_err", "x_perp_err"):
            out[key] = max((a[key] for a in e.values()), default=math.inf)
        out["x_err_median"] = float(np.median(
            [a["x_err"] for a in e.values()])) if e else math.inf
    if control:
        ctl["checked"] = len(cerrs)
    if rows is not None:
        S_exp = ref.fifo_window(S0, rows, G)
        values["window_diff"] = float((S_end - S_exp).abs().max())
        f64 = ref.factor(S_exp, lam, "float64")
        values["gram_err"] = ref.rel_err(W_end, f64.W)
        values["factor_err"] = ref.rel_err(L_end, f64.L)
        values["factor_resid"] = ref.factor_resid(L_end, f64.W, lam)
        values["age_at_end"] = age_end
        if control:
            fc = ref.factor(S_exp, lam, ref.CONTROL[dt])
            ctl["gram_err"] = ref.rel_err(fc.W, f64.W)
            ctl["factor_err"] = ref.rel_err(fc.L, f64.L)
            ctl["factor_resid"] = ref.factor_resid(fc.L, f64.W, lam)
            # the planted fault: a factor one request's fold behind
            stale = ref.factor(ref.fifo_window(S0, rows, G - 1), lam)
            ctl["fault.stale_fold.factor_resid"] = ref.factor_resid(
                stale.L, f64.W, lam)
            ctl["witness.refreshed.factor_resid"] = ref.factor_resid(
                L_fresh, f64.W, lam)
            ctl.update(_by_age(errs, flushes[len(warm_queues):], max_req,
                               ages))
    lim = cell.limits
    per_answer = [k for k in ("x_err", "x_perp_err") if k in lim]
    failed = unanswered + sum(any(e[k] > lim[k] for k in per_answer)
                              for e in errs.values())
    ok = ~np.isnan(lat)
    ctx = SimpleNamespace(
        config=cfg, traffic=tf, window_s=window_s, requests=N,
        served=st1.served - st0.served,
        microbatches=st1.microbatches - st0.microbatches,
        folds=(st1.adapted - st0.adapted) // max(k_rows, 1),
        refreshes=st1.refreshes - st0.refreshes, lag_ms=lag[ok],
        solve_spans_ms=solve_ms, layers=layers.calls,
        launches=hn.delta(before, after), memory_peak=memory_peak,
        checked=len(errs), trace=cap.data() if cap is not None else None)
    e2e = {"request_p50_ms": float(np.percentile(lat[ok], 50)),
           "request_p95_ms": float(np.percentile(lat[ok], 95)),
           "setup_s": setup_s}
    return hn.Outcome(attempted=N, failed=failed, e2e=e2e, values=values,
                      limits=lim, ctx=ctx, control=ctl)


def _errors(S0, V, vidx, rows, kept, flushes, max_req, lam, control):
    """{request: {"x_err", "x_perp_err"}} of each kept answer against the
    float64 reference, and, with ``control`` (a precision), the control's
    on the same requests. Each answer is solved against the window its
    microbatch saw: the initial window with the rows of every earlier
    request folded in. ``x_perp_err`` is the error of the part of x outside
    the window's row space, which the apply pass alone produces."""
    first = ref.microbatch_starts(flushes, max_req)
    groups: Dict[int, List[int]] = {}
    for g in kept:
        groups.setdefault(first[g] if rows is not None else 0, []).append(g)
    errs, cerrs = {}, {}

    def measure(X, f64, X64, gs, out):
        perp64 = f64.perp(X64)
        perp = f64.perp(X - X64)
        for a, g in enumerate(gs):
            out[g] = {"x_err": ref.rel_err(X[:, a], X64[:, a]),
                      "x_perp_err": float(perp[:, a].norm()
                                          / perp64[:, a].norm())}

    for f, gs in sorted(groups.items()):
        Sf = S0 if rows is None else ref.fifo_window(S0, rows, f)
        Vc = torch.stack([V[vidx[g]] for g in gs], dim=1)
        f64 = ref.factor(Sf, lam, "float64")
        X64 = f64.solve(Vc)
        X = torch.stack([kept[g] for g in gs], dim=1).to(torch.float64)
        measure(X, f64, X64, gs, errs)
        if control:
            Xc = ref.factor(Sf, lam, control).solve(Vc).to(torch.float64)
            measure(Xc, f64, X64, gs, cerrs)
        del Sf, f64, X64
    return errs, cerrs


def _by_age(errs, flushes, max_req, ages) -> dict:
    """The witness of the factor's drift: the worst ``x_err`` of the
    answers whose factor had folded under ``YOUNG`` microbatches since its
    refresh, and of those that had folded ``OLD`` or more."""
    age_of, j = {}, 0
    for queue in flushes:
        for a in range(0, len(queue), max_req):
            for g in queue[a:a + max_req]:
                age_of[g] = ages[j] - 1 if j < len(ages) else None
            j += 1
    young = [e["x_err"] for g, e in errs.items()
             if age_of.get(g) is not None and age_of[g] < YOUNG]
    old = [e["x_err"] for g, e in errs.items()
           if age_of.get(g) is not None and age_of[g] >= OLD]
    return {"witness.young.x_err": max(young, default=math.nan),
            "witness.young.n": len(young),
            "witness.old.x_err": max(old, default=math.nan),
            "witness.old.n": len(old)}
