"""``SolveServer`` — request-driven damped-Fisher solves against the
resident factorization (torch port of ``repro/serve/server.py``).

The request path costs two passes over S plus n-sized triangular work —
never a Gram, never a refactorization:

* uniform-λ microbatches at the resident λ₀ with drift monitoring off
  take the fused route, ``kernels.ops.serve_solve`` (the CUDA kernel
  chain on the card, the plain version on the CPU);
* with monitoring on, or ``fused=False``, they run the compositional
  ``CholFactorization.solve`` (with the relative residual when monitored);
* mixed-λ microbatches go through ``solve_batch`` (per-column Cholesky of
  the cached W, the two S passes still coalesced).

``policy="refactorize"`` rebuilds the Gram every microbatch — the
baseline the cached path is measured against. Between microbatches the
server folds adaptation rows (``OnlineAdaptation``) and lets its
staleness policy decide on a refresh; per-request wall-clock latencies
land in ``ServerMetrics``.

With a ``TenantManager`` attached (``tenants=``), ``submit(tenant=...)``
routes the request through that tenant's rank-r delta: the batcher
coalesces per-tenant microbatches and ``_serve`` swaps the tenant's
factor L_t in for the resident L — the same S passes and the same
``serve_solve`` kernel chain (L is just an argument). A tenant request's
``rows`` fold into the *tenant's delta*, never the shared window; a
tenant-less request behaves exactly as before.

The observability hooks are the reference's (``repro_torch.obs``): a
metrics ``registry`` (latency and queue-wait histograms, stage counters,
queue and factor gauges), a span ``tracer``, ``profile`` hooks around the
solve, a ``health`` monitor and a flight ``recorder``. Every number they
take is a host number the flush already has: the solve's wait is the one
device sync a microbatch pays.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.solvers import (CholFactorization, chol_factorize,
                                      real_scalar)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.serve.adapt import OnlineAdaptation
from repro_torch.serve.batcher import Microbatch, TokenBudgetBatcher
from repro_torch.serve.state import ServeState, as_factorization, serve_mode

__all__ = ["SolveResult", "ServerMetrics", "SolveServer",
           "serve_tenant_microbatch"]


class SolveResult(NamedTuple):
    uid: int
    x: Any                     # (m,) flat or tuple of per-block pieces
    damping: float
    latency_s: float


def _to(V, device):
    if isinstance(V, (tuple, list)):
        return tuple(v.to(device) for v in V)
    return V.to(device)


def _wait(x) -> None:
    """Block until the device has produced ``x``."""
    t = x[0] if isinstance(x, (tuple, list)) else x
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


def _coalesced_solve(S, W, L, lam0: float, V, lams, *, mode: str,
                     jitter: float, uniform: bool, monitor: bool,
                     refactorize: bool, fused: bool = True):
    """One microbatch: x_j = (SᵀS + λ_j I)⁻¹ v_j. Returns (x, residual),
    the relative residual a float when monitored, else None."""
    device = S.device
    V = _to(V, device)
    if refactorize:
        fac = chol_factorize(S, lam0, mode=mode, jitter=jitter)
    else:
        if fused and uniform and not monitor and mode == "real":
            return kernel_ops.serve_solve(S, L, V, lam0), None
        fac = CholFactorization(S=S, mode=mode, W=W, L=L, lam=lam0,
                                jitter=jitter, take_real_v=False)
    if uniform:
        if monitor:
            x, stats = fac.solve(V, return_stats=True)
            return x, float(stats.residual_norm)
        return fac.solve(V), None
    # mixed per-request λ: drift monitoring needs a single λ — skip it
    return fac.solve_batch(V, lams, jitter=jitter), None


def serve_tenant_microbatch(st, tenants, mb: Microbatch, solve):
    """x of one tenant microbatch: ``solve(L_t, λ, V, dampings)`` against
    the tenant's factor at each λ of the microbatch. A λ away from λ₀
    (compared exactly, λ₀ being rounded to the window's dtype) gets its
    own L_t, and its column group is solved apart; the solve takes λ
    rounded to that dtype, as the reference's ``jnp.asarray(lam,
    lam0.dtype)``."""
    lam0 = st.lam0
    lams = sorted({r.damping for r in mb.requests})
    blocked = isinstance(mb.V, (tuple, list))

    def solve_at(lam: float, V, dampings):
        L_t = tenants.factor(st, mb.tenant,
                             lam=None if lam == lam0 else lam)
        return solve(L_t, real_scalar(lam, st.W.dtype), V, dampings)

    if len(lams) == 1:
        return solve_at(lams[0], mb.V, mb.dampings)
    # mixed λ within one tenant: L_t must be rebuilt per λ anyway, so
    # solve per-unique-λ column groups and reassemble
    cols: dict = {}
    for lam in lams:
        idx = [j for j, r in enumerate(mb.requests) if r.damping == lam]
        Vg = tuple(vb[:, idx] for vb in mb.V) if blocked else mb.V[:, idx]
        lg = torch.full((len(idx),), lam, dtype=torch.float32)
        xg = solve_at(lam, Vg, lg)
        for a, j in enumerate(idx):
            cols[j] = tuple(xb[:, a] for xb in xg) if blocked else xg[:, a]
    if blocked:
        return tuple(torch.stack([cols[j][b] for j in range(mb.k)], dim=1)
                     for b in range(len(mb.V)))
    return torch.stack([cols[j] for j in range(mb.k)], dim=1)


def _rows_k(rows) -> int:
    """Row count of one request's adaptation payload."""
    first = rows[0] if isinstance(rows, (tuple, list)) else rows
    return int(first.shape[0])


class ServerMetrics:
    """Per-request wall-clock accounting over a ring of the ``window`` most
    recent requests; totals keep counting past the ring. With a
    ``registry`` every record also lands in ``<prefix>.requests`` /
    ``<prefix>.tokens`` counters and ``<prefix>.request_latency_s`` /
    ``<prefix>.queue_wait_s`` histograms."""

    def __init__(self, *, window: int = 4096, registry=None,
                 prefix: str = "serve"):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = int(window)
        self.registry = registry
        self.prefix = prefix
        self.reset()

    def reset(self) -> None:
        self._ring: deque = deque(maxlen=self.window)
        self._count = 0
        self._tokens = 0
        self._t0: Optional[float] = None
        self._t1: Optional[float] = None

    def record(self, t_submit: float, t_done: float, tokens: int,
               queue_s: Optional[float] = None) -> None:
        self._ring.append((t_submit, t_done, tokens))
        self._count += 1
        self._tokens += tokens
        self._t0 = t_submit if self._t0 is None else min(self._t0, t_submit)
        self._t1 = t_done if self._t1 is None else max(self._t1, t_done)
        reg = self.registry
        if reg is not None:
            p = self.prefix
            reg.counter(f"{p}.requests").inc()
            reg.counter(f"{p}.tokens").inc(int(tokens))
            reg.histogram(f"{p}.request_latency_s").observe(t_done - t_submit)
            if queue_s is not None:
                reg.histogram(f"{p}.queue_wait_s").observe(max(queue_s, 0.0))

    @property
    def served(self) -> int:
        return self._count

    def latencies_s(self) -> np.ndarray:
        return np.asarray([d - s for s, d, _ in self._ring], np.float64)

    def summary(self) -> dict:
        """p50/p99 latency over the ring, requests/sec and tokens/sec over
        the full recorded span (first submit → last completion)."""
        if not self._count:
            return {"served": 0, "p50_ms": None, "p99_ms": None,
                    "rps": None, "tokens_per_s": None}
        lat = self.latencies_s()
        span = max(self._t1 - self._t0, 1e-12)
        return {"served": self._count,
                "p50_ms": float(np.percentile(lat, 50) * 1e3),
                "p99_ms": float(np.percentile(lat, 99) * 1e3),
                "rps": self._count / span,
                "tokens_per_s": self._tokens / span}


class SolveServer:
    """The serving front end: submit → coalesce → solve → adapt.

    Args:
      state: resident ``ServeState`` (see ``init_serve_state``).
      batcher: request coalescing policy (default token-budget FIFO).
      adaptation: optional ``OnlineAdaptation`` — requests carrying score
        rows then fine-tune the window after their solve.
      policy: "cached" (resident factor) or "refactorize" (fresh Gram per
        microbatch — the benchmark baseline).
      monitor_drift: compute the relative residual on uniform-λ
        microbatches (feeds the drift-refresh threshold).
      jitter: extra diagonal, as elsewhere.
      fused: route cached uniform-λ microbatches (monitoring off) through
        ``kernels.ops.serve_solve``; False forces the compositional solve.
      tenants: optional ``TenantManager`` — enables ``submit(tenant=)``.
      registry: optional ``repro_torch.obs.MetricsRegistry`` — request
        histograms and counters, queue and factor gauges; propagated to
        the adaptation when it has none.
      tracer: optional ``repro_torch.obs.Tracer`` — queue, solve, fold and
        refresh spans, trace ids riding ``submit(trace=)``.
      profile: optional ``repro_torch.obs.ProfileHooks`` — a labelled
        range around each coalesced solve.
      health: optional ``repro_torch.obs.HealthMonitor`` — propagated to
        the adaptation and evaluated once per flush.
      recorder: optional ``repro_torch.obs.FlightRecorder`` — a digest per
        request and one ``observe`` of the state per flush.
    """

    def __init__(self, state: ServeState, *,
                 batcher: Optional[TokenBudgetBatcher] = None,
                 adaptation: Optional[OnlineAdaptation] = None,
                 policy: str = "cached", monitor_drift: bool = True,
                 jitter: float = 0.0, fused: bool = True,
                 tenants=None, clock=time.perf_counter, registry=None,
                 tracer=None, profile=None, health=None, recorder=None,
                 metrics_window: int = 4096):
        if policy not in ("cached", "refactorize"):
            raise ValueError(f"policy must be 'cached' or 'refactorize', "
                             f"got {policy!r}")
        self.state = state
        self.batcher = batcher if batcher is not None else TokenBudgetBatcher()
        self.adaptation = adaptation
        self.policy = policy
        self.monitor_drift = bool(monitor_drift)
        self.jitter = float(jitter)
        self.fused = bool(fused)
        self.tenants = tenants
        self.clock = clock
        self.registry = registry
        self.tracer = tracer
        self.profile = profile
        self.health = health
        self.recorder = recorder
        self.metrics = ServerMetrics(window=metrics_window,
                                     registry=registry, prefix="serve")
        if registry is not None and tenants is not None \
                and tenants.registry is None:
            tenants.registry = registry
        if adaptation is not None:
            if registry is not None and adaptation.registry is None:
                adaptation.registry = registry
            if health is not None and adaptation.health is None:
                adaptation.health = health

    def submit(self, v, *, damping: Optional[float] = None, tokens: int = 1,
               rows=None, payload=None, tenant: Optional[str] = None,
               trace: Optional[str] = None) -> int:
        """Enqueue one request; returns its uid. ``damping=None`` means the
        resident λ₀ (the fast path). ``tenant`` solves against (and folds
        ``rows`` into) that tenant's delta — needs ``tenants=``.
        ``trace`` tags the request's spans."""
        if tenant is not None and self.tenants is None:
            raise RuntimeError("tenant= requires a TenantManager "
                               "(SolveServer(tenants=...))")
        lam = self.state.lam0 if damping is None else float(damping)
        req = self.batcher.submit(v, damping=lam, tokens=tokens, rows=rows,
                                  payload=payload, tenant=tenant, trace=trace)
        req.t_submit = self.clock()
        if self.registry is not None:
            qs = self.batcher.queue_stats(req.t_submit)
            self.registry.gauge("serve.queue_depth").set(qs["depth"])
            self.registry.gauge("serve.queue_oldest_age_s").set(
                qs["oldest_age_s"])
        return req.uid

    def solve_one(self, v, *, damping: Optional[float] = None,
                  tokens: int = 1, rows=None, tenant: Optional[str] = None):
        """Submit + flush a single request and return its x. Only valid on
        an empty queue (a flush would also solve pending requests whose
        results this method cannot hand back)."""
        if len(self.batcher):
            raise RuntimeError(
                f"solve_one with {len(self.batcher)} request(s) pending "
                "would drop their results; use submit() + flush()")
        uid = self.submit(v, damping=damping, tokens=tokens, rows=rows,
                          tenant=tenant)
        (res,) = [r for r in self.flush() if r.uid == uid]
        return res.x

    def flush(self, *, damping_state=None) -> List[SolveResult]:
        """Drain the batcher: solve every pending microbatch, fold each
        request's adaptation rows, and let the staleness policy decide on
        a refresh between microbatches. Returns results FIFO."""
        out: List[SolveResult] = []
        for mb in self.batcher.drain():
            out.extend(self._serve(mb))
            for req in mb.requests:
                if req.rows is None:
                    continue
                if mb.tenant is not None:
                    # tenant-private fine-tuning: fold into the delta,
                    # never the shared window
                    self.tenants.fold(self.state, mb.tenant, req.rows)
                elif self.adaptation is not None:
                    span = self.tracer.span("fold", cat="adapt",
                                            trace=req.trace) \
                        if self.tracer is not None \
                        else contextlib.nullcontext()
                    with span:
                        self.state = self.adaptation.fold(self.state,
                                                          req.rows)
            if self.adaptation is not None:
                self.state, refreshed = self.adaptation.maybe_refresh(
                    self.state, damping_state=damping_state)
                if refreshed and self.tracer is not None:
                    self.tracer.add("refresh", cat="adapt",
                                    ts_us=time.time() * 1e6, dur_us=0.0)
            if self.registry is not None:
                self._health_gauges()
        if self.health is not None:
            self.health.evaluate()
        if self.recorder is not None:
            self.recorder.observe(self.state, adaptation=self.adaptation,
                                  health=self.health, registry=self.registry,
                                  tracer=self.tracer)
        return out

    def _health_gauges(self) -> None:
        """Factor gauges: host numbers of the state, no device read."""
        reg = self.registry
        reg.gauge("curvature.factor_age").set(self.state.age)
        reg.gauge("curvature.last_drift_residual").set(
            self.state.stats.last_residual)

    def _serve_tenant(self, mb: Microbatch):
        """Solve one tenant microbatch: the same coalesced solve with the
        tenant's factor L_t swapped in for the resident L (the S passes —
        and on the card the ``serve_solve`` kernels — only ever see the
        shared window). Drift monitoring is skipped: the residual check is
        defined against the base system, not the tenant's reweighted one."""
        st = self.state

        def solve(L_t, lam: float, V, dampings):
            x, _ = _coalesced_solve(
                st.S, st.W, L_t, lam, V, dampings, mode=serve_mode(st),
                jitter=self.jitter, uniform=True, monitor=False,
                refactorize=False, fused=self.fused)
            return x

        return serve_tenant_microbatch(st, self.tenants, mb, solve)

    def _serve(self, mb: Microbatch) -> List[SolveResult]:
        st = self.state
        t_start = self.clock()
        step = self.profile.step(step=self.metrics.served) \
            if self.profile is not None else contextlib.nullcontext()
        with step:
            if mb.tenant is not None:
                x, resid = self._serve_tenant(mb), None
            else:
                uniform = all(r.damping == st.lam0 for r in mb.requests)
                x, resid = _coalesced_solve(
                    st.S, st.W, st.L, st.lam0, mb.V, mb.dampings,
                    mode=serve_mode(st), jitter=self.jitter,
                    uniform=uniform,
                    monitor=self.monitor_drift and self.policy == "cached",
                    refactorize=self.policy == "refactorize",
                    fused=self.fused)
            _wait(x)
        t_done = self.clock()

        stats = st.stats._replace(
            served=st.stats.served + mb.k,
            microbatches=st.stats.microbatches + 1,
            last_residual=st.stats.last_residual if resid is None else resid)
        self.state = st._replace(age=st.age + 1, stats=stats)

        if self.registry is not None:
            self.registry.counter("serve.microbatches").inc()
            self.registry.histogram("serve.solve_latency_s").observe(
                t_done - t_start)
        if self.tracer is not None:
            # one epoch anchor a microbatch: spans land on the time.time()
            # timeline, durations stay on the clock that stamped t_submit
            epoch_done_us = time.time() * 1e6
            solve_us = (t_done - t_start) * 1e6
            self.tracer.add(
                "device_solve", cat="solve", ts_us=epoch_done_us - solve_us,
                dur_us=solve_us,
                args={"k": mb.k, "uids": [r.uid for r in mb.requests],
                      "tenant": mb.tenant})

        results = []
        for j, req in enumerate(mb.requests):
            xj = tuple(xb[:, j] for xb in x) if isinstance(x, (tuple, list)) \
                else x[:, j]
            queue_s = max(t_start - req.t_submit, 0.0) \
                if req.t_submit > 0.0 else None
            self.metrics.record(req.t_submit, t_done, req.tokens,
                                queue_s=queue_s)
            if self.recorder is not None:
                self.recorder.record_request(
                    req.uid, tenant=mb.tenant, damping=req.damping,
                    tokens=req.tokens,
                    k_rows=0 if req.rows is None else _rows_k(req.rows),
                    latency_s=t_done - req.t_submit, residual=resid)
            if self.tracer is not None and queue_s is not None:
                e2e_us = (t_done - req.t_submit) * 1e6
                self.tracer.add(
                    "queue_wait", cat="queue", ts_us=epoch_done_us - e2e_us,
                    dur_us=queue_s * 1e6, trace=req.trace,
                    args={"uid": req.uid})
                self.tracer.add(
                    "request", cat="serve", ts_us=epoch_done_us - e2e_us,
                    dur_us=e2e_us, trace=req.trace, args={"uid": req.uid})
            results.append(SolveResult(uid=req.uid, x=xj, damping=req.damping,
                                       latency_s=t_done - req.t_submit))
        return results

    def apply_fold(self, rows, *, slots=None, record: bool = True) -> None:
        """Apply one fold to the resident window outside the request path
        (the replay entry point); ``slots`` are verified against the local
        FIFO cursor."""
        if self.adaptation is None:
            raise RuntimeError("apply_fold needs an OnlineAdaptation")
        self.state = self.adaptation.fold(self.state, rows, slots=slots,
                                          record=record)

    def refresh(self) -> None:
        """Force a full refactorization now (not on the request path)."""
        if self.adaptation is not None:
            self.state, _ = self.adaptation.maybe_refresh(self.state,
                                                          force=True)
        else:
            fac = chol_factorize(self.state.S, self.state.lam0,
                                 mode=serve_mode(self.state),
                                 jitter=self.jitter)
            self.state = self.state._replace(
                W=fac.W, L=fac.L, age=0,
                stats=self.state.stats._replace(
                    refreshes=self.state.stats.refreshes + 1))

    @property
    def factorization(self) -> CholFactorization:
        """The resident factorization, as a first-class solver object."""
        return as_factorization(self.state, jitter=self.jitter)

    @property
    def stats(self):
        return self.state.stats
