"""``AsyncSolveServer`` — concurrent serving against the (optionally
sharded) window (torch port of ``repro/dist/server.py``).

Two things change relative to the eager ``repro_torch.serve.SolveServer``;
the math does not:

* **Concurrency** — any number of threads submit; one worker thread owns
  every device dispatch. A closed microbatch is dispatched while the next
  one fills, and the device syncs only at the response boundary. With no
  adaptation the worker keeps one microbatch in flight (dispatch i + 1
  before it waits on i); with adaptation the eager solve → fold → refresh
  order holds.
* **Sharding** — with a ``ShardedServeState`` a microbatch runs per slab
  (``make_sharded_coalesced_solve``): the two O(n·m·k) window passes are
  ``ops.sv_cross`` and ``ops.serve_apply`` on every slab with one sum
  between them, the substitution ``ops.trisolve`` on the replicated
  factor. With a plain ``ServeState`` the worker calls the eager server's
  own ``_coalesced_solve``, so replicated responses equal the eager
  server's bit for bit.

**Responses do not depend on timing.** The reference's worker closes a
microbatch whenever it finds the batcher non-empty, so where a microbatch
ends, and whether a request is solved before or after a fold it precedes,
depends on thread timing. Here every call — ``submit``, ``apply_fold``,
``flush``, ``result``, ``shutdown`` — takes its place from one counter
under the lock, and the worker closes a microbatch only when

* the batcher's budget closes it (``max_requests`` or ``max_tokens``:
  no later request can join it), or
* a later call closes it: an ``apply_fold`` (which applies at its own
  place, after every request submitted before it), a ``flush``, a
  ``result()`` waiting on one of its requests, or ``shutdown``.

A request never joins a microbatch past such a call, and a refresh judges
against the damping state pinned at the call that closed its microbatch.
So a response depends only on the order of the calls: with one
submitting thread and ``flush`` at the end, the microbatches are the
eager server's. Request-carried rows fold after their microbatch's
solve, as in the eager server.

``flush()`` keeps the eager API: it blocks until every request and fold
submitted before it is done and returns those requests' results that no
``result()`` caller claimed, FIFO.

Tenants compose with every layout: a tenant microbatch swaps the
tenant's factor L_t in for the resident L, which is the replicated
argument of both solve paths.
"""
from __future__ import annotations

import contextlib
import contextvars
import copy
import math
import threading
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Set

import torch

from repro_torch.core.solvers import cholesky, real_scalar
from repro_torch.dist.cholupdate import ShardedRefresh
from repro_torch.dist.state import (DistSpec, ShardedServeState,
                                    ShardedWindow, is_sharded, shard_window,
                                    split_columns)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import all_gather, psum
from repro_torch.serve.adapt import pad_to_window_cols
from repro_torch.serve.batcher import Microbatch, TokenBudgetBatcher
from repro_torch.serve.server import (ServerMetrics, SolveResult,
                                      _coalesced_solve, _rows_k, _wait,
                                      serve_tenant_microbatch)
from repro_torch.serve.state import ServeState, as_factorization, serve_mode

__all__ = ["AsyncSolveServer", "make_sharded_coalesced_solve"]


# ---------------------------------------------------------------------------
# the sharded coalesced solve (the per-slab twin of server._coalesced_solve)
# ---------------------------------------------------------------------------

class ShardedSolve:
    """``(S, W, L, lam0, V, lams) -> (x, resid)`` of one microbatch on a
    ``ShardedWindow`` (``make_sharded_coalesced_solve``). ``V`` (m, k), or
    per-block (m_b, k), at the window's padded widths; x comes back in the
    same form, whole, on the first position's device. ``resid``: the
    monitored relative residual (a float) or None."""

    def __init__(self, spec: DistSpec, *, mode: str, jitter: float,
                 uniform: bool, monitor: bool, refactorize: bool):
        self.spec = spec
        self.mode = mode
        self.jitter = float(jitter)
        self.uniform = bool(uniform)
        self.monitor = bool(monitor)
        self.refactorize = bool(refactorize)

    def _cross(self, window: ShardedWindow, V_pieces) -> torch.Tensor:
        """U = S·V (n, k): per data row the sum over slabs of each piece's
        ``sv_cross``, the rows gathered on the first position."""
        rows = []
        for i in range(len(window.pieces[0])):
            parts = []
            for j in range(self.spec.m_mult):
                acc = None
                for b, blk in enumerate(window.pieces):
                    p = blk[i][j]
                    u = ops.sv_cross(p, V_pieces[b][j].to(p.device))
                    acc = u if acc is None else acc + u
                parts.append(acc)
            rows.append(psum(parts))
        return all_gather(rows, dim=0, device=self.spec.home)

    def _apply(self, window: ShardedWindow, w, V_pieces, lam: float):
        """x_bj = (V_bj − S_bjᵀw)/λ per slab: one ``serve_apply`` per piece,
        a slab's data pieces chained (all but the last at λ = 1, so the
        sum over the pieces lands before the one division)."""
        offs = window.row_offsets()
        out = []
        for b, blk in enumerate(window.pieces):
            slabs = []
            for j in range(self.spec.m_mult):
                t = V_pieces[b][j]
                last = len(blk) - 1
                for i, row in enumerate(blk):
                    p = row[j]
                    wi = w[offs[i]:offs[i] + p.shape[0]].to(p.device)
                    t = ops.serve_apply(p, wi, t.to(p.device),
                                        lam if i == last else 1.0)
                slabs.append(t)
            out.append(slabs)
        return out

    def __call__(self, S, W, L, lam0, V, lams):
        spec = self.spec
        window = S if is_sharded(S) else shard_window(S, spec)
        blocked = isinstance(V, (tuple, list))
        V_pieces = [[p.to(torch.promote_types(p.dtype, torch.float32))
                     .contiguous() for p in blk]
                    for blk in split_columns(
                        window, tuple(V) if blocked else (V,), axis=0)]
        lam0 = float(lam0)
        if self.refactorize:
            W, L = ShardedRefresh(spec, mode=self.mode,
                                  jitter=self.jitter)(window, lam0)
        u = self._cross(window, V_pieces)
        resid = None
        if self.uniform:
            w = ops.trisolve(L, u)
            x_pieces = self._apply(window, w, V_pieces, lam0)
            if self.monitor:
                resid = self._residual(window, x_pieces, V_pieces, lam0)
        else:
            # mixed per-request λ: batched Choleskys of the cached W, the
            # two S passes still one each for the whole microbatch
            lams = torch.as_tensor(lams, dtype=W.real.dtype).reshape(-1)
            lams = lams.to(W.device)
            eye = torch.eye(W.shape[0], dtype=W.dtype, device=W.device)
            Ls = cholesky(W[None] + (lams + real_scalar(
                self.jitter, W.real.dtype))[:, None, None] * eye)
            wk = torch.linalg.solve_triangular(Ls, u.mT[..., None],
                                               upper=False)
            wk = torch.linalg.solve_triangular(
                Ls.mH if self.mode == "complex" else Ls.mT, wk, upper=True)
            w = wk[..., 0].mT.contiguous()
            x_pieces = [[x / lams.to(x.device)[None, :] for x in blk]
                        for blk in self._apply(window, w, V_pieces, 1.0)]
        x = tuple(all_gather(blk, dim=0, device=spec.home)
                  for blk in x_pieces)
        return (x if blocked else x[0]), resid

    def _residual(self, window, x_pieces, V_pieces, lam: float) -> float:
        """‖(SᵀS + λI)x − v‖ / ‖v‖ over the microbatch, per slab: Sx by
        the cross pass, then SᵀSx + λx − v by the apply chain at λ = 1."""
        Sx = self._cross(window, x_pieces)
        r_pieces = self._apply(
            window, Sx, [[v - lam * x for v, x in zip(vb, xb)]
                         for vb, xb in zip(V_pieces, x_pieces)], 1.0)
        home = self.spec.home
        r2 = psum([(r.abs() ** 2).sum().to(home)
                   for blk in r_pieces for r in blk])
        v2 = psum([(v.abs() ** 2).sum().to(home)
                   for blk in V_pieces for v in blk])
        return float(torch.sqrt(r2 / v2))


def make_sharded_coalesced_solve(spec: DistSpec, *, mode: str,
                                 jitter: float, uniform: bool,
                                 monitor: bool,
                                 refactorize: bool) -> ShardedSolve:
    """The request-path solve ``(S, W, L, lam0, V, lams) -> (x, resid)``
    for ``spec``'s layout: uniform λ through the resident L, mixed λ
    through batched Choleskys of the cached W, ``refactorize`` a fresh
    per-slab Gram every microbatch (the baseline)."""
    return ShardedSolve(spec, mode=mode, jitter=jitter, uniform=uniform,
                        monitor=monitor, refactorize=refactorize)


# ---------------------------------------------------------------------------
# the async front end
# ---------------------------------------------------------------------------

class _Fold(NamedTuple):
    seq: int
    rows: Any
    slots: Any
    record: bool
    dstate: Any


class _Barrier(NamedTuple):
    seq: int
    dstate: Any
    uid: Optional[int] = None    # a result() barrier: the request waited on


class AsyncSolveServer:
    """Thread-safe request front end over the (optionally sharded) window.

    Args:
      state: a ``ServeState`` (replicated; responses bit-identical to the
        eager ``SolveServer``) or a ``ShardedServeState`` (served per slab
        on its ``DistSpec``'s mesh).
      batcher / adaptation / policy / monitor_drift / jitter / fused /
        tenants: as on ``SolveServer``. With a sharded state the
        adaptation is bound to the state's spec on a copy (the caller's
        object stays usable with other servers), so its folds and
        refreshes run through the sharded fold and refresh.
      clock: latency timestamps (injectable for tests).
      registry / tracer / profile / health / recorder: as on
        ``SolveServer``; queue wait is split at the dispatch.

    The worker thread starts at once; use as a context manager or call
    ``shutdown()``.
    """

    def __init__(self, state, *,
                 batcher: Optional[TokenBudgetBatcher] = None,
                 adaptation=None, policy: str = "cached",
                 monitor_drift: bool = True, jitter: float = 0.0,
                 fused: bool = True, tenants=None, clock=time.perf_counter,
                 registry=None, tracer=None, profile=None, health=None,
                 recorder=None, metrics_window: int = 4096):
        if policy not in ("cached", "refactorize"):
            raise ValueError(f"policy must be 'cached' or 'refactorize', "
                             f"got {policy!r}")
        if isinstance(state, ShardedServeState):
            self.state: ServeState = state.state
            self.spec: Optional[DistSpec] = state.spec
            self.widths: Optional[tuple] = state.widths if state.padded \
                else None
            self.fifo_n: Optional[int] = state.n_logical
        else:
            self.state = state
            self.spec = None
            self.widths = None
            self.fifo_n = None
        self.batcher = batcher if batcher is not None \
            else TokenBudgetBatcher()
        if adaptation is not None and self.spec is not None \
                and adaptation.dist is None:
            adaptation = copy.copy(adaptation)
            adaptation.dist = self.spec
            adaptation.fifo_n = self.fifo_n
            adaptation._dist_fns = {}
            adaptation._pending_aux = []
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
        if self.adaptation is not None:
            if registry is not None and self.adaptation.registry is None:
                self.adaptation.registry = registry
            if health is not None and self.adaptation.health is None:
                self.adaptation.health = health
        # read at each call and pinned there; set it before submitting to
        # fix the state a burst's refreshes are judged against
        self.damping_state = None

        self._solve_cache: Dict[tuple, ShardedSolve] = {}
        self._cv = threading.Condition()
        self._seq = 0
        self._results: Dict[int, SolveResult] = {}
        self._result_seq: Dict[int, int] = {}
        self._pending: Set[int] = set()
        self._claimed: Set[int] = set()
        self._cancelled: Set[int] = set()
        self._folds: deque = deque()
        self._barriers: List[_Barrier] = []
        self._error: Optional[BaseException] = None
        self._stopping = False
        self._handlers_installed = False
        # the worker runs in the caller's context, so a surrounding
        # ``ops.default_mode`` holds for its solves too
        self._worker = threading.Thread(
            target=contextvars.copy_context().run, args=(self._run,),
            daemon=True, name="async-solve-server")
        self._worker.start()

    # -- calls (any thread) ------------------------------------------------
    def _place(self) -> int:
        """The next call's place; under the lock."""
        self._seq += 1
        return self._seq

    def submit(self, v, *, damping: Optional[float] = None, tokens: int = 1,
               rows=None, payload=None, tenant: Optional[str] = None,
               trace: Optional[str] = None) -> int:
        """Enqueue one request; returns its uid. Thread-safe. ``tenant``
        solves against (and folds ``rows`` into) that tenant's delta —
        needs ``tenants=``. ``trace`` tags the request's spans."""
        if tenant is not None and self.tenants is None:
            raise RuntimeError("tenant= requires a TenantManager "
                               "(AsyncSolveServer(tenants=...))")
        lam = self.state.lam0 if damping is None else float(damping)
        with self._cv:
            self._raise_if_failed()
            if self._stopping:
                raise RuntimeError("server is shut down")
            req = self.batcher.submit(v, damping=lam, tokens=tokens,
                                      rows=rows, payload=payload,
                                      tenant=tenant, trace=trace)
            req.seq = self._place()
            req.dstate = self.damping_state
            req.t_submit = self.clock()
            if self.registry is not None:
                qs = self.batcher.queue_stats(req.t_submit)
                self.registry.gauge("serve.queue_depth").set(qs["depth"])
                self.registry.gauge("serve.queue_oldest_age_s").set(
                    qs["oldest_age_s"])
            self._pending.add(req.uid)
            self._result_seq[req.uid] = req.seq
            self._cv.notify_all()
        return req.uid

    def result(self, uid: int, *, timeout: Optional[float] = None
               ) -> SolveResult:
        """Block until request ``uid`` is served and return its result; the
        call closes the microbatch that holds it. Safe against a
        concurrent ``flush()``: the uid is claimed first."""
        with self._cv:
            self._claimed.add(uid)
            barrier = _Barrier(self._place(), self.damping_state, uid)
            self._barriers.append(barrier)
            self._cv.notify_all()
            try:
                ok = self._cv.wait_for(
                    lambda: (uid in self._results or uid in self._cancelled
                             or self._error is not None), timeout)
                self._raise_if_failed()
                if not ok:
                    raise TimeoutError(
                        f"request {uid} not served in {timeout}s")
                if uid in self._cancelled:
                    self._cancelled.discard(uid)
                    raise RuntimeError(f"request {uid} was cancelled by a "
                                       "non-draining shutdown")
                self._result_seq.pop(uid, None)
                return self._results.pop(uid)
            finally:
                self._claimed.discard(uid)
                self._barriers.remove(barrier)

    def apply_fold(self, rows, *, slots=None, record: bool = True) -> int:
        """Enqueue one fold event — the replay entry point. Thread-safe; it
        applies at its place among the calls, after every request
        submitted before it (with its rows) and before every later one,
        through the same ``OnlineAdaptation.fold`` as request rows.
        Returns the number of folds queued."""
        if self.adaptation is None:
            raise RuntimeError("apply_fold needs an OnlineAdaptation")
        with self._cv:
            self._raise_if_failed()
            if self._stopping:
                raise RuntimeError("server is shut down")
            self._folds.append(_Fold(self._place(), rows, slots, record,
                                     self.damping_state))
            pos = len(self._folds)
            self._cv.notify_all()
        return pos

    def flush(self, *, damping_state=None,
              timeout: Optional[float] = None) -> List[SolveResult]:
        """Block until every request and fold submitted before this call
        is done; return those requests' results that no ``result()``
        caller claimed, FIFO. ``damping_state`` is pinned first, so the
        microbatches this call closes are judged against it."""
        with self._cv:
            if damping_state is not None:
                self.damping_state = damping_state
            barrier = _Barrier(self._place(), self.damping_state)
            self._barriers.append(barrier)
            self._cv.notify_all()
            try:
                ok = self._cv.wait_for(
                    lambda: self._error is not None
                    or self._done_before(barrier.seq), timeout)
                self._raise_if_failed()
                if not ok:
                    raise TimeoutError(
                        f"{len(self._pending)} request(s) / "
                        f"{len(self._folds)} fold(s) still pending after "
                        f"{timeout}s")
                uids = sorted(u for u in self._results
                              if u not in self._claimed
                              and self._result_seq[u] < barrier.seq)
                for u in uids:
                    del self._result_seq[u]
                return [self._results.pop(u) for u in uids]
            finally:
                self._barriers.remove(barrier)

    def _done_before(self, seq: int) -> bool:
        """Every request and fold placed before ``seq`` is done."""
        if self._folds and self._folds[0].seq < seq:
            return False
        return not any(self._result_seq[u] < seq for u in self._pending)

    # -- lifecycle ---------------------------------------------------------
    def shutdown(self, *, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the worker. ``drain=True`` (default) serves every queued
        request and applies every queued fold first; ``drain=False``
        cancels them (the microbatch in flight completes)."""
        with self._cv:
            if not self._stopping:
                self._stopping = True
                if drain:
                    self._barriers.append(
                        _Barrier(self._place(), self.damping_state))
                else:
                    for req in self.batcher._queue:
                        self._pending.discard(req.uid)
                        self._result_seq.pop(req.uid, None)
                        self._cancelled.add(req.uid)
                    self.batcher._queue.clear()
                    self._folds.clear()
            self._cv.notify_all()
        self._worker.join(timeout)
        with self._cv:
            self._raise_if_failed()

    def install_shutdown_handlers(self, *, signals=None) -> None:
        """Drain on process exit: an atexit hook and signal handlers
        (default SIGTERM) that run ``shutdown(drain=True)``, then chain to
        the handler installed before (or exit 0). Call from the main
        thread."""
        import atexit
        import signal as _signal
        if self._handlers_installed:
            return
        self._handlers_installed = True
        atexit.register(self._shutdown_quietly)
        for sig in (signals if signals is not None else (_signal.SIGTERM,)):
            prev = _signal.getsignal(sig)

            def _handler(signum, frame, _prev=prev):
                self._shutdown_quietly()
                if callable(_prev) and _prev not in (_signal.SIG_IGN,
                                                     _signal.SIG_DFL):
                    _prev(signum, frame)
                else:
                    raise SystemExit(0)

            _signal.signal(sig, _handler)

    def _shutdown_quietly(self) -> None:
        """Idempotent draining shutdown that never raises (atexit and
        signal context); worker errors already reached the callers."""
        try:
            self.shutdown(drain=True)
        except BaseException:
            pass

    def __enter__(self) -> "AsyncSolveServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown(drain=exc_type is None)

    # -- introspection -----------------------------------------------------
    @property
    def stats(self):
        return self.state.stats

    @property
    def factorization(self):
        """The resident factorization as a solver object (a sharded window
        gathered whole)."""
        return as_factorization(self.state, jitter=self.jitter)

    def sharded_state(self) -> Optional[ShardedServeState]:
        return None if self.spec is None \
            else ShardedServeState(self.state, self.spec, self.widths,
                                   self.fifo_n)

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            raise RuntimeError("server worker failed") from self._error

    # -- the worker (single consumer; owns every device dispatch) ----------
    def _next_action(self, inflight: bool):
        """What the worker does next, decided under the lock from the
        calls' places alone: ("fold", event), ("mb", microbatch, damping
        state), ("finalize",), ("exit",) or None (wait)."""
        queue = self.batcher._queue
        fold = self._folds[0] if self._folds else None
        if fold is not None and (not queue or fold.seq < queue[0].seq):
            return ("finalize",) if inflight else ("fold", fold)
        if queue:
            head = queue[0].seq
            # the earliest call after the head that closes its microbatch
            close = _Barrier(math.inf, None)
            if fold is not None:
                close = _Barrier(fold.seq, fold.dstate)
            queued = {r.uid for r in queue}
            for b in self._barriers:
                if head < b.seq < close.seq \
                        and (b.uid is None or b.uid in queued):
                    close = b
            upto = sum(1 for r in queue if r.seq < close.seq)
            _, closer = self.batcher.select(upto)
            if closer is not None:
                dstate = queue[closer].dstate
                return ("mb", self.batcher.next_microbatch(upto), dstate)
            if close.seq < math.inf:
                return ("mb", self.batcher.next_microbatch(upto),
                        close.dstate)
        if inflight:
            return ("finalize",)
        if self._stopping and not queue and not self._folds:
            return ("exit",)
        return None

    def _run(self) -> None:
        try:
            inflight = None
            while True:
                with self._cv:
                    action = self._next_action(inflight is not None)
                    while action is None:
                        self._cv.wait()
                        action = self._next_action(inflight is not None)
                kind = action[0]
                if kind == "exit":
                    return
                if kind == "finalize":
                    self._release(self._finalize(*inflight))
                    inflight = None
                elif kind == "fold":
                    ev = action[1]
                    self.state = self.adaptation.fold(
                        self.state, ev.rows, slots=ev.slots,
                        record=ev.record)
                    self._maybe_refresh(ev.dstate)
                    with self._cv:
                        self._folds.popleft()
                        self._cv.notify_all()
                else:
                    _, mb, dstate = action
                    handle = self._dispatch(mb)
                    if self.adaptation is not None:
                        # the eager order: the solve's response (its
                        # latency ends here), its folds, the refresh; the
                        # results are released once the refresh decision
                        # is in, so flush() is a state barrier too
                        results = self._finalize(mb, handle)
                        self._tenant_folds(mb)
                        self._adapt_folds(mb)
                        self._maybe_refresh(dstate)
                        self._release(results)
                        continue
                    self._tenant_folds(mb)
                    if inflight is not None:
                        nxt = (mb, handle)
                        self._release(self._finalize(*inflight))
                        inflight = nxt          # i + 1 runs while i lands
                    else:
                        inflight = (mb, handle)
        except BaseException as e:           # surfaced on the caller side
            with self._cv:
                self._error = e
                self._cv.notify_all()

    def _dispatch(self, mb: Microbatch) -> tuple:
        """Launch the coalesced solve; returns (x, resid, dispatch time)."""
        t_disp = self.clock()
        step = self.profile.step(step=self.metrics.served) \
            if self.profile is not None else contextlib.nullcontext()
        with step:
            x, resid = self._dispatch_arrays(mb)
        return x, resid, t_disp

    def _dispatch_arrays(self, mb: Microbatch) -> tuple:
        st = self.state
        if mb.tenant is not None:
            return self._dispatch_tenant(mb), None
        uniform = all(r.damping == st.lam0 for r in mb.requests)
        monitor = self.monitor_drift and self.policy == "cached"
        refactorize = self.policy == "refactorize"
        if self.spec is None:
            return _coalesced_solve(
                st.S, st.W, st.L, st.lam0, mb.V, mb.dampings,
                mode=serve_mode(st), jitter=self.jitter, uniform=uniform,
                monitor=monitor, refactorize=refactorize, fused=self.fused)
        return self._sharded_solve(uniform, monitor, refactorize)(
            st.S, st.W, st.L, st.lam0, self._pad_rhs(mb.V), mb.dampings)

    def _sharded_solve(self, uniform: bool, monitor: bool,
                       refactorize: bool) -> ShardedSolve:
        key = (uniform, monitor, refactorize)
        fn = self._solve_cache.get(key)
        if fn is None:
            fn = make_sharded_coalesced_solve(
                self.spec, mode=serve_mode(self.state), jitter=self.jitter,
                uniform=uniform, monitor=monitor, refactorize=refactorize)
            self._solve_cache[key] = fn
        return fn

    def _dispatch_tenant(self, mb: Microbatch):
        """A tenant microbatch: the tenant's L_t in place of the resident L,
        on the replicated or the sharded path, no monitoring."""
        st = self.state

        def solve(L_t, lam: float, V, dampings):
            if self.spec is None:
                x, _ = _coalesced_solve(
                    st.S, st.W, L_t, lam, V, dampings, mode=serve_mode(st),
                    jitter=self.jitter, uniform=True, monitor=False,
                    refactorize=False, fused=self.fused)
            else:
                x, _ = self._sharded_solve(True, False, False)(
                    st.S, st.W, L_t, lam, self._pad_rhs(V), dampings)
            return x

        return serve_tenant_microbatch(st, self.tenants, mb, solve)

    def _pad_rhs(self, V):
        """Stacked RHS columns zero-padded to the window's padded widths."""
        return pad_to_window_cols(self.state.S, V, axis=0)

    def _unpad_x(self, x):
        """Solutions sliced back to the logical parameter count."""
        if self.widths is None:
            return x
        if isinstance(x, (tuple, list)):
            return tuple(xb[:w] for xb, w in zip(x, self.widths))
        return x[:self.widths[0]]

    def _finalize(self, mb: Microbatch, handle: tuple) -> List[SolveResult]:
        """The response boundary: the worker's one wait on the device."""
        x, resid, t_disp = handle
        x = self._unpad_x(x)
        _wait(x)
        t_done = self.clock()
        st = self.state
        stats = st.stats._replace(
            served=st.stats.served + mb.k,
            microbatches=st.stats.microbatches + 1,
            last_residual=st.stats.last_residual if resid is None else resid)
        self.state = st._replace(age=st.age + 1, stats=stats)
        if self.registry is not None:
            self.registry.counter("serve.microbatches").inc()
            self.registry.histogram("serve.solve_latency_s").observe(
                t_done - t_disp)
        epoch_done_us = time.time() * 1e6 if self.tracer is not None else 0.0
        if self.tracer is not None:
            solve_us = (t_done - t_disp) * 1e6
            self.tracer.add(
                "device_solve", cat="solve", ts_us=epoch_done_us - solve_us,
                dur_us=solve_us,
                args={"k": mb.k, "uids": [r.uid for r in mb.requests],
                      "tenant": mb.tenant})
        results = []
        for j, req in enumerate(mb.requests):
            xj = tuple(xb[:, j] for xb in x) \
                if isinstance(x, (tuple, list)) else x[:, j]
            queue_s = max(t_disp - req.t_submit, 0.0) \
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
                    "queue_wait", cat="queue",
                    ts_us=epoch_done_us - e2e_us, dur_us=queue_s * 1e6,
                    trace=req.trace, args={"uid": req.uid})
                self.tracer.add(
                    "request", cat="serve", ts_us=epoch_done_us - e2e_us,
                    dur_us=e2e_us, trace=req.trace, args={"uid": req.uid})
            results.append(SolveResult(uid=req.uid, x=xj,
                                       damping=req.damping,
                                       latency_s=t_done - req.t_submit))
        return results

    def _release(self, results: List[SolveResult]) -> None:
        with self._cv:
            for r in results:
                self._results[r.uid] = r
                self._pending.discard(r.uid)
            self._cv.notify_all()

    def _tenant_folds(self, mb: Microbatch) -> None:
        """Tenant-private folds: into the tenant's delta, after its solve."""
        if mb.tenant is None:
            return
        for req in mb.requests:
            if req.rows is not None:
                self.tenants.fold(self.state, mb.tenant, req.rows)

    def _adapt_folds(self, mb: Microbatch) -> None:
        if mb.tenant is not None:
            return          # tenant rows went to the delta, not the window
        for req in mb.requests:
            if req.rows is None:
                continue
            span = self.tracer.span("fold", cat="adapt", trace=req.trace) \
                if self.tracer is not None else contextlib.nullcontext()
            with span:
                self.state = self.adaptation.fold(self.state, req.rows)

    def _maybe_refresh(self, dstate) -> None:
        self.state, refreshed = self.adaptation.maybe_refresh(
            self.state, damping_state=dstate)
        if self.registry is not None:
            self.registry.gauge("curvature.factor_age").set(self.state.age)
            self.registry.gauge("curvature.last_drift_residual").set(
                self.state.stats.last_residual)
        if refreshed and self.tracer is not None:
            self.tracer.add("refresh", cat="adapt",
                            ts_us=time.time() * 1e6, dur_us=0.0)
        if self.recorder is not None:
            self.recorder.observe(self.state, adaptation=self.adaptation,
                                  health=self.health,
                                  registry=self.registry,
                                  tracer=self.tracer)
