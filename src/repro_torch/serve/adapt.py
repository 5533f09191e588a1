"""Online adaptation — serving gradients folded into the resident window
(torch port of ``repro/serve/adapt.py``).

After a request's solve, its per-sample score rows enter the n-sample
window FIFO, the k oldest samples retiring per fold:

    cols = S·rows†  (one O(n·m·k) pass — the only m-sized work; kernel)
    X, Y, W' = replace_factors(W, cols, idx)          (2k×2k core split)
    L' = chol_downdate(chol_update(L, X), Y)          (O(n²·k))
    S'[idx] = rows

A fold returns a new state and leaves the old one intact (the window is
copied, not written in place), as the reference's pure fold does.

Staleness is bounded like the training-side cache: ``maybe_refresh``
(between microbatches) refactorizes when the factor's age reaches
``refresh_every`` microbatches or the last monitored residual exceeds the
drift threshold (static ``drift_tol``, else ``auto_drift_tol``).

Folds are also events: with a ``journal`` attached (or an ``on_fold``
callback) every applied fold is emitted as a ``FoldEvent`` — the rows as
stored plus the FIFO slots they landed in — and every refresh too;
``fold(..., slots=...)`` replays such an event, verifying the slots
against the local cursor. Replaying the same events onto the same initial
state on the same device reproduces the factor bit for bit
(``FoldJournal.replay``).

With a ``repro_torch.obs`` registry attached the adaptation reports the
reference's series: ``curvature.folds``/``fold_rows``/``refreshes``/
``refresh_<reason>`` counters, ``window.bytes.<dtype>`` gauges, each
fold's downdate margin (``curvature.downdate_margin``,
``curvature.downdate_clamped``), drained at the maintenance boundary, and
every ``audit_every`` boundaries the factor audit (``curvature.condest``,
``curvature.factor_residual``); a ``health`` monitor is evaluated there
and gets an event for each fold it rejects for NaN/Inf rows
(``serve.fold.rejected_nonfinite``). Every number read to the host is
read at that boundary, as in the reference.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from repro_torch.core.damping import auto_drift_tol
from repro_torch.core.operator import BlockedScores, acc_dtype, is_blocked
from repro_torch.core.solvers import chol_factorize
from repro_torch.curvature.update import (chol_downdate, chol_update,
                                          replacement_core, signed_split)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.serve.state import ServeState, serve_mode

__all__ = ["OnlineAdaptation", "pad_to_window_cols"]


def _n_blocks(S) -> Optional[int]:
    """Block count of a blocked window (sharded or not); None if dense."""
    from repro_torch.dist.state import is_sharded
    if is_sharded(S):
        return len(S.pieces) if S.blocked else None
    return len(S.blocks) if is_blocked(S) else None


def pad_to_window_cols(S, values, *, axis: int, cast: Optional[bool] = None):
    """Zero-pad ``values`` (dense or per-block tuple) along ``axis`` up to
    the window's column widths, and place them, contiguous, on the
    window's device — the single point where incoming data meets the
    window. Fold rows use axis=1 ((k, m)), stacked RHS axis=0 ((m, k)).

    ``cast`` (default: ``axis == 1``, i.e. fold rows) also rounds the
    values to each block's storage dtype — the one dtype-aware cast point,
    so a bf16 window computes its fold columns from exactly the values
    the FIFO write stores. RHS columns are not rounded. A sharded window
    (``repro_torch.dist``) takes its whole widths, the values landing on
    its first device."""
    from repro_torch.dist.state import is_sharded
    S_blocks = S.templates() if is_sharded(S) else \
        S.blocks if is_blocked(S) else (S,)
    val_blocks = tuple(values) if isinstance(values, (tuple, list)) \
        else (values,)
    if cast is None:
        cast = axis == 1

    def pad(v, block):
        v = torch.as_tensor(v)
        if cast and v.dtype != block.dtype and block.dtype.is_floating_point \
                and v.dtype.is_floating_point:
            v = v.to(block.dtype)
        v = v.to(block.device).contiguous()
        width = block.shape[1]
        if v.shape[axis] >= width:
            return v
        shape = list(v.shape)
        shape[axis] = width - v.shape[axis]
        return torch.cat([v, v.new_zeros(shape)], dim=axis)

    padded = tuple(pad(v, b) for b, v in zip(S_blocks, val_blocks))
    if isinstance(values, (tuple, list)):
        return padded
    return padded[0]


def _fold_window(S, W, L, slot: int, rows, *, with_aux: bool = False,
                 fifo_n: Optional[int] = None):
    """One FIFO fold: rows (k, m) dense or per-block pieces replace the k
    oldest window samples. Returns (S', W', L', slot', aux) — ``aux`` the
    downdate's ``DowndateAux`` when ``with_aux``, else None — or None when
    the rows hold a NaN/Inf (the fold is rejected). ``fifo_n``: the FIFO
    modulus when it is not W's size (a window padded in its sample axis).

    The fold makes one host read, as the reference's does: the rows'
    finiteness flag travels with the 2k×2k replacement core, whose
    eigendecomposition runs on the host."""
    n = W.shape[0] if fifo_n is None else fifo_n
    row_blocks = tuple(rows) if isinstance(rows, (tuple, list)) else (rows,)
    k = row_blocks[0].shape[0]
    idx = (torch.arange(k, device=W.device) + slot) % n
    finite = torch.stack([torch.isfinite(b).all() for b in row_blocks]).all()

    # new Gram columns W'[:, idx]: old rows via S·rows†, the replaced rows'
    # own entries via the rows·rows† corner — one fused pass (kernel on CUDA)
    cols, corner = kernel_ops.fold_cols(S, rows)
    acc = acc_dtype(W.dtype)
    cols = cols.to(acc)
    cols[idx, :] = corner.to(acc)

    U, core, Wp = replacement_core(W, cols, idx)
    host = torch.cat([finite.to(core.dtype).reshape(1),
                      core.reshape(-1)]).cpu()
    if not bool(host[0]):
        return None
    X, Y = signed_split(U, host[1:].reshape(core.shape))
    aux = None
    if with_aux:
        Lp, aux = chol_downdate(chol_update(L, X), Y, return_aux=True)
    else:
        Lp = chol_downdate(chol_update(L, X), Y)
    S_blocks = S.blocks if is_blocked(S) else (S,)
    new_blocks = []
    for b, r in zip(S_blocks, row_blocks):
        nb = b.clone()
        nb[idx, :] = r.to(b.dtype)
        new_blocks.append(nb)
    Sp = BlockedScores(new_blocks, names=S.names) if is_blocked(S) \
        else new_blocks[0]
    return Sp, Wp, Lp, (slot + k) % n, aux


class OnlineAdaptation:
    """Bounded-staleness maintenance policy for the serving window.

    Thresholds mirror ``StreamingCurvature`` (age period + drift bound,
    the static ``drift_tol`` overriding the ``drift_frac`` autotune);
    ``from_policy`` copies them from a training-side policy.

    ``journal`` (``serve.journal.FoldJournal``) records every applied fold
    and refresh; ``on_fold(event)`` fires per fold. ``registry`` and
    ``health`` (``repro_torch.obs``) receive the series and events of the
    module docstring; ``audit_every`` (maintenance boundaries, 0: off),
    ``audit_probes`` and ``condest_iters`` set the audit, which, as in the
    reference, runs only with a registry. ``track_margins`` drains the
    downdate margins without a registry. Host-side mirrors, kept with or
    without a registry: ``rejected_nonfinite`` (rejected folds),
    ``downdate_margin`` (worst margin of the last drain) and
    ``downdate_clamped`` (clamped downdates).

    ``dist`` (``repro_torch.dist.DistSpec``): folds and refreshes run
    through the sharded fold and refresh of ``dist.cholupdate`` (per-slab
    passes, the replicated factor) on a window laid out on its mesh.
    ``fifo_n`` pins the FIFO modulus to the logical sample count of a
    window padded in its sample axis (set by the async server when it
    binds a padded sharded state; None: W's size).
    """

    def __init__(self, *, refresh_every: int = 64,
                 drift_tol: Optional[float] = None,
                 drift_frac: Optional[float] = 0.25, jitter: float = 0.0,
                 journal=None, on_fold=None, registry=None, health=None,
                 audit_every: int = 0, audit_probes: int = 2,
                 condest_iters: int = 2, track_margins: bool = False,
                 dist=None):
        if refresh_every < 1:
            raise ValueError("refresh_every must be >= 1")
        self.refresh_every = int(refresh_every)
        self.drift_tol = None if drift_tol is None else float(drift_tol)
        self.drift_frac = None if drift_frac is None else float(drift_frac)
        self.jitter = float(jitter)
        self.journal = journal
        self.on_fold = on_fold
        self.registry = registry
        self.health = health
        self.audit_every = int(audit_every)
        self.audit_probes = int(audit_probes)
        self.condest_iters = int(condest_iters)
        self._audit_tick = 0
        self._audit_step = 0
        self.track_margins = bool(track_margins)
        self.rejected_nonfinite = 0
        self.downdate_margin: Optional[float] = None
        self.downdate_clamped = 0
        # (DowndateAux, CUDA event or None) of recent folds, drained at the
        # next maybe_refresh; bounded so it cannot grow without limit
        self._pending_aux: list = []
        self.dist = dist
        self.fifo_n: Optional[int] = None
        self._dist_fns: dict = {}       # (kind, mode) -> sharded fold/refresh

    @classmethod
    def from_policy(cls, policy, *, jitter: Optional[float] = None
                    ) -> "OnlineAdaptation":
        """Adopt a ``StreamingCurvature`` policy's thresholds."""
        return cls(refresh_every=policy.refresh_every,
                   drift_tol=policy.drift_tol,
                   drift_frac=getattr(policy, "drift_frac", None),
                   jitter=policy.jitter if jitter is None else jitter)

    @property
    def _tracks_margins(self) -> bool:
        return self.track_margins or self.registry is not None

    def effective_drift_tol(self, damping_state=None) -> Optional[float]:
        if self.drift_tol is not None:
            return self.drift_tol
        if self.drift_frac is not None:
            return float(auto_drift_tol(damping_state, frac=self.drift_frac))
        return None

    def fold(self, state: ServeState, rows, *, slots=None,
             record: bool = True) -> ServeState:
        """Fold one request's score rows into the window (FIFO replace).

        ``rows``: (k, m) — or per-block (k, m_b) pieces for a blocked
        window — with k ≤ n. ``slots``: optional FIFO slot indices of a
        replayed fold, verified against the local cursor (raises on
        divergence), so a replayer can only apply folds in order. Rows
        holding a NaN/Inf are rejected: the state comes back unchanged.
        ``record=False`` keeps the fold out of the journal and ``on_fold``
        (the replayer's own folds)."""
        row_blocks = tuple(rows) if isinstance(rows, (tuple, list)) \
            else (rows,)
        k = int(row_blocks[0].shape[0])
        n = int(state.W.shape[0]) if self.fifo_n is None else self.fifo_n
        if k > n:
            raise ValueError(f"cannot fold {k} rows into an n={n} window")
        n_blocks = _n_blocks(state.S)
        if n_blocks is not None and len(row_blocks) != n_blocks:
            raise ValueError(
                f"{len(row_blocks)} row blocks for a {n_blocks}-block "
                "window")
        expect = tuple((state.slot + i) % n for i in range(k))
        if slots is not None:
            got = tuple(int(s) for s in slots)
            if got != expect:
                raise ValueError(
                    f"fold replay out of order: event slots {got} vs local "
                    f"FIFO cursor {expect} (apply events in journal order)")
        # the one dtype-aware cast + pad point: the journal, the cross
        # pass and the FIFO write all see the stored values
        rows_in = pad_to_window_cols(state.S, rows, axis=1)
        if self.dist is not None:
            from repro_torch.dist.state import shard_window
            fold = self._dist_fn("fold", serve_mode(state))
            out = fold.apply(shard_window(state.S, self.dist), state.W,
                             state.L, state.slot, rows_in,
                             with_aux=self._tracks_margins)
        else:
            out = _fold_window(state.S, state.W, state.L, state.slot,
                               rows_in, with_aux=self._tracks_margins,
                               fifo_n=self.fifo_n)
        if out is None:
            # one NaN/Inf row would poison W, L and the window at once
            self._reject_nonfinite()
            return state
        Sp, Wp, Lp, slot, aux = out
        if aux is not None and len(self._pending_aux) < 1024:
            event = None
            if Lp.is_cuda:
                event = torch.cuda.Event()
                event.record()
            self._pending_aux.append((aux, event))
        stats = state.stats._replace(adapted=state.stats.adapted + k)
        if self.registry is not None:
            self.registry.counter("curvature.folds").inc()
            self.registry.counter("curvature.fold_rows").inc(k)
            self._window_gauges(Sp)
        if record and (self.journal is not None or self.on_fold is not None):
            if self.journal is not None:
                ev = self.journal.append_fold(expect, rows_in)
            else:
                from repro_torch.serve.journal import FoldEvent
                ev = FoldEvent(seq=-1, kind="fold", slots=expect,
                               rows=rows_in)
            if self.on_fold is not None:
                self.on_fold(ev)
        return state._replace(S=Sp, W=Wp, L=Lp, slot=slot, stats=stats)

    def _reject_nonfinite(self) -> None:
        self.rejected_nonfinite += 1
        if self.registry is not None:
            self.registry.counter("serve.fold.rejected_nonfinite").inc()
        if self.health is not None:
            from repro_torch.obs.health import HealthEvent
            self.health.record_event(HealthEvent(
                ts=time.time(), severity="degraded", rule="nonfinite_folds",
                series="serve.fold.rejected_nonfinite", value=1.0,
                bound=0.0,
                recommendation="fold rows with NaN/Inf were rejected: "
                               "check the score producer upstream"))

    def _window_gauges(self, S) -> None:
        """Window storage by dtype — shapes and dtypes only, no device
        read."""
        from repro_torch.dist.state import is_sharded
        by_dtype: dict = {}
        pieces = [p for _, p in S.slab_pieces()] if is_sharded(S) else \
            S.blocks if is_blocked(S) else (S,)
        for b in pieces:
            name = str(b.dtype).removeprefix("torch.")
            by_dtype[name] = by_dtype.get(name, 0) \
                + b.numel() * b.element_size()
        for name, nb in by_dtype.items():
            self.registry.gauge(f"window.bytes.{name}").set(nb)

    def maybe_refresh(self, state: ServeState, *, damping_state=None,
                      force: bool = False, record: bool = True
                      ) -> Tuple[ServeState, bool]:
        """Full W refactorization when the staleness bound is hit — called
        between microbatches, never on the request path. Returns
        (state', refreshed). The maintenance boundary also drains the
        downdate margins, ticks the audit and evaluates the health rules."""
        tol = self.effective_drift_tol(damping_state)
        r = float(state.stats.last_residual)
        age_due = state.age >= self.refresh_every
        drift_due = tol is not None and r >= 0.0 and r > tol
        refreshed = force or age_due or drift_due
        if refreshed:
            if record and self.journal is not None:
                self.journal.append_refresh()
            if self.dist is not None:
                W, L = self._dist_fn("refresh", serve_mode(state))(
                    state.S, state.lam0)
            else:
                fac = chol_factorize(state.S, state.lam0,
                                     mode=serve_mode(state),
                                     jitter=self.jitter)
                W, L = fac.W, fac.L
            stats = state.stats._replace(refreshes=state.stats.refreshes + 1,
                                         last_residual=-1.0)
            if self.registry is not None:
                self.registry.counter("curvature.refreshes").inc()
                reason = "force" if force else ("age" if age_due else "drift")
                self.registry.counter(f"curvature.refresh_{reason}").inc()
            state = state._replace(W=W, L=L, age=0, stats=stats)
        self._observe_health(state)
        return state, refreshed

    def _dist_fn(self, kind: str, mode: str):
        """Build-once cache of the sharded fold/refresh for ``self.dist``."""
        fn = self._dist_fns.get((kind, mode))
        if fn is None:
            from repro_torch.dist.cholupdate import (make_sharded_fold,
                                                     make_sharded_refresh)
            spec = self.dist
            if kind == "fold":
                fn = make_sharded_fold(
                    spec.mesh, layout=spec.layout,
                    model_axis=spec.model_axis, data_axis=spec.data_axis,
                    mode=mode, fifo_n=self.fifo_n)
            else:
                fn = make_sharded_refresh(
                    spec.mesh, layout=spec.layout,
                    model_axis=spec.model_axis, data_axis=spec.data_axis,
                    mode=mode, jitter=self.jitter)
            self._dist_fns[(kind, mode)] = fn
        return fn

    def _observe_health(self, state: ServeState) -> None:
        """The maintenance boundary's reads: the pending downdate margins,
        the audit every ``audit_every`` boundaries, then the health rules
        (the last two only with a registry, as in the reference)."""
        self._drain_margins()
        if self.registry is None:
            return
        if self.audit_every > 0:
            self._audit_tick += 1
            if self._audit_tick >= self.audit_every:
                self._audit_tick = 0
                self.audit(state)
        if self.health is not None:
            self.health.evaluate()

    def _drain_margins(self) -> None:
        """Read the margins of folds whose device work already finished
        (blocking would serialize the fold chain against the next
        microbatch); a backlog past 64 drains in full."""
        if not self._tracks_margins:
            self._pending_aux.clear()
            return
        pending = self._pending_aux
        split = len(pending)
        if split <= 64:
            for i, (_, event) in enumerate(pending):
                if event is not None and not event.query():
                    split = i
                    break
        done, self._pending_aux = pending[:split], pending[split:]
        margins = [float(a.margin) for a, _ in done]
        clamped = sum(bool(a.clamped) for a, _ in done)
        vals = [v for v in margins if v == v]          # NaN-proof min
        if vals:
            self.downdate_margin = min(vals)
        self.downdate_clamped += clamped
        if self.registry is not None:
            if vals:
                self.registry.gauge(
                    "curvature.downdate_margin").set(min(vals))
            if clamped:
                self.registry.counter(
                    "curvature.downdate_clamped").inc(clamped)

    def audit(self, state: ServeState) -> dict:
        """One factor audit: the Hager/Higham 1-norm condition estimate of
        W + λĨ and a Hutchinson probe of the factor residual, against the
        resident W and L (``repro_torch.curvature.audit``), read to the
        host and mirrored into ``curvature.condest`` /
        ``curvature.factor_residual``."""
        from repro_torch.curvature.audit import audit_factor
        self._audit_step += 1
        res = audit_factor(state.W, state.L, state.lam0,
                           iters=self.condest_iters,
                           probes=self.audit_probes, step=self._audit_step)
        out = {"condest": float(res.condest),
               "residual": float(res.residual)}
        if self.registry is not None:
            self.registry.gauge("curvature.condest").set(out["condest"])
            self.registry.gauge(
                "curvature.factor_residual").set(out["residual"])
        return out
