"""``TenantManager`` — LRU residency for thousands of per-tenant deltas
(torch port of ``repro/tenants/manager.py``).

Each registered tenant owns a rank-r ``TenantDelta`` plus a per-tenant
``FoldJournal`` of its *projected* fold columns; the manager keeps only
the hot set resident under an explicit byte budget. Three tiers:

* **hot** — delta resident *and* the materialized n×n tenant factor L_t
  cached, so a solve is a pure factor swap. The cache is keyed on the
  base state's maintenance counters (adapted / refreshes) + λ + the
  tenant's journal position, so any base fold, base refresh, λ change or
  tenant fold rebuilds it.
* **warm** — delta resident (O(n·r) bytes), factor rebuilt on demand at
  O(n²·r) via ``delta_factor``.
* **spilled** — delta on disk in one npz (``checkpoint.fleet.
  save_tenant_spill``), zero bytes resident. Folds for a spilled tenant
  append to its journal without waking it; activation = load the npz +
  replay the journal tail (``events_since(applied)``) — bit-identical to
  never having evicted, because fold events store the already-projected
  dual columns (no S pass, no dependence on how the base window evolved
  since the spill).

Eviction is LRU over *resident* tenants whenever admitting or
materializing would cross ``budget_bytes``; every spill also compacts the
tenant's journal below the spilled seq (the npz covers that prefix). The
journal's projected rows are host numpy (k, n), not (k, m): tenant
history is dual-sized. The delta and L_t live on the base state's device.

The manager is single-process state (dicts, host arrays and tensors).
"""
from __future__ import annotations

import pathlib
import tempfile
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.fleet import load_tenant_spill, save_tenant_spill
from repro_torch.core.solvers import cholesky
from repro_torch.serve.journal import FoldJournal
from repro_torch.serve.state import ServeState
from repro_torch.tenants.delta import (TenantDelta, delta_factor, delta_fold,
                                       delta_nbytes, init_tenant_delta,
                                       project_rows)

__all__ = ["TenantManager", "TenantStats"]


class TenantStats:
    """Counters the manager exposes (heartbeats, benches). Plain ints —
    wire-safe through json as a dict."""

    def __init__(self):
        self.activations = 0     # spill loads (restore + tail replay)
        self.evictions = 0       # residency drops (delta spilled to npz)
        self.materializations = 0  # factor (re)builds, O(n²·r) each
        self.factor_hits = 0     # solves served straight from a cached L_t

    def as_dict(self) -> dict:
        return {"activations": self.activations,
                "evictions": self.evictions,
                "materializations": self.materializations,
                "factor_hits": self.factor_hits}


class _Tenant:
    """One registry entry. ``delta`` is None exactly when spilled."""

    __slots__ = ("tid", "delta", "journal", "applied", "L", "factor_key",
                 "last_used", "served", "spill_path")

    def __init__(self, tid: str):
        self.tid = tid
        self.delta: Optional[TenantDelta] = None
        self.journal = FoldJournal()
        self.applied = 0          # journal seq folded into `delta`
        self.L: Optional[torch.Tensor] = None
        self.factor_key: Optional[Tuple] = None
        self.last_used = 0
        self.served = 0
        self.spill_path: Optional[pathlib.Path] = None

    @property
    def resident(self) -> bool:
        return self.delta is not None

    def nbytes(self) -> int:
        b = 0
        if self.delta is not None:
            b += delta_nbytes(self.delta)
        if self.L is not None:
            b += self.L.numel() * self.L.element_size()
        return b


def _spill_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A spilled array back on ``device`` (raw ``|V2`` records are bf16)."""
    if a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


class TenantManager:
    """Registry + memory manager over one shared base ``ServeState``."""

    def __init__(self, rank: int, *, budget_bytes: Optional[int] = None,
                 spill_dir=None, registry=None):
        if rank < 1:
            raise ValueError("tenant rank budget must be >= 1")
        self.rank = int(rank)
        self.budget_bytes = None if budget_bytes is None else \
            int(budget_bytes)
        self.spill_dir = pathlib.Path(
            spill_dir if spill_dir is not None
            else tempfile.mkdtemp(prefix="tenant_spill_"))
        self.stats = TenantStats()
        # optional repro_torch.obs.MetricsRegistry: occupancy gauges plus
        # evict/activate latency histograms (the residency tier's health)
        self.registry = registry
        self._tenants: Dict[str, _Tenant] = {}
        self._tick = 0            # LRU clock: bumped on every touch

    def __len__(self) -> int:
        return len(self._tenants)

    def __contains__(self, tid) -> bool:
        return str(tid) in self._tenants

    def tenants(self):
        return list(self._tenants)

    # -- registry ------------------------------------------------------------
    def _touch(self, t: _Tenant) -> None:
        self._tick += 1
        t.last_used = self._tick

    def _get(self, tid, *, create: bool, state: Optional[ServeState] = None
             ) -> _Tenant:
        tid = str(tid)
        t = self._tenants.get(tid)
        if t is None:
            if not create:
                raise KeyError(f"unknown tenant {tid!r}")
            t = _Tenant(tid)
            t.delta = init_tenant_delta(state.L.shape[0], self.rank,
                                        dtype=state.L.dtype,
                                        device=state.L.device)
            self._tenants[tid] = t
            self._ensure_budget(exempt=tid)
        return t

    def delta(self, state: ServeState, tid) -> TenantDelta:
        """The tenant's resident delta (activating a spilled one)."""
        t = self._get(tid, create=True, state=state)
        self._activate(t, state.L.device)
        self._touch(t)
        return t.delta

    # -- folds ----------------------------------------------------------------
    def fold(self, state: ServeState, tid, rows, *, signs=None
             ) -> Tuple[int, ...]:
        """Fold tenant score rows (k, m): project through the resident
        base factor, journal the dual columns, and apply to the delta if
        the tenant is resident (a spilled tenant's folds accumulate in the
        journal and apply at activation — folding never wakes it).
        Returns the rank-budget slots written."""
        t = self._get(tid, create=True, state=state)
        Q = project_rows(state, rows)                      # (n, k)
        k = Q.shape[1]
        # the FIFO cursor is derivable without the delta: total folded
        # rows mod the rank budget (exactly TenantDelta.cursor's arithmetic)
        cursor = t.journal.total_k % self.rank
        slots = tuple((cursor + i) % self.rank for i in range(k))
        ev_rows = Q.T.contiguous().cpu().numpy()           # (k, n): dual-sized
        if signs is not None:
            ev_rows = np.concatenate(
                [ev_rows, np.asarray(signs, np.float32).reshape(k, 1)],
                axis=1)
        t.journal.append_fold(slots, ev_rows, origin=t.tid)
        if self.registry is not None:
            self.registry.counter("tenants.folds").inc()
            self.registry.counter("tenants.fold_rows").inc(k)
        if t.resident:
            t.delta, got = delta_fold(t.delta, Q, signs=signs)
            if got != slots:
                raise AssertionError(f"tenant {t.tid}: journal slots "
                                     f"{slots} != delta slots {got}")
            t.applied = t.journal.head
            t.L, t.factor_key = None, None     # factor is stale now
        self._touch(t)
        return slots

    def _apply_event(self, t: _Tenant, ev) -> None:
        rows = np.asarray(ev.rows)
        signs = None
        if rows.shape[1] == t.delta.cols.shape[0] + 1:   # signs rode along
            rows, signs = rows[:, :-1], rows[:, -1].real
        cols = torch.from_numpy(np.ascontiguousarray(rows.T)).to(
            t.delta.cols.device)
        t.delta, got = delta_fold(t.delta, cols, signs=signs)
        if got != tuple(ev.slots):
            raise AssertionError(
                f"tenant {t.tid}: replay of seq {ev.seq} landed in slots "
                f"{got}, journal says {tuple(ev.slots)}")

    # -- residency ------------------------------------------------------------
    def _activate(self, t: _Tenant, device) -> None:
        if t.resident:
            return
        t0 = time.perf_counter()
        arrays, meta = load_tenant_spill(t.spill_path)
        t.delta = TenantDelta(cols=_spill_tensor(arrays["cols"], device),
                              signs=_spill_tensor(arrays["signs"], device),
                              cursor=int(arrays["cursor"]),
                              age=int(arrays["age"]))
        t.applied = int(meta["applied"])
        for ev in t.journal.events_since(t.applied):       # tail replay
            self._apply_event(t, ev)
        t.applied = t.journal.head
        self.stats.activations += 1
        if self.registry is not None:
            self.registry.counter("tenants.activations").inc()
            self.registry.histogram("tenants.activate_latency_s").observe(
                time.perf_counter() - t0)
            self._occupancy_gauges()
        self._ensure_budget(exempt=t.tid)

    def evict(self, tid) -> pathlib.Path:
        """Spill one tenant: delta → npz, drop it and any cached factor
        from memory, compact its journal below the spilled seq."""
        t = self._get(tid, create=False)
        if not t.resident:
            return t.spill_path
        t0 = time.perf_counter()
        path = self.spill_dir / f"tenant_{t.tid}.npz"
        t.spill_path = save_tenant_spill(
            path,
            {"cols": t.delta.cols, "signs": t.delta.signs,
             "cursor": np.asarray(t.delta.cursor, np.int32),
             "age": np.asarray(t.delta.age, np.int32)},
            {"tenant": t.tid, "applied": t.applied, "rank": self.rank})
        t.delta, t.L, t.factor_key = None, None, None
        t.journal.compact(t.applied)       # the npz covers that prefix
        self.stats.evictions += 1
        if self.registry is not None:
            self.registry.counter("tenants.evictions").inc()
            self.registry.histogram("tenants.evict_latency_s").observe(
                time.perf_counter() - t0)
            self._occupancy_gauges()
        return t.spill_path

    def _ensure_budget(self, *, exempt: Optional[str] = None) -> None:
        if self.budget_bytes is None:
            return
        while self.resident_bytes() > self.budget_bytes:
            victims = [t for t in self._tenants.values()
                       if t.resident and t.tid != exempt]
            if not victims:
                return             # the exempt tenant alone may exceed it
            self.evict(min(victims, key=lambda t: t.last_used).tid)

    # -- the solve-path entry point -------------------------------------------
    def factor(self, state: ServeState, tid, *, lam=None) -> torch.Tensor:
        """The tenant's factor L_t at ``lam`` (default: the resident λ₀),
        activating and materializing as needed. This is what the server
        swaps in for ``state.L`` on a tenant microbatch. Away from λ₀ the
        base is re-damped by a Cholesky of the cached W + λI (the plain
        factorization, as the reference's ``jnp.linalg.cholesky``)."""
        t = self._get(tid, create=True, state=state)
        self._activate(t, state.L.device)
        lam_v = float(state.lam0) if lam is None else float(lam)
        key = (int(state.stats.adapted), int(state.stats.refreshes),
               lam_v, t.applied)
        if t.L is not None and t.factor_key == key:
            self.stats.factor_hits += 1
        else:
            base_L = state.L
            if lam is not None and lam_v != float(state.lam0):
                eye = torch.eye(state.W.shape[0], dtype=state.W.dtype,
                                device=state.W.device)
                base_L = cholesky(state.W + lam_v * eye)
            if self.registry is not None:
                # the rank-r core eigenvalues are computed for the
                # correction anyway — gauge their conditioning (worst
                # across tenants wins: max-merged via the condest suffix)
                t.L, cond = delta_factor(t.delta, base_L, lam_v,
                                         return_cond=True)
                cond_v = float(cond)
                prev = self.registry.gauge(
                    "tenants.delta_core_condest").value
                self.registry.gauge("tenants.delta_core_condest").set(
                    max(prev, cond_v))
            else:
                t.L = delta_factor(t.delta, base_L, lam_v)
            t.factor_key = key
            self.stats.materializations += 1
            if self.registry is not None:
                self.registry.counter("tenants.materializations").inc()
            self._ensure_budget(exempt=t.tid)
        t.served += 1
        self._touch(t)
        if self.registry is not None:
            self._occupancy_gauges()
        return t.L

    def _occupancy_gauges(self) -> None:
        """Hot/warm/spilled occupancy into the registry (hot = factor
        cached; warm = delta resident, factor not)."""
        reg = self.registry
        hot = sum(1 for t in self._tenants.values()
                  if t.resident and t.L is not None)
        resident = self.resident_count()
        reg.gauge("tenants.registered").set(len(self._tenants))
        reg.gauge("tenants.hot").set(hot)
        reg.gauge("tenants.warm").set(resident - hot)
        reg.gauge("tenants.spilled").set(len(self._tenants) - resident)
        reg.gauge("tenants.resident_bytes").set(self.resident_bytes())

    # -- accounting -----------------------------------------------------------
    def resident_bytes(self) -> int:
        return sum(t.nbytes() for t in self._tenants.values())

    def resident_count(self) -> int:
        return sum(t.resident for t in self._tenants.values())

    def packing_stats(self, *, top: int = 4) -> dict:
        """Wire-safe summary: residency, budget pressure, and the hottest
        tenants by solves served."""
        hot = sorted(self._tenants.values(), key=lambda t: -t.served)[:top]
        return {"tenants": len(self._tenants),
                "resident": self.resident_count(),
                "spilled": len(self._tenants) - self.resident_count(),
                "resident_bytes": self.resident_bytes(),
                "budget_bytes": self.budget_bytes,
                "hot": {t.tid: t.served for t in hot if t.served},
                **self.stats.as_dict()}
