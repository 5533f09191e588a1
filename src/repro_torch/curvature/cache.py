"""Cross-step curvature reuse — the damped factorization as a cached asset.

Port of ``repro/curvature/cache.py``. Consecutive batches describe
heavily overlapping curvature, so the O(n²·m) Gram pass of Algorithm 1
need not rerun every step. ``StreamingCurvature`` is the refresh policy:

* **age refresh** — recompute W from the current scores every
  ``refresh_every`` steps;
* **drift refresh** — between scheduled refreshes, check the relative
  ``residual`` of the solve under the cached W (two O(n·m) passes) and
  refresh when it exceeds ``drift_tol`` (or the ``drift_frac`` autotune);
* **λ changes** — always re-damped from the cached *undamped* W through
  ``chol_factorize(W=...)`` (one O(n³) Cholesky, never a pass over S).

The solve always uses the current S for its two passes; only W may go
stale, and the drift check bounds that. Over a mesh S comes as a
``core.distributed.ShardedScores``: a refresh is one ``gram_sv`` a
column slab and a ``psum`` (W and u in one pass), a hit one ``sv_cross``
a slab against the cached W; the Cholesky, the substitution and W stay
replicated, and each slab's x is its ``ngd_apply``.
``StreamingCurvature.solve`` is
pure in its ``CurvatureState`` (the cached W, an ``age`` and the
``CurvatureStats`` counters); ``CurvatureCache`` holds the state and is
the one that mutates. The reference's ``lax.cond`` branches are Python
branches here, and ``age`` and the counters are host numbers, as in
``ServeState``. The drift check reads its residual to the host once per
solve: the branch on it is the reference's semantics.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.damping import auto_drift_tol
from repro_torch.core.device import resolve_device
from repro_torch.core.operator import is_blocked, materialize
from repro_torch.core.solvers import (chol_factorize, gram, real_scalar,
                                      residual)

__all__ = ["CurvatureStats", "CurvatureState", "StreamingCurvature",
           "CurvatureCache"]

# the reference's initial age, int32 max − 1: the first solve refreshes
AGE_SATURATED = 2 ** 31 - 2


class CurvatureStats(NamedTuple):
    """Counters of the cache policy."""
    hits: int = 0                 # steps served by the cached W
    refreshes: int = 0            # full Gram recomputations
    last_residual: float = -1.0   # last drift-check relative residual (−1: off)


class CurvatureState(NamedTuple):
    """What the policy carries from one solve to the next."""
    W: torch.Tensor               # cached undamped Gram (n, n)
    age: int                      # steps since the last refresh
    stats: CurvatureStats


class StreamingCurvature:
    """Refresh policy for the cached damped-Fisher factorization.

    Args:
      n: dual-space dimension of the Gram (the per-step sample count;
        twice it for realified complex scores).
      refresh_every: scheduled full-refresh period T (≥ 1); 1 is the
        exact per-step method.
      drift_tol: optional static relative-residual bound; exceeded →
        refresh now. Overrides ``drift_frac`` when both are set.
      drift_frac: optional autotuned bound, ``auto_drift_tol(damping_state,
        frac=drift_frac)`` per solve (ratio 1 without a ``DampingState``).
      jitter: extra diagonal on the damped system (as in ``chol_solve``).
      mode: "real" (default) or "complex".
      dtype: accumulator dtype floor.
      device: where ``init`` puts the placeholder W; CUDA unless the
        caller asks for another (the first solve replaces it by a Gram on
        the scores' device).
    """

    def __init__(self, n: int, *, refresh_every: int = 10,
                 drift_tol: Optional[float] = None,
                 drift_frac: Optional[float] = None, jitter: float = 0.0,
                 mode: str = "real", dtype: torch.dtype = torch.float32,
                 device=None):
        if refresh_every < 1:
            raise ValueError("refresh_every must be >= 1")
        if drift_frac is not None and drift_frac <= 0:
            raise ValueError("drift_frac must be positive")
        if mode not in ("real", "complex"):
            raise ValueError(
                f"mode must be 'real' or 'complex', got {mode!r} "
                "(for real_part, realify the scores and double n)")
        floor = torch.complex64 if mode == "complex" else torch.float32
        self.n = int(n)
        self.refresh_every = int(refresh_every)
        self.drift_tol = None if drift_tol is None else float(drift_tol)
        self.drift_frac = None if drift_frac is None else float(drift_frac)
        self.jitter = float(jitter)
        self.mode = mode
        self.acc_dtype = torch.promote_types(dtype, floor)
        self.device = device

    def init(self) -> CurvatureState:
        """Fresh state; ``age`` starts saturated so the first solve always
        computes a real Gram (the zero W is never used)."""
        return CurvatureState(
            W=torch.zeros((self.n, self.n), dtype=self.acc_dtype,
                          device=resolve_device(self.device)),
            age=AGE_SATURATED, stats=CurvatureStats())

    def effective_drift_tol(self, damping_state=None) -> Optional[float]:
        """The live drift threshold, rounded to fp32 as the reference holds
        it: the static ``drift_tol`` if set, else the ``drift_frac``
        autotune against ``damping_state``, else None (check off)."""
        if self.drift_tol is not None:
            return real_scalar(self.drift_tol, torch.float32)
        if self.drift_frac is not None:
            return float(auto_drift_tol(damping_state, frac=self.drift_frac))
        return None

    def solve(self, S, v, damping, state: CurvatureState, *,
              damping_state=None):
        """x ≈ (SᵀS + λI)⁻¹v under the cached-W policy; returns
        (x, state'). S dense or blocked; v flat, (m, k) or blocked, echoed
        back in the same form. ``state`` is not modified. With a drift
        bound the residual is read to the host (one sync per solve). A
        ``ShardedScores`` runs per slab on the kernels (real mode only).
        """
        # imported here: kernels.ref imports this package, and
        # core.distributed imports the kernels
        from repro_torch.core.distributed import ShardedScores
        if isinstance(S, ShardedScores):
            return self._solve_sharded(S, v, damping, state, damping_state)
        S = materialize(S)
        if S.dtype.is_complex and self.mode != "complex":
            raise ValueError(
                "complex scores need StreamingCurvature(mode='complex') — "
                f"this policy was built with mode={self.mode!r}")
        tgt = torch.promote_types(S.dtype, torch.float32)
        S = S.astype(tgt) if is_blocked(S) else S.to(tgt)
        lam = real_scalar(damping, torch.float32)

        def fresh_gram():
            return gram(S, mode=self.mode).to(self.acc_dtype)

        def dual_solve(W):
            # the with_damping identity: the cached undamped W re-damped at
            # the current λ, through the same hook as the exact path
            return chol_factorize(S, lam, W=W, mode=self.mode,
                                  jitter=self.jitter).solve(v)

        refresh_due = state.age >= self.refresh_every
        W1 = fresh_gram() if refresh_due else state.W
        x = dual_solve(W1)

        tol = self.effective_drift_tol(damping_state)
        if tol is None:
            refreshed, W2, r = refresh_due, W1, -1.0
        else:
            r = float(residual(S, v, x, lam, mode=self.mode)
                      .to(torch.float32))
            drift = not refresh_due and r > tol
            W2 = fresh_gram() if drift else W1
            if drift:
                x = dual_solve(W2)
            refreshed = refresh_due or drift

        return x, self._advance(state, W2, refreshed, r)

    def _solve_sharded(self, S, v, damping, state: CurvatureState,
                       damping_state):
        """``solve`` over column slabs: the same policy, the Gram and the
        solve per slab (``ShardedScores.solve_with_gram``)."""
        if self.mode != "real":
            raise ValueError("the sharded curvature policy is real-only, "
                             "as the kernels")
        lam = real_scalar(damping, torch.float32)

        def dual_solve(W):
            return S.solve_with_gram(v, lam, W=W, jitter=self.jitter)

        refresh_due = state.age >= self.refresh_every
        x, W1 = dual_solve(None if refresh_due else state.W)
        tol = self.effective_drift_tol(damping_state)
        if tol is None:
            refreshed, W2, r = refresh_due, W1, -1.0
        else:
            r = float(S.residual(v, x, lam).to(torch.float32))
            drift = not refresh_due and r > tol
            x, W2 = dual_solve(None) if drift else (x, W1)
            refreshed = refresh_due or drift
        return x, self._advance(state, W2.to(self.acc_dtype), refreshed, r)

    @staticmethod
    def _advance(state: CurvatureState, W, refreshed: bool,
                 r: float) -> CurvatureState:
        stats = CurvatureStats(
            hits=state.stats.hits + int(not refreshed),
            refreshes=state.stats.refreshes + int(refreshed),
            last_residual=r)
        return CurvatureState(W=W, age=1 if refreshed else state.age + 1,
                              stats=stats)


class CurvatureCache:
    """Stateful wrapper: ``solve`` replaces the held state — the amortized
    drop-in for a per-step ``chol_solve`` (benchmarks, interactive use).
    ``registry`` (``repro_torch.obs.MetricsRegistry``): the reference's
    curvature series after every solve — ``curvature.cache_hits`` and
    ``curvature.refreshes`` counters, ``curvature.factor_age`` and
    ``curvature.last_drift_residual`` gauges — and the audit's
    ``curvature.condest`` / ``curvature.factor_residual``; all host
    numbers of the state, no device read."""

    def __init__(self, policy: StreamingCurvature, *, registry=None):
        self.policy = policy
        self.state = policy.init()
        self.registry = registry

    def solve(self, S, v, damping, *, damping_state=None):
        x, self.state = self.policy.solve(S, v, damping, self.state,
                                          damping_state=damping_state)
        if self.registry is not None:
            st = self.state
            self.registry.counter("curvature.cache_hits").value = \
                st.stats.hits
            self.registry.counter("curvature.refreshes").value = \
                st.stats.refreshes
            self.registry.gauge("curvature.factor_age").set(st.age)
            self.registry.gauge("curvature.last_drift_residual").set(
                st.stats.last_residual)
        return x

    def audit(self, S, damping, *, iters: int = 2, probes: int = 2,
              step: int = 0) -> dict:
        """Audit of the cached W at λ = ``damping``: the Hager/Higham
        condition estimate and a Hutchinson residual probe of the freshly
        damped factor (``repro_torch.curvature.audit``), read to the host
        and mirrored into the registry; priced like one extra solve."""
        from repro_torch.curvature.audit import audit_factor
        S = materialize(S)
        lam = real_scalar(damping, torch.float32)
        fac = chol_factorize(S, lam, W=self.state.W, mode=self.policy.mode,
                             jitter=self.policy.jitter)
        res = audit_factor(fac.W, fac.L, lam, iters=iters, probes=probes,
                           step=step)
        out = {"condest": float(res.condest),
               "residual": float(res.residual)}
        if self.registry is not None:
            self.registry.gauge("curvature.condest").set(out["condest"])
            self.registry.gauge(
                "curvature.factor_residual").set(out["residual"])
        return out

    @property
    def stats(self) -> CurvatureStats:
        return self.state.stats

    def reset(self) -> None:
        self.state = self.policy.init()
