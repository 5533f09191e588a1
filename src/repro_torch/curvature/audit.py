"""Cheap online audits of the resident damped-Fisher factor.

Port of ``repro/curvature/audit.py``. The factor L is maintained through
many rank-k folds between refactorizations, and that is how its
conditioning and drift decay silently. These probes put numbers on both
without a refactorization and without the O(n²·m) Gram pass:

* ``condest`` — Hager/Higham 1-norm condition estimate of A = W + λĨ:
  ‖A‖₁ exactly from the resident Gram, ‖A⁻¹‖₁ estimated by a few
  A⁻¹-applications, two triangular solves through L each (O(n²)). A
  lower bound, almost always within a small factor of the truth.
* ``factor_residual_probe`` — Hutchinson probe of the factor's drift:
  for Rademacher z, z†(L·L† − W − λĨ)z relative to z†(W + λĨ)z.
* ``audit_factor`` — both at once.

The probes are drawn from a ``torch.Generator`` seeded from ``0x5EED``
and ``step``, so an audit is deterministic and the same on every device.
They are not the bits of the reference's ``jax.random`` key (no JAX here):
the arithmetic on given probes (``_probe_residual``) is what matches the
reference. Nothing here reads a value back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["FactorAudit", "audit_factor", "condest", "factor_residual_probe",
           "invnorm1_est"]

PROBE_SEED = 0x5EED


class FactorAudit(NamedTuple):
    """One audit pass over the resident factor (0-d tensors)."""

    condest: torch.Tensor    # 1-norm condition estimate of W + λĨ
    residual: torch.Tensor   # relative Hutchinson estimate of ‖LL† − W − λĨ‖


def _rdtype(t: torch.Tensor) -> torch.dtype:
    return t.real.dtype if t.is_complex() else t.dtype


def _solve_gram(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L·L†)⁻¹·b by two triangular solves — O(n²) per column."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mH, y, upper=True)


def _sign_like(y: torch.Tensor) -> torch.Tensor:
    if y.is_complex():
        return y / torch.clamp_min(y.abs(), torch.finfo(_rdtype(y)).tiny)
    return torch.where(y >= 0, 1.0, -1.0).to(y.dtype)


def invnorm1_est(L: torch.Tensor, *, iters: int = 2) -> torch.Tensor:
    """Hager power-iteration estimate of ‖(L·L†)⁻¹‖₁: 4·iters + 2
    triangular solves, O(n²) each. A lower bound, in practice within a
    small factor of the truth (Higham 1988)."""
    L = torch.as_tensor(L)
    n = L.shape[0]
    rdtype = _rdtype(L)
    rows = torch.arange(n, device=L.device)[:, None]
    x = torch.full((n, 1), 1.0 / n, dtype=L.dtype, device=L.device)
    est = torch.zeros((), dtype=rdtype, device=L.device)
    for _ in range(iters):
        y = _solve_gram(L, x)
        est = torch.maximum(est, y.abs().sum().to(rdtype))
        z = _solve_gram(L, _sign_like(y))
        # e_j at j = argmax |z|, built on the device (no host read of j)
        x = (rows == z.abs().argmax()).to(L.dtype)
    y = _solve_gram(L, x)                     # evaluate at the final e_j
    return torch.maximum(est, y.abs().sum().to(rdtype))


def condest(W: torch.Tensor, L: torch.Tensor, lam, *,
            iters: int = 2) -> torch.Tensor:
    """1-norm condition estimate of A = W + λĨ given its resident factor:
    ‖A‖₁ exact (max absolute column sum, O(n²)) times
    ``invnorm1_est``. A lower bound on κ₁(A)."""
    W = torch.as_tensor(W)
    n = W.shape[0]
    lam = torch.as_tensor(lam, dtype=_rdtype(W), device=W.device)
    eye = torch.eye(n, dtype=W.dtype, device=W.device)
    colsums = (W + lam * eye).abs().sum(dim=0)
    return colsums.max() * invnorm1_est(L, iters=iters)


def _probes(n: int, probes: int, step, dtype: torch.dtype,
            device) -> torch.Tensor:
    """(n, probes) Rademacher ±1, from a CPU generator seeded from
    ``PROBE_SEED`` and ``step``: the same signs on every device."""
    g = torch.Generator().manual_seed((PROBE_SEED << 32) + int(step))
    z = torch.randint(0, 2, (n, probes), generator=g).mul_(2).sub_(1)
    return z.to(device=device, dtype=dtype)


def _probe_residual(W: torch.Tensor, L: torch.Tensor, lam,
                    z: torch.Tensor) -> torch.Tensor:
    """max over the columns of z of |z†LL†z − z†Wz − λ‖z‖²| relative to
    |z†Wz + λ‖z‖²|, for given ±1 probes z (so ‖z‖² = n)."""
    rdtype = _rdtype(W)
    lam = torch.as_tensor(lam, dtype=rdtype, device=W.device)
    n = W.shape[0]
    z = z.to(device=W.device, dtype=W.dtype)
    Ltz = L.mH @ z                                        # (n, probes)
    quad_f = (Ltz.conj() * Ltz).real.sum(dim=0)           # z†LL†z
    quad_w = (z.conj() * (W @ z)).real.sum(dim=0) + lam * n
    tiny = torch.finfo(rdtype).tiny
    rel = (quad_f - quad_w).abs() / torch.clamp_min(quad_w.abs(), tiny)
    return rel.max().to(rdtype)


def factor_residual_probe(W: torch.Tensor, L: torch.Tensor, lam, *,
                          probes: int = 2, step: int = 0) -> torch.Tensor:
    """Relative Hutchinson probe of z†(L·L† − W − λĨ)z over ``probes``
    Rademacher vectors seeded by ``step`` — a drift meter for the
    incremental factor, O(n²) per probe."""
    W = torch.as_tensor(W)
    z = _probes(W.shape[0], probes, step, _rdtype(W), W.device)
    return _probe_residual(W, torch.as_tensor(L), lam, z)


def audit_factor(W: torch.Tensor, L: torch.Tensor, lam, *, iters: int = 2,
                 probes: int = 2, step: int = 0) -> FactorAudit:
    """Condition estimate and drift probe in one pass: a handful of O(n²)
    matvecs and solves, about the price of one served request."""
    return FactorAudit(
        condest=condest(W, L, lam, iters=iters),
        residual=factor_residual_probe(W, L, lam, probes=probes, step=step))
