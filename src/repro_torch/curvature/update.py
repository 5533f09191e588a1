"""Rank-k Cholesky update and downdate — the streaming-curvature primitive.

Port of ``repro/curvature/update.py``. For L = chol(W) and X : (n, k):

* ``chol_update(L, X)``    →  L' with  L'·L'† = L·L† + X·X†
* ``chol_downdate(L, X)``  →  L' with  L'·L'† = L·L† − X·X†

in two methods that give the same factor to rounding: ``"composed"``
(P = L⁻¹X; L' = L·chol(Ĩ ± P·P†), the default) and ``"rotations"`` (the
LINPACK sweep of plane rotations, hyperbolic for the downdate). Both are
complex-Hermitian aware. ``DowndateAux`` reports the breakdown margin
exactly as the reference computes it: 1 − σ_max(P)² for the composed
method, the minimum relative pivot margin for the rotations.

``replace_factors`` splits a symmetric row/col replacement of W (the
sliding sample window) into one PSD update part and one PSD downdate part
through a 2k×2k core; ``signed_split`` does that split.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.operator import acc_dtype
from repro_torch.core.solvers import cholesky

__all__ = ["DowndateAux", "chol_update", "chol_downdate", "chol_append",
           "chol_drop_leading", "replace_factors", "signed_split"]


class DowndateAux(NamedTuple):
    """Breakdown diagnostics from one downdate (0-d tensors).

    ``margin``: worst relative positive-definiteness margin — for the
    rotation sweep min_j (a_j² − ‖b_j‖²)/a_j² before the clamp, for the
    composed method 1 − λ_max(P†P). ``min_pivot``: the raw minimum pivot²
    (rotations) or the margin again (composed). ``clamped``: the pivot fell
    to the clamp floor (rotations) or the margin to ≤ 0 (composed).
    """
    margin: torch.Tensor
    min_pivot: torch.Tensor
    clamped: torch.Tensor


def _promote(A) -> torch.Tensor:
    A = torch.as_tensor(A)
    return A.to(acc_dtype(A.dtype))


def _as_cols(X, n: int) -> torch.Tensor:
    X = torch.as_tensor(X)
    if X.ndim == 1:
        X = X[:, None]
    if X.shape[0] != n:
        raise ValueError(f"update columns have {X.shape[0]} rows, factor "
                         f"has n={n}")
    return X


def _common(L, X):
    L = _promote(L)
    X = _as_cols(X, L.shape[0])
    dtype = torch.promote_types(L.dtype, X.dtype)
    return L.to(dtype), X.to(dtype)


def _rank1(L: torch.Tensor, x: torch.Tensor, *, sign: int, eps: float,
           aux: bool = False):
    """One plane-rotation sweep: L' with L'·L'† = L·L† ± x·x†. With
    ``aux`` (sign < 0) also the (min relative margin, min raw pivot²)."""
    n = L.shape[0]
    L = L.clone()
    x = x.clone()
    rdtype = L.real.dtype
    m_rel = torch.full((), float("inf"), dtype=rdtype, device=L.device)
    m_raw = m_rel.clone()
    tiny = torch.finfo(rdtype).tiny
    for j in range(n):
        col = L[:, j].clone()
        a = col[j].real
        b = x[j]
        bb = (b * b.conj()).real if L.is_complex() else b * b
        pre = a * a + sign * bb
        if aux:
            rel = pre / torch.clamp_min(a * a, tiny)
            # comparison-based min: once a pivot breaks down the rest of the
            # sweep turns NaN, and minimum() would let that NaN erase the
            # negative margin that explains it
            m_rel = torch.where(rel < m_rel, rel, m_rel)
            m_raw = torch.where(pre < m_raw, pre, m_raw)
        r = torch.sqrt(torch.clamp_min(pre, eps))
        c, s = a / r, b / r
        L[:, j] = c * col + sign * s.conj() * x
        x = -s * col + c * x
    return (L, m_rel, m_raw) if aux else L


def _rank_k(L, X, *, sign: int, eps: float, method: str) -> torch.Tensor:
    L, X = _common(L, X)
    if method == "composed":
        n = L.shape[0]
        P = torch.linalg.solve_triangular(L, X, upper=False)
        M = torch.eye(n, dtype=L.dtype, device=L.device) + sign * (P @ P.mH)
        return L @ cholesky(M)
    if method != "rotations":
        raise ValueError(f"method must be 'composed' or 'rotations', "
                         f"got {method!r}")
    for c in range(X.shape[1]):
        L = _rank1(L, X[:, c], sign=sign, eps=eps)
    # FMA-contracted backends make the exact a·b − b·a cancellations 1-ulp
    # inexact; pin the strict upper triangle back to zero.
    return torch.tril(L)


def _rank_k_down_aux(L, X, *, eps: float, method: str
                     ) -> Tuple[torch.Tensor, DowndateAux]:
    """Downdate with breakdown diagnostics (see ``DowndateAux``)."""
    L, X = _common(L, X)
    rdtype = L.real.dtype
    if method == "composed":
        n = L.shape[0]
        P = torch.linalg.solve_triangular(L, X, upper=False)
        # min eig of Ĩ − P·P† = 1 − λ_max(P†P): a k×k eig problem
        G = P.mH @ P
        G = (G + G.mH) / 2
        lam_max = torch.linalg.eigvalsh(G)[-1].real.to(rdtype)
        margin = 1.0 - lam_max
        M = torch.eye(n, dtype=L.dtype, device=L.device) - P @ P.mH
        Lp = L @ cholesky(M)
        return Lp, DowndateAux(margin=margin, min_pivot=margin,
                               clamped=margin <= 0.0)
    if method != "rotations":
        raise ValueError(f"method must be 'composed' or 'rotations', "
                         f"got {method!r}")
    inf = torch.full((), float("inf"), dtype=rdtype, device=L.device)
    m_rel, m_raw = inf, inf.clone()
    for c in range(X.shape[1]):
        L, rel, raw = _rank1(L, X[:, c], sign=-1, eps=eps, aux=True)
        m_rel = torch.where(rel < m_rel, rel, m_rel)
        m_raw = torch.where(raw < m_raw, raw, m_raw)
    return torch.tril(L), DowndateAux(margin=m_rel, min_pivot=m_raw,
                                      clamped=m_raw <= eps)


def chol_update(L, X, *, eps: float = 1e-30,
                method: str = "composed") -> torch.Tensor:
    """L' = chol(L·L† + X·X†), X : (n,) or (n, k). Always exists."""
    return _rank_k(L, X, sign=+1, eps=eps, method=method)


def chol_downdate(L, X, *, eps: float = 1e-30, method: str = "composed",
                  return_aux: bool = False):
    """L' = chol(L·L† − X·X†); needs L·L† − X·X† positive definite. The
    rotation sweep clamps near-singular pivots at ``eps``. With
    ``return_aux=True`` returns ``(L', DowndateAux)``."""
    if return_aux:
        return _rank_k_down_aux(L, X, eps=eps, method=method)
    return _rank_k(L, X, sign=-1, eps=eps, method=method)


def chol_append(L, W_cross, W_corner) -> torch.Tensor:
    """Factor of ``[[W, B], [B†, C]]`` given L = chol(W), B (n, k) and C
    (k, k): one triangular solve and one k×k Cholesky."""
    L, B, C = _promote(L), _promote(W_cross), _promote(W_corner)
    dtype = torch.promote_types(torch.promote_types(L.dtype, B.dtype), C.dtype)
    L, B, C = L.to(dtype), B.to(dtype), C.to(dtype)
    n, k = B.shape
    M = torch.linalg.solve_triangular(L, B, upper=False)    # L·M = B
    Lc = cholesky(C - M.mH @ M)
    top = torch.cat([L, torch.zeros((n, k), dtype=dtype, device=L.device)], 1)
    bot = torch.cat([M.mH, Lc], 1)
    return torch.cat([top, bot], 0)


def chol_drop_leading(L, k: int) -> torch.Tensor:
    """Factor of W[k:, k:] given L = chol(W): a rank-k update of L22 by the
    columns of L21."""
    L = _promote(L)
    return chol_update(L[k:, k:], L[k:, :k])


def signed_split(U, core) -> Tuple[torch.Tensor, torch.Tensor]:
    """PSD split of the Hermitian low-rank form ``U·core·U†`` into
    ``X·X† − Y·Y†`` (X, Y : (n, p)) through the eigendecomposition of the
    small (p, p) core.

    The eigendecomposition runs on the host: the core is tiny, and a
    device ``eigh`` would wait on the device for its error check anyway.
    A core already on the CPU costs no transfer (``_fold_window`` moves it
    there together with its finiteness flag, in one read). It runs in
    float64: a fold that retires rows dominating the Gram gives a core
    whose eigenvalues span the square of its condition, and fp32 loses
    the small ones — enough to flip the sign of the downdate's margin
    (rows ×1e3 at λ = 1e-8, n = 8, where the float64 margin is positive
    and below 1e-6: an fp32 split made it negative)."""
    U = _promote(U)
    core = _promote(core).to(U.dtype).cpu()
    core = (core + core.mH) / 2
    wide = torch.complex128 if core.is_complex() else torch.float64
    lam, Q = torch.linalg.eigh(core.to(wide))
    lam = lam.to(U.real.dtype).to(U.device)
    Q = Q.to(U.dtype).to(U.device)
    V = U @ Q
    X = V * torch.sqrt(torch.clamp_min(lam, 0.0))
    Y = V * torch.sqrt(torch.clamp_min(-lam, 0.0))
    return X, Y


def replacement_core(W, new_cols, idx):
    """(U, core, W') of a symmetric row/col replacement of W: ``idx`` (k,)
    rows/cols are replaced by the new Gram columns ``new_cols`` (n, k), and

        Δ = W' − W = U · core · U†,  U = [E  B],  core = [[−C, I], [I, 0]]

    with E = Ĩ[:, idx], B = Δ[:, idx], C = Δ[idx, idx]."""
    W = _promote(W)
    new_cols = _promote(new_cols).to(W.dtype)
    idx = torch.as_tensor(idx, dtype=torch.long, device=W.device)
    n, k = new_cols.shape

    B = new_cols - W[:, idx]                        # Δ[:, idx]
    C = B[idx, :]
    C = (C + C.mH) / 2                              # Hermitize the corner
    E = torch.zeros((n, k), dtype=W.dtype, device=W.device)
    E[idx, torch.arange(k, device=W.device)] = 1.0
    U = torch.cat([E, B], dim=1)                    # (n, 2k)
    eye = torch.eye(k, dtype=W.dtype, device=W.device)
    zero = torch.zeros((k, k), dtype=W.dtype, device=W.device)
    core = torch.cat([torch.cat([-C, eye], 1), torch.cat([eye, zero], 1)], 0)

    Wp = W.clone()
    Wp[:, idx] = new_cols
    Wp[idx, :] = new_cols.mH
    return U, core, Wp


def replace_factors(W, new_cols, idx
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decompose a symmetric row/col replacement of W into (X, Y, W') with
    W' − W = X·X† − Y·Y†, so ``chol_downdate(chol_update(L, X), Y)``
    refreshes the factor at O(n²·k)."""
    U, core, Wp = replacement_core(W, new_cols, idx)
    X, Y = signed_split(U, core)
    return X, Y, Wp
