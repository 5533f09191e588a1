"""``TenantDelta`` — one tenant's curvature as a rank-r dual-space delta.

Port of ``repro/tenants/delta.py``. Every tenant shares one resident base
``ServeState`` (window S, Gram W, factor L) and owns only r dual-space
columns. A tenant's curvature is the shared window reweighted in dual
space,

    F_t = λ·I + Sᵀ·(Ĩ + P·diag(s)·P†)·S,        P : (n, r), s ∈ {±1, 0},

i.e. the private window ``[S; P†S]`` without its O(n·m) rows. With
M = Ĩ + P·diag(s)·P† the Woodbury push-through gives

    F_t⁻¹ v = (v − Sᵀ·w)/λ,     (W + λ·M⁻¹)·w = S·v,

and W + λM⁻¹ = (W + λĨ) − λ·P·(diag(s)⁻¹ + P†P)⁻¹·P†: the base damped Gram
minus a rank-r Hermitian form. The eigendecomposition of its r×r core
(``delta_correction``) turns the tenant factor into one rank-r update and
one rank-r downdate of the base L: ``delta_factor`` by the plain composed
method, ``tenant_factorization`` through ``CholFactorization.update`` /
``.downdate``, which on CUDA run the rotation kernel
(``kernels.ops.cholupdate``). A tenant that adds curvature (s = +1)
downdates the dual factor.

A fold projects the tenant's score rows onto the window's row space
through the resident factor (``project_rows``, the ridge projection
q = (W + λ₀Ĩ)⁻¹·S·g†) and writes the columns FIFO into the fixed rank
budget (``delta_fold``). Folds are fixed-shape functions of the stored
columns, so replaying the same columns gives the same delta bit for bit.
``cursor`` and ``age`` are host integers, as ``ServeState``'s scalars.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.operator import ct, is_blocked
from repro_torch.core.solvers import CholFactorization
from repro_torch.curvature.update import chol_downdate, chol_update
from repro_torch.serve.state import ServeState, as_factorization, serve_mode

__all__ = ["TenantDelta", "init_tenant_delta", "project_rows", "delta_fold",
           "delta_correction", "delta_factor", "tenant_factorization",
           "augmented_window", "delta_nbytes"]

_EMPTY = 1e30          # core eigenvalue sentinel for unfilled budget slots
_SCALAR_BYTES = 4      # cursor and age, int32 in the reference's format


class TenantDelta(NamedTuple):
    """One tenant's resident state.

    ``cols``: the (n, r) dual-space delta columns P, zero where a budget
    slot is unfilled. ``signs``: (r,) fp32 in {+1, −1, 0}: +1 adds the
    projected sample's curvature, −1 subtracts it, 0 marks an empty slot.
    ``cursor``: next FIFO slot. ``age``: folds applied since creation.
    """
    cols: torch.Tensor
    signs: torch.Tensor
    cursor: int
    age: int

    @property
    def rank(self) -> int:
        return self.cols.shape[1]

    @property
    def filled(self) -> int:
        return int((self.signs != 0).sum())


def init_tenant_delta(n: int, rank: int, *, dtype=torch.float32,
                      device=None) -> TenantDelta:
    """An empty delta on ``device`` (CUDA unless the caller asks for
    another): the tenant solves exactly like the base until its first
    fold. ``rank`` is the tenant's whole memory budget, r ≪ m."""
    if rank < 1:
        raise ValueError("tenant rank budget must be >= 1")
    dev = resolve_device(device)
    return TenantDelta(cols=torch.zeros((n, rank), dtype=dtype, device=dev),
                       signs=torch.zeros((rank,), dtype=torch.float32,
                                         device=dev),
                       cursor=0, age=0)


def _rows2d(r) -> torch.Tensor:
    r = torch.as_tensor(r)
    return r[None, :] if r.ndim == 1 else r


def _sv_pass(S, rows, *, mode: str) -> torch.Tensor:
    """u = S·rows† (n, k): the one m-sized pass of a tenant fold; slab by
    slab on a sharded window (``repro_torch.dist``)."""
    from repro_torch.dist.state import is_sharded
    if is_sharded(S):
        acc = torch.promote_types(S.dtype, torch.float32)
        rows = tuple(_rows2d(r) for r in rows) \
            if isinstance(rows, (tuple, list)) else _rows2d(rows)
        return S.cross(rows, lambda b, r: b.to(acc) @ ct(r, mode).to(acc))
    row_blocks = tuple(rows) if isinstance(rows, (tuple, list)) else (rows,)
    S_blocks = S.blocks if is_blocked(S) else (S,)
    acc = torch.promote_types(S_blocks[0].dtype, torch.float32)
    u = None
    for b, r in zip(S_blocks, row_blocks):
        r = torch.as_tensor(r)
        if r.ndim == 1:
            r = r[None, :]
        ub = b.to(acc) @ ct(r, mode).to(acc)
        u = ub if u is None else u + ub
    return u


def project_rows(state: ServeState, rows, *, jitter: float = 0.0
                 ) -> torch.Tensor:
    """Project tenant score rows (k, m) — dense or per-block pieces — into
    dual space through the resident base factor:

        Q = (W + λ₀Ĩ)⁻¹ · S·rows†  =  L⁻†·L⁻¹·(S·rows†)        (n, k)

    Folding Q gives the tenant the curvature of the projected samples
    Q†S. The columns are what the tenant keeps: replay needs no S pass."""
    del jitter  # the resident L already carries the server's jitter
    mode = serve_mode(state)
    u = _sv_pass(state.S, rows, mode=mode)
    L = state.L.to(torch.promote_types(state.L.dtype, u.dtype))
    q = torch.linalg.solve_triangular(L, u.to(L.dtype), upper=False)
    return torch.linalg.solve_triangular(ct(L, mode), q, upper=True)


def delta_fold(delta: TenantDelta, Q, *, signs=None
               ) -> Tuple[TenantDelta, Tuple[int, ...]]:
    """FIFO-write k projected columns into the rank budget; returns
    (delta', slots) with ``slots`` the budget positions written. Pure:
    ``delta`` is not modified, and the same columns give the same delta."""
    Q = torch.as_tensor(Q)
    if Q.ndim == 1:
        Q = Q[:, None]
    n, k = Q.shape
    r = delta.rank
    if k > r:
        raise ValueError(f"cannot fold {k} columns into a rank-{r} budget")
    if n != delta.cols.shape[0]:
        raise ValueError(f"delta columns have {delta.cols.shape[0]} rows, "
                         f"fold has {n}")
    dev = delta.cols.device
    s = torch.ones((k,), dtype=torch.float32, device=dev) if signs is None \
        else torch.as_tensor(signs, dtype=torch.float32).reshape(k).to(dev)
    slots = tuple((delta.cursor + i) % r for i in range(k))
    idx = torch.tensor(slots, dtype=torch.long, device=dev)
    cols = delta.cols.clone()
    cols[:, idx] = Q.to(device=dev, dtype=cols.dtype)
    new_signs = delta.signs.clone()
    new_signs[idx] = s
    return delta._replace(cols=cols, signs=new_signs,
                          cursor=(delta.cursor + k) % r,
                          age=delta.age + 1), slots


def delta_correction(delta: TenantDelta, lam, *, return_cond: bool = False):
    """The signed factor correction at damping ``lam``: (up, down) with

        (W + λĨ) + up·up† − down·down†  =  W + λ·M⁻¹,

    i.e. ``L_t = chol_downdate(chol_update(L, up), down)``, from the r×r
    core diag(s)⁻¹ + P†P (empty slots pinned at a huge eigenvalue, so
    their columns scale to zero — possibly −0.0). All-(+1) deltas give a
    pure downdate. The core's eigendecomposition runs on the host, as in
    ``curvature.update.signed_split``: its eigenvector signs and the basis
    of a repeated eigenvalue differ between LAPACK builds and devices, so
    compare up·up† − down·down†, not the columns.

    ``return_cond=True`` appends the conditioning of the live core
    spectrum (max |ev| / min |ev| over genuine delta directions, 1.0 for
    an empty delta), a 0-d CPU tensor."""
    P = delta.cols
    rdtype = P.real.dtype if P.is_complex() else P.dtype
    s = delta.signs.to(rdtype)
    d_inv = torch.where(s == 0, torch.full_like(s, _EMPTY), torch.sign(s))
    core = torch.diag(d_inv).to(P.dtype) + P.mH @ P
    core = ((core + core.mH) / 2).cpu()
    ev, V = torch.linalg.eigh(core)
    lam_t = torch.tensor(float(lam), dtype=rdtype)
    live = ev.abs() < (_EMPTY / 1e6)              # genuine delta directions
    scale = torch.where(live, torch.sqrt(lam_t / torch.clamp_min(ev.abs(),
                                                                 1e-30)),
                        0.0)
    C = (P @ V.to(P.device)) * scale.to(P.device)[None, :]
    # 0/1 masks times C, as the reference writes them (0.0·C may be −0.0)
    up = (ev < 0).to(device=P.device, dtype=rdtype)[None, :] * C
    down = (ev > 0).to(device=P.device, dtype=rdtype)[None, :] * C
    if return_cond:
        a = ev.abs()
        mx = torch.where(live, a, 0.0).max()
        mn = torch.where(live, a, float("inf")).min()
        cond = torch.where(torch.isfinite(mn) & (mx > 0),
                           mx / torch.clamp_min(mn, 1e-30),
                           torch.ones((), dtype=rdtype))
        return up, down, cond
    return up, down


def delta_factor(delta: TenantDelta, L: torch.Tensor, lam, *,
                 method: str = "composed", return_cond: bool = False):
    """The tenant's factor from the base factor at O(n²·r), by the plain
    rank-k methods of ``curvature.update`` (not the kernel, as in the
    reference). ``L`` must be the base chol(W + λĨ) at the same ``lam``.
    An empty delta gives a factor equal to L. ``return_cond=True``: also
    the live core conditioning, as ``(L_t, cond)``."""
    if return_cond:
        up, down, cond = delta_correction(delta, lam, return_cond=True)
        return chol_downdate(chol_update(L, up, method=method), down,
                             method=method), cond
    up, down = delta_correction(delta, lam)
    return chol_downdate(chol_update(L, up, method=method), down,
                         method=method)


def tenant_factorization(state: ServeState, delta: TenantDelta, *,
                         jitter: float = 0.0, lam=None,
                         L: Optional[torch.Tensor] = None
                         ) -> CholFactorization:
    """The tenant's view of the shared window as a solver, built through
    ``CholFactorization.update``/``.downdate`` (S kept — the delta never
    touches the window), so on CUDA the correction runs the rotation
    kernel. ``lam`` re-damps from the cached W first (the mixed-λ path);
    ``L`` short-circuits the O(n²·r) correction with a cached factor."""
    fac = as_factorization(state, jitter=jitter)
    if lam is not None and float(lam) != float(state.lam0):
        fac = fac.with_damping(lam)
    if L is not None:
        return fac._replace(S=fac.S, W=fac.W, L=L)
    up, down = delta_correction(delta, fac.lam)
    return fac.update(up, S_new=fac.S).downdate(down, S_new=fac.S)


def augmented_window(state: ServeState, delta: TenantDelta) -> torch.Tensor:
    """The tenant's private window ``[S; P†S]`` — the O((n+r)·m) state the
    delta replaces, for from-scratch reference solves only. Needs a dense
    window and an all-(+1) delta (a down-weighting column is not a row)."""
    if is_blocked(state.S):
        raise NotImplementedError("reference window: dense S only")
    if bool((delta.signs < 0).any()):
        raise ValueError("negative-sign delta has no window equivalent")
    P = delta.cols
    S = state.S.to(torch.promote_types(state.S.dtype, P.dtype))
    extra = ct(P, serve_mode(state)).to(S.dtype) @ S
    return torch.cat([S, extra], dim=0)


def delta_nbytes(delta: TenantDelta) -> int:
    """Resident bytes of the delta — the O(n·r) the platform is for —
    counted as the reference stores it (cursor and age as int32)."""
    return (delta.cols.numel() * delta.cols.element_size()
            + delta.signs.numel() * delta.signs.element_size()
            + 2 * _SCALAR_BYTES)
