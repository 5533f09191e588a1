"""Algorithm 1 — the damped natural-gradient solve (SᵀS + λI) x = v with
m ≫ n, through the Cholesky factor of the n×n dual Gram.

Port of the factorization half of ``repro/core/solvers.py``:
``chol_factorize`` → ``CholFactorization`` (``solve``, ``solve_batch``,
``with_damping``, ``update``/``downdate``). ``S`` is a dense (n, m) tensor
or a ``BlockedScores`` operator. Modes follow the paper's §3:

* ``"real"``      — plain real algorithm (default for real S);
* ``"complex"``   — Hermitian Fisher F = S†S, conjugate transposes;
* ``"real_part"`` — F = Re[S†S] via S ← [Re S; Im S], then real.

λ is held as a Python float rounded to the Gram's real dtype, as the
reference holds a device scalar of that dtype. Factorizations use
``cholesky_ex`` and turn a failed factor into NaN, which is what the
reference's ``jnp.linalg.cholesky`` returns, without a host sync.
"""
from __future__ import annotations

from typing import Literal, NamedTuple, Optional

import torch

from repro_torch.core.operator import (
    BlockedScores,
    acc_dtype,
    as_blocked_vector,
    block_norm,
    ct,
    is_blocked,
)

Mode = Literal["auto", "real", "complex", "real_part"]

__all__ = ["CholFactorization", "SolverStats", "chol_factorize", "gram",
           "residual"]


def _resolve_mode(S, mode: Mode) -> str:
    if mode == "auto":
        return "complex" if S.dtype.is_complex else "real"
    return mode


def _map(fn, v):
    """Apply ``fn`` to a tensor or to each piece of a blocked vector."""
    if isinstance(v, (tuple, list)):
        return tuple(fn(b) for b in v)
    return fn(v)


def _realify(S, mode: str):
    """Apply the paper's real-part SR transform: S ← [Re S; Im S]."""
    if mode == "real_part" and S.dtype.is_complex:
        S = S.realify() if is_blocked(S) else torch.cat([S.real, S.imag], 0)
        return S, "real"
    return S, mode


def _promote(S):
    """Upcast a sub-fp32 window for the dual-space math."""
    tgt = acc_dtype(S.dtype)
    return S.astype(tgt) if is_blocked(S) else S.to(tgt)


def real_scalar(x, dtype: torch.dtype) -> float:
    """``x`` rounded to the real part of ``dtype``, as a Python float."""
    rdtype = torch.empty((), dtype=dtype).real.dtype
    return float(torch.tensor(float(x), dtype=rdtype))


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor (batched over leading dims), row-major as the
    kernels read it (LAPACK and cuSOLVER hand back column-major). A matrix
    that is not positive definite gives NaN, like ``jnp.linalg.cholesky``;
    no host sync (``cholesky_ex`` skips the error check)."""
    L, info = torch.linalg.cholesky_ex(A)
    return L.masked_fill((info != 0)[..., None, None],
                         float("nan")).contiguous()


def tri_solve(L: torch.Tensor, u: torch.Tensor, mode: str) -> torch.Tensor:
    """w = L⁻ᵀ L⁻¹ u (L⁻† in complex mode); u (n,) or (n, k)."""
    vec = u.ndim == 1
    w = u[:, None] if vec else u
    w = torch.linalg.solve_triangular(L, w, upper=False)
    w = torch.linalg.solve_triangular(ct(L, mode), w, upper=True)
    return w[:, 0] if vec else w


def _op_matvec(S, v) -> torch.Tensor:
    if is_blocked(S):
        return S.matvec(v)
    acc = acc_dtype(S.dtype, v.dtype)
    return S.to(acc) @ v.to(acc)


def _op_rmatvec(S, w, *, mode: str):
    if is_blocked(S):
        return S.rmatvec(w, mode=mode)
    acc = acc_dtype(S.dtype, w.dtype)
    return ct(S.to(acc), mode) @ w.to(acc)


def gram(S, *, mode: str = "real") -> torch.Tensor:
    """W = S·Sᵀ (S·S† in complex mode), fp32+ accumulation; dense or
    blocked (block-wise accumulation, no concatenation)."""
    if is_blocked(S):
        return S.gram(mode=mode)
    S = S.to(acc_dtype(S.dtype))
    return S @ ct(S, mode)


class SolverStats(NamedTuple):
    """Diagnostics of ``CholFactorization.solve(..., return_stats=True)``."""
    residual_norm: torch.Tensor     # ‖(SᵀS+λI)x − v‖ / ‖v‖
    gram_cond_proxy: torch.Tensor   # max/min diagonal of W + λĨ


def residual(S, v, x, damping, *, mode: str = "real") -> torch.Tensor:
    """Relative residual of the damped system; dense or blocked."""
    if is_blocked(S):
        v_blocks, _ = as_blocked_vector(S, v)
        x_blocks, _ = as_blocked_vector(S, x)
        y = S.rmatvec(S.matvec(x_blocks), mode=mode)
        r = tuple(yb + damping * xb - vb
                  for yb, xb, vb in zip(y, x_blocks, v_blocks))
        return block_norm(r) / block_norm(v_blocks)
    Ax = ct(S, mode) @ (S @ x) + damping * x
    return torch.linalg.norm(Ax - v) / torch.linalg.norm(v)


class CholFactorization:
    """Reusable Cholesky factorization of the dual system (Algorithm 1).

    Holds the prepared S (realified, promoted; dense or blocked), the
    *undamped* Gram W and L = chol(W + (λ+jitter)Ĩ), so ``solve`` costs two
    passes over S plus two n×n triangular solves, and ``with_damping``
    re-factors the cached W at O(n³) without touching S.
    """

    def __init__(self, *, S, mode: str, W: torch.Tensor, L: torch.Tensor,
                 lam: float, jitter: float, take_real_v: bool):
        self.S = S
        self.mode = mode
        self.W = W
        self.L = L
        self.lam = lam
        self.jitter = jitter
        self._take_real_v = take_real_v

    @property
    def n(self) -> int:
        return self.W.shape[0]

    def _eye(self) -> torch.Tensor:
        return torch.eye(self.n, dtype=self.W.dtype, device=self.W.device)

    def with_damping(self, damping, *, jitter: Optional[float] = None
                     ) -> "CholFactorization":
        """New factorization at a different λ, reusing the cached Gram."""
        jit_ = self.jitter if jitter is None else jitter
        lam = real_scalar(damping, self.W.dtype)
        L = cholesky(self.W + real_scalar(lam + jit_, self.W.dtype) * self._eye())
        return CholFactorization(S=self.S, mode=self.mode, W=self.W, L=L,
                                 lam=lam, jitter=jit_,
                                 take_real_v=self._take_real_v)

    def _replace(self, *, S, W, L) -> "CholFactorization":
        return CholFactorization(S=S, mode=self.mode, W=W, L=L, lam=self.lam,
                                 jitter=self.jitter,
                                 take_real_v=self._take_real_v)

    def _cols(self, cols) -> torch.Tensor:
        cols = torch.as_tensor(cols)
        if cols.ndim == 1:
            cols = cols[:, None]
        return cols.to(self.S.dtype)

    def update(self, cols, *, S_new=None) -> "CholFactorization":
        """Rank-k refresh at O(n²·k): W ← W + cols·cols†, L ← cholupdate.
        ``cols`` (n, k) are appended to the held S unless ``S_new`` is
        given."""
        from repro_torch.curvature.update import chol_update
        cols = self._cols(cols)
        W = self.W + cols @ ct(cols, self.mode)
        L = chol_update(self.L, cols)
        if S_new is None:
            S_new = BlockedScores(self.S.blocks + (cols,)) \
                if is_blocked(self.S) else torch.cat([self.S, cols], dim=1)
        return self._replace(S=S_new, W=W, L=L)

    def downdate(self, cols, *, S_new=None) -> "CholFactorization":
        """Rank-k removal: W ← W − cols·cols†, L ← choldowndate. S is kept
        (stale-S approximation) unless ``S_new`` names the shrunken one."""
        from repro_torch.curvature.update import chol_downdate
        cols = self._cols(cols)
        W = self.W - cols @ ct(cols, self.mode)
        L = chol_downdate(self.L, cols)
        return self._replace(S=self.S if S_new is None else S_new, W=W, L=L)

    def _prep_v(self, v):
        if self._take_real_v:
            v = _map(lambda b: b.real if b.is_complex() else b, v)
        tgt = acc_dtype(self.S.dtype)
        return _map(lambda b: b.to(torch.promote_types(b.dtype, tgt)), v)

    def solve(self, v, *, return_stats: bool = False):
        """x = (SᵀS + λI)⁻¹ v:  u = S v ; w = L⁻ᵀ L⁻¹ u ; x = (v − Sᵀ w) / λ."""
        blocked = is_blocked(self.S)
        if blocked:
            v_in, was_flat = as_blocked_vector(self.S, v)
            v_in = self._prep_v(v_in)
        else:
            v_in, was_flat = self._prep_v(v), True

        u = _op_matvec(self.S, v_in)
        w = tri_solve(self.L, u, self.mode)
        y = _op_rmatvec(self.S, w, mode=self.mode)
        if blocked:
            x = tuple((vb - yb) / self.lam for vb, yb in zip(v_in, y))
            x_out = BlockedScores.concat(x) if was_flat else x
        else:
            x = (v_in - y) / self.lam
            x_out = x

        if not return_stats:
            return x_out
        r = residual(self.S, v_in, x, self.lam, mode=self.mode)
        diag = torch.diagonal(self.W).real + self.lam + self.jitter
        stats = SolverStats(residual_norm=r,
                            gram_cond_proxy=diag.max() / diag.min())
        return x_out, stats

    def solve_batch(self, V, dampings, *, jitter: Optional[float] = None):
        """x_j = (SᵀS + λ_j I)⁻¹ v_j with per-column damping, one pass over
        S each way: U = S·V; L_j = chol(W + (λ_j+jitter)Ĩ) batched;
        w_j = L_j⁻ᵀ L_j⁻¹ u_j; x_j = (v_j − (Sᵀ w)_j) / λ_j."""
        jit_ = self.jitter if jitter is None else jitter
        blocked = is_blocked(self.S)
        if blocked:
            v_in, was_flat = as_blocked_vector(self.S, V)
            v_in = self._prep_v(v_in)
            k = v_in[0].shape[1]
        else:
            v_in, was_flat = self._prep_v(V), True
            if v_in.ndim != 2:
                raise ValueError(
                    f"solve_batch takes an (m, k) batch of RHS columns, "
                    f"got shape {tuple(v_in.shape)}")
            k = v_in.shape[1]
        rdtype = self.W.real.dtype
        lams = torch.as_tensor(dampings, dtype=rdtype).reshape(-1).to(
            self.W.device)
        if lams.shape[0] != k:
            raise ValueError(f"{lams.shape[0]} dampings for {k} RHS columns")

        Wd = self.W[None] + (lams + real_scalar(jit_, rdtype))[:, None, None] \
            * self._eye()
        Ls = cholesky(Wd)                                         # (k, n, n)
        u = _op_matvec(self.S, v_in)                              # (n, k)
        w = torch.linalg.solve_triangular(Ls, u.mT[..., None], upper=False)
        w = torch.linalg.solve_triangular(ct(Ls, self.mode), w, upper=True)
        w = w[..., 0].mT                                          # (n, k)
        y = _op_rmatvec(self.S, w, mode=self.mode)
        if blocked:
            x = tuple((vb - yb) / lams[None, :] for vb, yb in zip(v_in, y))
            return BlockedScores.concat(x) if was_flat else x
        return (v_in - y) / lams[None, :]


def chol_factorize(S, damping, *, mode: Mode = "auto",
                   W: Optional[torch.Tensor] = None,
                   jitter: float = 0.0) -> CholFactorization:
    """The O(n²·m) + O(n³) setup of Algorithm 1, done once. ``W``: optional
    precomputed undamped Gram of the prepared S (skips the Gram pass)."""
    orig_complex = S.dtype.is_complex
    resolved = _resolve_mode(S, mode)
    take_real_v = resolved == "real_part" and orig_complex
    S, resolved = _realify(S, resolved)
    S = _promote(S)

    n = S.shape[0]
    if W is not None:
        W = torch.as_tensor(W)
        if tuple(W.shape) != (n, n):
            raise ValueError(f"precomputed Gram is {tuple(W.shape)}, prepared "
                             f"S needs ({n}, {n})")
    else:
        W = gram(S, mode=resolved)
    lam = real_scalar(damping, W.dtype)
    eye = torch.eye(n, dtype=W.dtype, device=W.device)
    L = cholesky(W + real_scalar(lam + jitter, W.dtype) * eye)
    return CholFactorization(S=S, mode=resolved, W=W, L=L, lam=lam,
                             jitter=jitter, take_real_v=take_real_v)
