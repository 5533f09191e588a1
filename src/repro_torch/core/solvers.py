"""Solvers for the damped natural-gradient system (SᵀS + λI) x = v, m ≫ n.

Port of ``repro/core/solvers.py``: Algorithm 1 through the Cholesky factor
of the n×n dual Gram (``chol_solve`` = ``chol_factorize`` →
``CholFactorization`` with ``solve``, ``solve_batch``, ``with_damping``,
``update``/``downdate``) and the baselines the paper compares it with
(``eigh_solve``, ``svd_solve``, ``cg_solve``, ``direct_solve``,
``minsr_solve``), registered in ``SOLVERS``. ``S`` is a dense (n, m)
tensor or a ``BlockedScores`` / ``LazyBlockedScores`` operator; with a
blocked S, ``v`` may be flat or a tuple of per-block pieces and the
solution comes back in the same form. There is no ``precision=``
argument: the package keeps TF32 off for every fp32 matmul, which stands
in for the reference's ``Precision.HIGHEST``. Modes follow the paper's §3:

* ``"real"``      — plain real algorithm (default for real S);
* ``"complex"``   — Hermitian Fisher F = S†S, conjugate transposes;
* ``"real_part"`` — F = Re[S†S] via S ← [Re S; Im S], then real.

λ is held as a Python float rounded to the Gram's real dtype, as the
reference holds a device scalar of that dtype. Factorizations use
``cholesky_ex`` and turn a failed factor into NaN, which is what the
reference's ``jnp.linalg.cholesky`` returns, without a host sync.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Literal, NamedTuple, Optional

import torch

from repro_torch.core.operator import (
    BlockedScores,
    acc_dtype,
    as_blocked_vector,
    block_norm,
    ct,
    is_blocked,
    materialize,
)

Mode = Literal["auto", "real", "complex", "real_part"]

__all__ = ["SOLVERS", "CholFactorization", "SolverStats", "center_scores",
           "cg_solve", "chol_factorize", "chol_solve", "direct_solve",
           "eigh_solve", "get_solver", "gram", "gram_chunked", "minsr_solve",
           "residual", "svd_solve"]


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


def _prepare(S, v, mode: Mode):
    """mode-resolve → realify → promote S and v, dense or blocked."""
    S = materialize(S)
    mode = _resolve_mode(S, mode)
    if mode == "real_part" and S.dtype.is_complex:
        v = _map(lambda b: b.real if b.is_complex() else b, v)
    S, mode = _realify(S, mode)
    S = _promote(S)
    tgt = acc_dtype(S.dtype)
    return S, _map(lambda b: b.to(torch.promote_types(b.dtype, tgt)), v), mode


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


# A low-precision window is widened to its accumulation dtype this many
# columns at a time: bf16 is storage only, and a whole fp32 copy (twice
# the window's bytes) need not fit beside it. Narrower windows, and
# windows already in the accumulation dtype, take one product as before.
UPCAST_CHUNK = 1 << 26


def _upcast_chunks(S, acc):
    """Column ranges of S to widen one at a time: [(0, m)] unless S is
    narrower than ``acc`` and wider than ``UPCAST_CHUNK``."""
    m = S.shape[-1]
    step = m if S.dtype == acc or m <= UPCAST_CHUNK else UPCAST_CHUNK
    return [(j, min(j + step, m)) for j in range(0, m, step)]


def _op_matvec(S, v) -> torch.Tensor:
    if is_blocked(S):
        return S.matvec(v)
    acc = acc_dtype(S.dtype, v.dtype)
    out = None
    for a, b in _upcast_chunks(S, acc):
        part = S[:, a:b].to(acc) @ v[a:b].to(acc)
        out = part if out is None else out + part
    return out


def _op_rmatvec(S, w, *, mode: str):
    if is_blocked(S):
        return S.rmatvec(w, mode=mode)
    acc = acc_dtype(S.dtype, w.dtype)
    w = w.to(acc)
    parts = [ct(S[:, a:b].to(acc), mode) @ w
             for a, b in _upcast_chunks(S, acc)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def center_scores(O: torch.Tensor, *, weights: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """SR centering: S = (O − Ō)/√n (paper §3); with per-sample
    probability ``weights`` (summing to 1), S = √w·(O − Σ w O)."""
    n = O.shape[0]
    if weights is None:
        mean = O.mean(dim=0, keepdim=True)
        rdtype = O.real.dtype if O.is_complex() else O.dtype
        return (O - mean) / torch.tensor(float(n)).sqrt().to(rdtype)
    mean = (weights[:, None] * O).sum(dim=0, keepdim=True)
    return weights.sqrt()[:, None] * (O - mean)


def gram(S, *, mode: str = "real") -> torch.Tensor:
    """W = S·Sᵀ (S·S† in complex mode), fp32+ accumulation; dense or
    blocked (block-wise accumulation, no concatenation)."""
    if is_blocked(S):
        return S.gram(mode=mode)
    S = S.to(acc_dtype(S.dtype))
    return S @ ct(S, mode)


def gram_chunked(S, chunk: int, *, mode: str = "real") -> torch.Tensor:
    """W = S·Sᵀ accumulated over parameter-axis chunks of width ``chunk``:
    the upcast copy of a bf16 S is O(n·chunk), not O(n·m). A blocked
    operator is already chunk-shaped and accumulates block-wise."""
    if is_blocked(S):
        return S.gram(mode=mode)
    n, m = S.shape
    dt = torch.promote_types(S.dtype, torch.complex64) if mode == "complex" \
        else acc_dtype(S.dtype)
    W = torch.zeros((n, n), dtype=dt, device=S.device)
    for j in range(0, m, chunk):
        Sc = S[:, j:j + chunk].to(acc_dtype(S.dtype))
        W = W + Sc @ ct(Sc, mode)
    return W


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
    # a low-precision window is widened as the solve widens it
    Ax = _op_rmatvec(S, _op_matvec(S, x), mode=mode) + damping * x
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
        """Rank-k refresh at O(n²·k): W ← W + cols·cols†, L ← cholupdate
        (``kernels.ops.cholupdate``: the rotation kernel for a real factor
        on CUDA). ``cols`` (n, k) are appended to the held S unless
        ``S_new`` is given."""
        from repro_torch.kernels.ops import cholupdate
        cols = self._cols(cols)
        W = self.W + cols @ ct(cols, self.mode)
        L = cholupdate(self.L, cols, sign=+1)
        if S_new is None:
            S_new = BlockedScores(self.S.blocks + (cols,)) \
                if is_blocked(self.S) else torch.cat([self.S, cols], dim=1)
        return self._replace(S=S_new, W=W, L=L)

    def downdate(self, cols, *, S_new=None) -> "CholFactorization":
        """Rank-k removal: W ← W − cols·cols†, L ← choldowndate. S is kept
        (stale-S approximation) unless ``S_new`` names the shrunken one.
        Through ``kernels.ops.cholupdate`` as ``update``; no margin is
        reported."""
        from repro_torch.kernels.ops import cholupdate
        cols = self._cols(cols)
        W = self.W - cols @ ct(cols, self.mode)
        L = cholupdate(self.L, cols, sign=-1)
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
                   gram_chunk: Optional[int] = None,
                   gram_fn: Optional[Callable] = None,
                   W: Optional[torch.Tensor] = None,
                   jitter: float = 0.0) -> CholFactorization:
    """The O(n²·m) + O(n³) setup of Algorithm 1, done once. ``W``: optional
    precomputed undamped Gram of the prepared S (skips the Gram pass).
    For a dense S, ``gram_fn`` computes the Gram instead (e.g. the
    ``kernels.ops.gram`` kernel), or ``gram_chunk`` accumulates it in
    parameter chunks."""
    S = materialize(S)
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
    elif gram_fn is not None and not is_blocked(S):
        W = gram_fn(S)
    elif gram_chunk is not None and not is_blocked(S):
        W = gram_chunked(S, gram_chunk, mode=resolved)
    else:
        W = gram(S, mode=resolved)
    lam = real_scalar(damping, W.dtype)
    eye = torch.eye(n, dtype=W.dtype, device=W.device)
    L = cholesky(W + real_scalar(lam + jitter, W.dtype) * eye)
    return CholFactorization(S=S, mode=resolved, W=W, L=L, lam=lam,
                             jitter=jitter, take_real_v=take_real_v)


def chol_solve(S, v, damping, *, mode: Mode = "auto",
               gram_chunk: Optional[int] = None,
               gram_fn: Optional[Callable] = None, jitter: float = 0.0,
               return_stats: bool = False):
    """Algorithm 1: (SᵀS + λI) x = v through the Cholesky factor of the
    n×n Gram — W = S Sᵀ + λĨ, L = chol(W), u = S v, w = L⁻ᵀ L⁻¹ u,
    x = (v − Sᵀ w)/λ. ``v`` is (m,) or (m, k), or blocked pieces for a
    blocked S; ``return_stats`` adds a ``SolverStats``. A
    ``core.distributed.ShardedScores`` runs per slab on the kernels
    (``ShardedScores.solve``), with none of the other options."""
    from repro_torch.core.distributed import ShardedScores
    if isinstance(S, ShardedScores):
        if gram_chunk is not None or gram_fn is not None or jitter \
                or return_stats or mode not in ("auto", "real"):
            raise TypeError("a ShardedScores is solved per slab; chol_solve's "
                            "other options are for a whole S")
        return S.solve(v, damping)
    fac = chol_factorize(S, damping, mode=mode, gram_chunk=gram_chunk,
                         gram_fn=gram_fn, jitter=jitter)
    return fac.solve(v, return_stats=return_stats)


chol_solve.takes_sharded = True         # NaturalGradient: no gather first


# ---------------------------------------------------------------------------
# Appendix C baselines
# ---------------------------------------------------------------------------

def _bcast(d: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast an (n,) vector against (n,) or (n, k) operands."""
    return d if like.ndim == 1 else d[:, None]


def _blocked_rhs(S, v):
    """(S, v, blocked, was_flat) with a blocked S materialized and v split."""
    if not is_blocked(S):
        return S, v, False, True
    S = materialize(S)
    v, was_flat = as_blocked_vector(S, v)
    return S, v, True, was_flat


def eigh_solve(S, v, damping, *, mode: Mode = "auto", eps: float = 1e-12):
    """Appendix C "eigh": S Sᵀ = U Σ² Uᵀ, V = Sᵀ U Σ⁻¹,
    x = V (Σ² + λ)⁻¹ Vᵀ v + (v − V Vᵀ v)/λ, eigenvalues clamped at ``eps``.
    V is never formed: Vᵀv and V·y are passes over S."""
    S, v, blocked, was_flat = _blocked_rhs(S, v)
    S, v, mode = _prepare(S, v, mode)
    lam = real_scalar(damping, S.dtype)
    W = gram(S, mode=mode)
    # jnp.linalg.eigh symmetrizes its input
    sig2, U = torch.linalg.eigh((W + ct(W, mode)) / 2)
    sig2 = torch.clamp_min(sig2, eps)
    Utu = ct(U, mode) @ _op_matvec(S, v)
    Vt_v = Utu / _bcast(sig2.sqrt(), Utu)
    core = Vt_v / _bcast(sig2 + lam, Vt_v)

    def back(y):
        return _op_rmatvec(S, U @ (y / _bcast(sig2.sqrt(), y)), mode=mode)

    if blocked:
        x = tuple(c + (vb - r) / lam
                  for vb, c, r in zip(v, back(core), back(Vt_v)))
        return BlockedScores.concat(x) if was_flat else x
    return back(core) + (v - back(Vt_v)) / lam


def _via_dense(solver, S, v, damping, **kw):
    """Oracle route for a blocked S: densify, solve, re-block."""
    S = materialize(S)
    v_blocks, was_flat = as_blocked_vector(S, v)
    x = solver(S.to_dense(), BlockedScores.concat(v_blocks), damping, **kw)
    return x if was_flat else S.split(x)


def svd_solve(S, v, damping, *, mode: Mode = "auto"):
    """Appendix C "svda": thin SVD S = U Σ Vᵀ (Eq. 5),
    x = V (Σ² + λ)⁻¹ Vᵀ v + (v − V Vᵀ v)/λ. A blocked S is densified (this
    baseline is an oracle, not a production path)."""
    if is_blocked(S):
        return _via_dense(svd_solve, S, v, damping, mode=mode)
    S, v, mode = _prepare(S, v, mode)
    lam = real_scalar(damping, S.dtype)
    # On CUDA torch's default SVD (cuSOLVER's Jacobi gesvdj) leaves V's
    # rows orthonormal only to ≈ 3e-4, which (v − V Vᵀv)/λ amplifies: a
    # residual of 0.11 at (512, 100,000), λ = 1e-2, where gesvd gives the
    # CPU's 3.5e-3 (tools/svd_drivers.py).
    _, s, Vt = torch.linalg.svd(S, full_matrices=False,
                                driver="gesvd" if S.is_cuda else None)
    Vt_v = Vt @ v
    core = Vt_v / _bcast(s * s + lam, Vt_v)
    V = ct(Vt, mode)
    return V @ core + (v - V @ Vt_v) / lam


def _vdot_real(x, y) -> torch.Tensor:
    """Σ Re(x)·Re(y) + Im(x)·Im(y) over a tensor or blocked vector (the
    real part that ``jax.scipy.sparse.linalg.cg`` uses)."""
    total = 0.0
    for a, b in zip(x if isinstance(x, tuple) else (x,),
                    y if isinstance(y, tuple) else (y,)):
        total = total + (a.real * b.real).sum()
        if a.is_complex() or b.is_complex():
            total = total + (a.imag * b.imag).sum()
    return total


def _cg(A, b, *, tol: float, maxiter: Optional[int]):
    """Conjugate gradient from x₀ = 0, as ``jax.scipy.sparse.linalg.cg``:
    stop once ‖r‖² ≤ tol²·‖b‖² or after ``maxiter`` (default 10·size)
    iterations. ``b`` is a tensor or a tuple of blocks. One host read of
    the residual norm per iteration."""
    blocked = isinstance(b, tuple)
    lmap = (lambda f, *xs: tuple(f(*t) for t in zip(*xs))) if blocked \
        else (lambda f, *xs: f(*xs))
    pieces = b if blocked else (b,)
    if maxiter is None:
        maxiter = 10 * sum(p.numel() for p in pieces)
    dtype = functools.reduce(torch.promote_types, [p.dtype for p in pieces])
    atol2 = tol ** 2 * float(_vdot_real(b, b))
    x = lmap(torch.zeros_like, b)
    r = p = b
    gamma = _vdot_real(r, r).to(dtype)
    k = 0
    while k < maxiter and float(gamma.real) > atol2:
        Ap = A(p)
        alpha = gamma / _vdot_real(p, Ap).to(dtype)
        x = lmap(lambda xb, pb: xb + alpha * pb, x, p)
        r = lmap(lambda rb, ab: rb - alpha * ab, r, Ap)
        gamma_new = _vdot_real(r, r).to(dtype)
        beta = gamma_new / gamma
        p = lmap(lambda rb, pb: rb + beta * pb, r, p)
        gamma = gamma_new
        k += 1
    return x


def cg_solve(S, v, damping, *, mode: Mode = "auto", tol: float = 1e-8,
             maxiter: Optional[int] = None):
    """Matrix-free conjugate gradient on (SᵀS + λI) x = v, O(n·m) per
    iteration (the paper's §3 iterative baseline). With a blocked S the
    iterates stay blocked."""
    S, v, blocked, was_flat = _blocked_rhs(S, v)
    S, v, mode = _prepare(S, v, mode)
    lam = real_scalar(damping, S.dtype)

    def matvec(p):
        y = _op_rmatvec(S, _op_matvec(S, p), mode=mode)
        if blocked:
            return tuple(yb + lam * pb for yb, pb in zip(y, p))
        return y + lam * p

    x = _cg(matvec, v, tol=tol, maxiter=maxiter)
    return BlockedScores.concat(x) if blocked and was_flat else x


def direct_solve(S, v, damping, *, mode: Mode = "auto"):
    """Naive O(m³): form the m×m damped Fisher and solve it. Small-m oracle;
    a blocked S is densified."""
    if is_blocked(S):
        return _via_dense(direct_solve, S, v, damping, mode=mode)
    S, v, mode = _prepare(S, v, mode)
    lam = real_scalar(damping, S.dtype)
    m = S.shape[1]
    F = ct(S, mode) @ S + lam * torch.eye(m, dtype=S.dtype, device=S.device)
    return torch.linalg.solve(F, v)


def minsr_solve(S, f, damping, *, mode: Mode = "auto"):
    """RVB+23 minSR: x = Sᵀ (S Sᵀ + λĨ)⁻¹ f, which equals
    ``chol_solve(S, Sᵀf, λ)`` (Appendix B). ``f`` is a sample-space vector
    for dense and blocked S alike; a blocked S gives a blocked x."""
    S = materialize(S)
    mode = _resolve_mode(S, mode)
    if mode == "real_part" and S.dtype.is_complex:
        f = f.real if f.is_complex() else f
    S, mode = _realify(S, mode)
    tgt = acc_dtype(S.dtype)
    S = _promote(S)
    f = f.to(torch.promote_types(f.dtype, tgt))
    lam = real_scalar(damping, tgt)
    W = gram(S, mode=mode)
    L = cholesky(W + lam * torch.eye(S.shape[0], dtype=W.dtype,
                                     device=W.device))
    return _op_rmatvec(S, tri_solve(L, f, mode), mode=mode)


SOLVERS: Dict[str, Callable] = {
    "chol": chol_solve,
    "eigh": eigh_solve,
    "svd": svd_solve,
    "cg": cg_solve,
    "direct": direct_solve,
}


def get_solver(name: str) -> Callable:
    try:
        return SOLVERS[name]
    except KeyError:
        raise KeyError(f"unknown solver '{name}'; have {sorted(SOLVERS)}") \
            from None
