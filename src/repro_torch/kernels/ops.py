"""Public wrappers of the kernels, with the reference's ``mode`` dispatch
(``repro/kernels/ops.py``), and ``chol_solve_fused``: Algorithm 1 composed
from the kernels.

``mode``:

* ``None`` — a CUDA tensor takes the hand-written kernel, a CPU tensor
  the plain PyTorch version (``ref``), a meta tensor the kernel's wrapper
  without its launch (the dry run: ``_build.would_launch``);
* ``"ref"`` — the plain version on any device (the card's oracle);
* ``"kernel"`` — the kernel; raises for CPU tensors.

Complex operands take the plain version under every mode, as
``ops._any_complex`` routes them on the TPU (the kernels are real-only).
Beyond that nothing falls back: a CUDA tensor whose kernel fails to
build, launch, or accept its operands raises.

Unlike the JAX wrappers these never pad the window to a tile multiple:
the kernels mask the ragged edge themselves, so no request copies S.

``default_mode(mode)`` is a context in which calls that pass no ``mode``
take ``mode``: ``with default_mode("ref"):`` runs a whole path (a server,
a model) on the plain versions, the card's oracle of the kernel path.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from repro_torch.core.operator import (BlockedScores, as_blocked_vector,
                                       is_blocked, materialize)
from repro_torch.core.solvers import real_scalar
from repro_torch.kernels import cholesky as _chol
from repro_torch.kernels import cholupdate as _cholup
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fold as _fold
from repro_torch.kernels import gram as _gram
from repro_torch.kernels import ngd_apply as _apply
from repro_torch.kernels import ref
from repro_torch.kernels import serve_solve as _serve

__all__ = ["chol_solve_fused", "cholesky", "cholupdate", "default_mode",
           "flash_attention", "fold_cols", "gram", "gram_acc", "gram_blocks",
           "gram_sv", "launch_counts", "ngd_apply", "reset_launch_counts",
           "serve_apply", "serve_solve", "sv_cross", "trisolve"]

_COUNTERS = (_serve.LAUNCHES, _fold.LAUNCHES, _gram.LAUNCHES,
             _chol.LAUNCHES, _apply.LAUNCHES, _cholup.LAUNCHES,
             _flash.LAUNCHES)

MODES = (None, "ref", "kernel")
_DEFAULT_MODE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_kernel_mode", default=None)


@contextlib.contextmanager
def default_mode(mode: Optional[str]):
    """Inside the block, every wrapper called without ``mode`` takes
    ``mode`` (``"ref"``: the plain versions on any device)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    token = _DEFAULT_MODE.set(mode)
    try:
        yield
    finally:
        _DEFAULT_MODE.reset(token)


def _any_complex(*tensors) -> bool:
    return any(t.is_complex() for t in tensors)


def _use_kernel(mode: Optional[str], *tensors) -> bool:
    if mode is None:
        mode = _DEFAULT_MODE.get()
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "ref" or _any_complex(*tensors):
        return False
    # a meta operand (the dry run) takes the wrapper too: it allocates
    # what the kernel's launch allocates and records a would-be launch
    on_card = tensors[0].is_cuda or tensors[0].is_meta
    if mode == "kernel" and not on_card:
        raise RuntimeError("mode='kernel' needs CUDA tensors; the kernels do "
                           "not run on the CPU")
    return on_card


def _cols(V: torch.Tensor) -> tuple[torch.Tensor, bool]:
    return (V[:, None], True) if V.ndim == 1 else (V, False)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {k: v for counts in _COUNTERS for k, v in counts.items()}


def reset_launch_counts() -> None:
    """Zero every wrapper's launch count and the counts by route of the
    Gram (``gram.ROUTES``) and of the streaming passes
    (``serve_solve.ROUTES``)."""
    for counts in _COUNTERS + (_gram.ROUTES, _serve.ROUTES):
        for name in counts:
            counts[name] = 0


def sv_cross(S: torch.Tensor, V: torch.Tensor, *, mode: Optional[str] = None):
    """U = S @ V with fp32(+) accumulation — the serve cross pass over one
    window block."""
    V2, squeeze = _cols(V)
    if _use_kernel(mode, S, V2):
        u = _serve.sv_cross_cuda(S, _f32(V2))
    else:
        u = ref.sv_cross_ref(S, V2)
    return u[:, 0] if squeeze else u


def serve_apply(S: torch.Tensor, w: torch.Tensor, V: torch.Tensor, lam, *,
                mode: Optional[str] = None):
    """X = (V − S†·w)/λ — the multi-RHS apply pass over one window block."""
    V2, squeeze = _cols(V)
    w2 = w[:, None] if w.ndim == 1 else w
    if _use_kernel(mode, S, V2, w2):
        x = _serve.serve_apply_cuda(S, _f32(w2), _f32(V2), float(lam))
    else:
        x = ref.serve_apply_ref(S, w2, V2, lam)
    return x[:, 0] if squeeze else x


def trisolve(L: torch.Tensor, U: torch.Tensor, *, mode: Optional[str] = None):
    """w = L⁻† L⁻¹ U against the resident lower factor."""
    U2, squeeze = _cols(U)
    if _use_kernel(mode, L, U2):
        w = _serve.trisolve_cuda(L, _f32(U2))
    else:
        w = ref.trisolve_ref(L, U2)
    return w[:, 0] if squeeze else w


def serve_solve(S, L: torch.Tensor, V, lam, *, mode: Optional[str] = None):
    """The whole cached uniform-λ request path against a resident factor,

        X = (V − Sᵀ L⁻ᵀ L⁻¹ S V) / λ,

    fp32 (m, k) in the input's flat or blocked form. A dense real window on
    CUDA runs the three-launch kernel chain; a blocked window composes the
    cross, substitution and apply kernels per block."""
    if is_blocked(S) or isinstance(V, (tuple, list)):
        return _serve_solve_blocked(S, L, V, lam, mode=mode)
    V2, squeeze = _cols(V)
    if _use_kernel(mode, S, L, V2):
        x = _serve.serve_solve_cuda(S, L, _f32(V2), float(lam))
    else:
        x = ref.serve_solve_ref(S, L, V2, lam)
    return x[:, 0] if squeeze else x


def _serve_solve_blocked(S: BlockedScores, L, V, lam, *,
                         mode: Optional[str] = None):
    v_blocks, was_flat = as_blocked_vector(S, V)
    u = None
    for b, vb in zip(S.blocks, v_blocks):
        ub = sv_cross(b, vb, mode=mode)
        u = ub if u is None else u + ub
    w = trisolve(L, u, mode=mode)
    x = tuple(serve_apply(b, w, vb, lam, mode=mode)
              for b, vb in zip(S.blocks, v_blocks))
    return BlockedScores.concat(x) if was_flat else x


def fold_cols(S, rows, *, mode: Optional[str] = None):
    """(cols, corner) = (S·rows†, rows·rows†) — the fold cross pass, per
    window block. ``S`` dense or blocked; ``rows`` (k, m) dense or the
    matching per-block tuple."""
    S_blocks = S.blocks if is_blocked(S) else (S,)
    row_blocks = tuple(rows) if isinstance(rows, (tuple, list)) else (rows,)
    cols = corner = None
    for b, r in zip(S_blocks, row_blocks):
        if _use_kernel(mode, b, r):
            cb, kb = _fold.fold_cols_cuda(b, r)
        else:
            cb, kb = ref.fold_cols_ref(b, r)
        cols = cb if cols is None else cols + cb
        corner = kb if corner is None else corner + kb
    return cols, corner


# ---------------------------------------------------------------------------
# Algorithm 1: gram, gram_sv, cholesky, ngd_apply and their composition
# ---------------------------------------------------------------------------

def gram(S, *, mode: Optional[str] = None) -> torch.Tensor:
    """W = S·Sᵀ (n, n) fp32. A blocked operator routes to ``gram_blocks``."""
    if is_blocked(S):
        return gram_blocks(S, mode=mode)
    if _use_kernel(mode, S):
        return _gram.gram_cuda(S)
    return ref.gram_ref(S)


def gram_acc(S: torch.Tensor, W: torch.Tensor, *,
             mode: Optional[str] = None) -> torch.Tensor:
    """W ← W + S·Sᵀ in place, returned: one link of ``gram_blocks``'s
    chain. W (n, n) fp32 is the accumulator on both routes (the port's
    counterpart of the TPU kernel's donated alias)."""
    if _use_kernel(mode, S, W):
        return _gram.gram_acc_cuda(S, W)
    return W.add_(ref.gram_ref(S))


def gram_blocks(S, *, mode: Optional[str] = None) -> torch.Tensor:
    """W = Σ_b S_b·S_bᵀ over per-layer blocks, fp32: ``gram`` on the first
    block, then ``gram_acc`` of every further block into the same (n, n)
    buffer, in place — one accumulator however many blocks, and no flat
    (n, m) concatenation."""
    S = materialize(S)
    blocks = S.blocks if is_blocked(S) else tuple(S)
    W = gram(blocks[0], mode=mode)
    for b in blocks[1:]:
        W = gram_acc(b, W, mode=mode)
    return W


def gram_sv(S: torch.Tensor, v: torch.Tensor, *,
            W: Optional[torch.Tensor] = None, mode: Optional[str] = None):
    """(W, u) = ([W +] S·Sᵀ, S·v) fp32 in one pass over S; a given W (n, n)
    fp32 is the accumulator and is updated in place, as in ``gram_acc``.
    The kernel rounds v to S's dtype first, as the TPU kernel does; the
    plain version keeps v's precision, as the reference's CPU route does."""
    if _use_kernel(mode, S, v):
        return _gram.gram_sv_cuda(S, v, W)
    Wb, u = ref.gram_sv_ref(S, v)
    return (Wb, u) if W is None else (W.add_(Wb), u)


def ngd_apply(S: torch.Tensor, w: torch.Tensor, v: torch.Tensor, lam, *,
              mode: Optional[str] = None) -> torch.Tensor:
    """x = (v − Sᵀ·w)/λ, fp32 (m,)."""
    if _use_kernel(mode, S, w, v):
        n, m = S.shape
        v = v.reshape(m)
        if v.dtype not in _serve.WINDOW_DTYPES:
            v = _f32(v)
        return _apply.ngd_apply_cuda(S, _f32(w).reshape(n), v.contiguous(),
                                     float(lam))
    return ref.ngd_apply_ref(S, w, v, lam)


def cholesky(W: torch.Tensor, *, mode: Optional[str] = None,
             panel: int = 16) -> torch.Tensor:
    """L = chol(W), lower, fp32. The kernel (one launch) takes every n (the
    reference's n ≤ 1024 cap is the TPU's VMEM; this kernel works in device
    memory). Pivots in the kernel are clamped at 1e-30, where the plain
    version gives NaN for a W that is not positive definite. ``panel`` is
    the reference's TPU panel width, taken for signature parity: the CUDA
    kernel's panel is fixed (``cholesky.PANEL``, 64 columns) and the plain
    version has none."""
    del panel
    if _use_kernel(mode, W):
        return _chol.cholesky_cuda(_f32(W).contiguous())
    return ref.cholesky_ref(W)


def cholupdate(L: torch.Tensor, X: torch.Tensor, *, sign: int = 1,
               mode: Optional[str] = None) -> torch.Tensor:
    """Rank-k factor refresh: L' with L'·L'† = L·L† + sign·X·X†; X (n,) is
    one column. A real CUDA factor takes the rotation kernel in fp32 at
    every n up to ``cholupdate.MAX_N`` (the reference's n ≤ 1024 cap is
    the TPU's VMEM; this kernel works in device memory), with r² clamped
    at 1e-30; the plain version (the composed method, NaN for a downdate
    that is not positive definite) runs on the CPU, under ``"ref"`` and
    for complex factors."""
    if X.ndim == 1:
        X = X[:, None]
    sign = 1 if sign > 0 else -1
    if _use_kernel(mode, L, X):
        if X.shape[1] == 0:
            return torch.tril(_f32(L))
        return _cholup.cholupdate_cuda(_f32(L).contiguous(),
                                       _f32(X).contiguous(), sign)
    return ref.cholupdate_ref(L, X, sign)


def chol_solve_fused(S, v, damping, *, mode: Optional[str] = None):
    """Algorithm 1 composed from the kernels:

        (W, u) = gram_sv(S, v)          one pass over S
        L      = cholesky(W + λĨ)
        w      = L⁻ᵀ L⁻¹ u              the substitution kernel
        x      = ngd_apply(S, w, v, λ)  the second pass over S

    With a blocked S the same composition runs per block: (W, u)
    contributions add up across blocks, then the apply runs block by
    block; ``v`` may be flat or a tuple of per-block pieces and x comes
    back in the same form. A ``core.distributed.ShardedScores`` runs the
    same kernels per column slab (``ShardedScores.solve``)."""
    from repro_torch.core.distributed import ShardedScores
    if isinstance(S, ShardedScores):
        return S.solve(v, damping, mode=mode)
    if is_blocked(S):
        return _chol_solve_fused_blocked(S, v, damping, mode=mode)
    lam = real_scalar(damping, torch.float32)
    W, u = gram_sv(S, v, mode=mode)
    W.diagonal().add_(lam)
    L = cholesky(W, mode=mode)
    return ngd_apply(S, trisolve(L, u, mode=mode), v, lam, mode=mode)


chol_solve_fused.takes_sharded = True   # NaturalGradient: no gather first


def _chol_solve_fused_blocked(S, v, damping, *, mode: Optional[str] = None):
    S = materialize(S)
    v_blocks, was_flat = as_blocked_vector(S, v)
    lam = real_scalar(damping, torch.float32)
    # one (n, n) accumulator through the blocks, as in gram_blocks
    W, u = gram_sv(S.blocks[0], v_blocks[0], mode=mode)
    for b, vb in zip(S.blocks[1:], v_blocks[1:]):
        u += gram_sv(b, vb, W=W, mode=mode)[1]
    W.diagonal().add_(lam)
    w = trisolve(cholesky(W, mode=mode), u, mode=mode)
    x = tuple(ngd_apply(b, w, vb, lam, mode=mode)
              for b, vb in zip(S.blocks, v_blocks))
    return BlockedScores.concat(x) if was_flat else x


# ---------------------------------------------------------------------------
# attention: the prefill path of the LM
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, mode: Optional[str] = None,
                    bq: int = 128, bk: int = 128) -> torch.Tensor:
    """Causal / sliding-window / bidirectional GQA attention forward in the
    model layout: q (B, Tq, H, hd), k and v (B, Tk, KH, hd), H % KH == 0;
    returns (B, Tq, H, hd) in q's dtype. p is rounded to v's dtype before
    P·V, as the TPU kernel does. ``bq``/``bk`` are the reference's TPU
    tile sizes, taken for signature parity: the CUDA kernels fix their own
    tiles (128 q rows × 128 keys for bf16 at hd 64 and 128, 64 × 64
    otherwise), and the plain version walks the same KV tiles
    (``ref.flash_kv_tile``). Ragged Tq and Tk are masked, never padded (the
    reference asserts Tk % bk == 0). On CUDA the shapes must be ones
    ``flash_attention.supported`` accepts, or the kernel wrapper raises."""
    del bq, bk
    if _use_kernel(mode, q, k, v):
        return _flash.flash_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window, scale=scale)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
