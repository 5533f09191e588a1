"""Public wrappers of the serve-path kernels, with the reference's
``mode`` dispatch (``repro/kernels/ops.py``).

``mode``:

* ``None`` — a CUDA tensor takes the hand-written kernel, a CPU tensor
  the plain PyTorch version (``ref``);
* ``"ref"`` — the plain version on any device (the card's oracle);
* ``"kernel"`` — the kernel; raises for CPU tensors.

Complex operands take the plain version under every mode, as
``ops._any_complex`` routes them on the TPU (the kernels are real-only).
Beyond that nothing falls back: a CUDA tensor whose kernel fails to
build, launch, or accept its operands raises.

Unlike the JAX wrappers these never pad the window to a tile multiple:
the kernels mask the ragged edge themselves, so no request copies S.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.operator import BlockedScores, as_blocked_vector, is_blocked
from repro_torch.kernels import fold as _fold
from repro_torch.kernels import ref
from repro_torch.kernels import serve_solve as _serve

__all__ = ["fold_cols", "launch_counts", "reset_launch_counts", "serve_apply",
           "serve_solve", "sv_cross", "trisolve"]

MODES = (None, "ref", "kernel")


def _any_complex(*tensors) -> bool:
    return any(t.is_complex() for t in tensors)


def _use_kernel(mode: Optional[str], *tensors) -> bool:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "ref" or _any_complex(*tensors):
        return False
    on_cuda = tensors[0].is_cuda
    if mode == "kernel" and not on_cuda:
        raise RuntimeError("mode='kernel' needs CUDA tensors; the kernels do "
                           "not run on the CPU")
    return on_cuda


def _cols(V: torch.Tensor) -> tuple[torch.Tensor, bool]:
    return (V[:, None], True) if V.ndim == 1 else (V, False)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {**_serve.LAUNCHES, **_fold.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (_serve.LAUNCHES, _fold.LAUNCHES):
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
