"""Plain PyTorch versions of the serve-path kernels.

Port of the serve half of ``repro/kernels/ref.py``, plus ``trisolve_ref``
(the substitution that the TPU kernel runs in-kernel as ``_trisolve``).
The CPU path of ``ops``, the oracle of the CUDA kernels on the card, and
the reference the tests compare with. Accumulation is fp32 or wider
whatever the storage dtype; fp32 matmuls run without TF32.
"""
from __future__ import annotations

import torch

from repro_torch.core.operator import acc_dtype

__all__ = ["sv_cross_ref", "serve_apply_ref", "serve_solve_ref",
           "trisolve_ref", "fold_cols_ref"]


def _ct(A: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose (plain transpose for real dtypes)."""
    return A.mH if A.is_complex() else A.mT


def _acc(*tensors) -> torch.dtype:
    return acc_dtype(*(t.dtype for t in tensors))


def sv_cross_ref(S: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """U = S @ V — the serve cross pass."""
    tgt = _acc(S, V)
    return S.to(tgt) @ V.to(tgt)


def serve_apply_ref(S: torch.Tensor, w: torch.Tensor, V: torch.Tensor,
                    lam) -> torch.Tensor:
    """X = (V − S† @ w) / λ — the multi-RHS serve apply pass."""
    tgt = _acc(S, V, w)
    rdtype = torch.empty((), dtype=tgt).real.dtype
    lam_r = torch.as_tensor(lam, dtype=rdtype, device=S.device)
    return (V.to(tgt) - _ct(S.to(tgt)) @ w.to(tgt)) / lam_r


def trisolve_ref(L: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """w = L⁻† L⁻¹ U against a lower-triangular L."""
    w = torch.linalg.solve_triangular(L, U, upper=False)
    return torch.linalg.solve_triangular(_ct(L), w, upper=True)


def serve_solve_ref(S: torch.Tensor, L: torch.Tensor, V: torch.Tensor,
                    lam) -> torch.Tensor:
    """X = (V − S† L⁻† L⁻¹ S V)/λ against a resident L (the exact
    ``CholFactorization.solve`` algebra)."""
    return serve_apply_ref(S, trisolve_ref(L, sv_cross_ref(S, V)), V, lam)


def fold_cols_ref(S: torch.Tensor, rows: torch.Tensor):
    """(cols, corner) = (S·rows†, rows·rows†) — the fold cross columns."""
    tgt = _acc(S, rows)
    r = rows.to(tgt)
    return S.to(tgt) @ _ct(r), r @ _ct(r)
