"""CUDA launch wrapper: the rank-k Cholesky update and downdate.

Replaces ``repro/kernels/cholupdate.py`` (``cholupdate_pallas``); the
kernel is ``csrc/cholupdate.cu``: one block, a thread per row (two at
n = 2048) holding its entries of X in registers, sweeping a column-major
copy of L (tiled transposes in and out); per factor column j every row
below applies the column's k rotations while the warp that holds row
j + 1 computes the next column's, one barrier a column.
It is bound by that n-long chain of barriers, not by bytes or operations.
A rotation whose b is ±0 is skipped, so zero columns of X are exact
no-ops; r² is clamped at 1e-30 as on the TPU, so only a downdate that
leaves L·Lᵀ − X·Xᵀ positive definite agrees with the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, P

__all__ = ["LAUNCHES", "MAX_N", "cholupdate_cuda"]

LAUNCHES = {"cholupdate": 0}

MAX_THREADS = 1024              # mirrors kThreads in csrc/cholupdate.cu
MAX_N = 32 * MAX_THREADS        # at most 32 rows a thread

_SIGNATURES = {"cholupdate_launch": [P, P, P, P, I, I, I, P]}


def cholupdate_cuda(L: torch.Tensor, X: torch.Tensor, sign: int = 1
                    ) -> torch.Tensor:
    """L' (n, n) fp32 with L'·L'ᵀ = L·Lᵀ + sign·X·Xᵀ; its strict upper
    triangle is exactly zero. L (n, n) lower and X (n, k) fp32 contiguous
    on one CUDA device, 1 ≤ n ≤ ``MAX_N``, k ≥ 1; sign ±1."""
    if L.ndim != 2 or L.shape[0] != L.shape[1] or L.device.type != "cuda":
        raise ValueError(f"L must be a square CUDA matrix, got "
                         f"{tuple(L.shape)} on {L.device}")
    n = L.shape[0]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the kernel takes 1 <= n <= {MAX_N} (32 rows a "
                         f"thread of one block), got n = {n}")
    if X.ndim != 2 or X.shape[0] != n or X.shape[1] < 1:
        raise ValueError(f"X must be ({n}, k) with k >= 1, got "
                         f"{tuple(X.shape)}")
    if sign not in (1, -1):
        raise ValueError(f"sign must be +1 or -1, got {sign!r}")
    _build.check("L", L, device=L.device, dtypes=(torch.float32,))
    _build.check("X", X, device=L.device, dtypes=(torch.float32,))
    work = torch.empty((n, n), dtype=torch.float32, device=L.device)
    out = torch.empty((n, n), dtype=torch.float32, device=L.device)
    _build.call(_build.library("cholupdate", _SIGNATURES), "cholupdate_launch",
                L.device, L.data_ptr(), X.data_ptr(), work.data_ptr(),
                out.data_ptr(), n, X.shape[1], sign, _build.stream_of(L))
    LAUNCHES["cholupdate"] += 1
    return out
