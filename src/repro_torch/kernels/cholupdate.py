"""CUDA launch wrapper: the rank-k Cholesky update and downdate.

Replaces ``repro/kernels/cholupdate.py`` (``cholupdate_pallas``); the
kernel is ``csrc/cholupdate.cu``: one cooperative launch of one-warp
blocks, a warp per group of 32 rows with its entries of X in registers.
Each warp applies the rotation pairs of every panel of 32 columns above
its rows, in order and column by column as they are published (flagged
16-byte records, no fences), then factors its own panel (a warp scan per
column, no block barrier) and publishes its pairs; chunks of 32 columns
of X are separated by a grid barrier. It is bound by the chain of n
dependent columns, not by bytes or operations, and gives the previous
one-block design's result bit for bit. A rotation whose b is ±0 is
skipped, so zero columns of X are exact no-ops; r² is clamped at 1e-30 as
on the TPU, so only a downdate that leaves L·Lᵀ − X·Xᵀ positive definite
agrees with the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, P

__all__ = ["LAUNCHES", "MAX_N", "cholupdate_cuda", "chunk_columns",
           "work_floats"]

LAUNCHES = {"cholupdate": 0}

MAX_N = 32 * 1024               # mirrors the check in csrc/cholupdate.cu
GROUP = 32                      # mirrors kB: rows a warp, columns a panel

_SIGNATURES = {"cholupdate_launch": [P, P, P, P, I, I, I, P]}


def chunk_columns(k: int) -> int:
    """Columns of X the kernel takes a chunk (its KC): the least of 8, 16
    and 32 that holds k, 32 beyond."""
    return 8 if k <= 8 else 16 if k <= 16 else 32


def work_floats(n: int, k: int) -> int:
    """Floats of the kernel's scratch (``work_records`` in the source): a
    16-byte record for the grid barrier, then one {c, flag, s, flag} record
    for each published rotation pair, KC of them a factor column."""
    return 4 * (1 + -(-n // GROUP) * GROUP * chunk_columns(k))


def cholupdate_cuda(L: torch.Tensor, X: torch.Tensor, sign: int = 1
                    ) -> torch.Tensor:
    """L' (n, n) fp32 with L'·L'ᵀ = L·Lᵀ + sign·X·Xᵀ; its strict upper
    triangle is exactly zero. L (n, n) lower and X (n, k) fp32 contiguous
    on one CUDA device, 1 ≤ n ≤ ``MAX_N``, k ≥ 1; sign ±1."""
    if L.ndim != 2 or L.shape[0] != L.shape[1] or not _build.on_card(L):
        raise ValueError(f"L must be a square CUDA matrix, got "
                         f"{tuple(L.shape)} on {L.device}")
    n = L.shape[0]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the kernel takes 1 <= n <= {MAX_N}, got n = {n}")
    if X.ndim != 2 or X.shape[0] != n or X.shape[1] < 1:
        raise ValueError(f"X must be ({n}, k) with k >= 1, got "
                         f"{tuple(X.shape)}")
    if sign not in (1, -1):
        raise ValueError(f"sign must be +1 or -1, got {sign!r}")
    _build.check("L", L, device=L.device, dtypes=(torch.float32,))
    _build.check("X", X, device=L.device, dtypes=(torch.float32,))
    out = torch.empty((n, n), dtype=torch.float32, device=L.device)
    work = torch.empty((work_floats(n, X.shape[1]),), dtype=torch.float32,
                       device=L.device)
    # the lower triangle read and written once, X read once; 6 flop a
    # rotation of a lower element, k rotations each
    k = X.shape[1]
    if _build.would_launch(L.device, "cholupdate", flops=3 * n * (n + 1) * k,
                           nbytes=(n * (n + 1) + n * k) * 4):
        return out
    _build.call(_build.library("cholupdate", _SIGNATURES), "cholupdate_launch",
                L.device, L.data_ptr(), X.data_ptr(), out.data_ptr(),
                work.data_ptr(), n, X.shape[1], sign, _build.stream_of(L))
    LAUNCHES["cholupdate"] += 1
    return out
