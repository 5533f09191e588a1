"""CUDA launch wrapper: the blocked Cholesky factorization of Algorithm 1.

Replaces ``repro/kernels/cholesky.py`` (``cholesky_pallas``); the kernel
is ``csrc/cholesky.cu``: one cooperative launch whose co-resident blocks
walk panels of 64 columns, separated by grid barriers — each block updates
its statically owned 64 × 64 lower tiles, the owner of the next diagonal
tile factors it first (lookahead) and the owners of the panel's tiles
solve them against it. Pivots are clamped at 1e-30 as on the TPU, so only
SPD inputs agree with the plain version (which gives NaN otherwise).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, P

__all__ = ["LAUNCHES", "PANEL", "cholesky_cuda"]

LAUNCHES = {"cholesky": 0}

PANEL = 64                      # mirrors kT in csrc/cholesky.cu

_SIGNATURES = {"cholesky_launch": [P, P, P, P, I, P]}


def cholesky_cuda(W: torch.Tensor) -> torch.Tensor:
    """Lower L (n, n) fp32 with W = L·Lᵀ; the upper triangle is zero.
    W (n, n) fp32 contiguous on CUDA, symmetric positive definite (its
    lower triangle is read). Any n: W and L stay in device memory; the
    scratch is 64·⌈n/64⌉ floats (the reciprocal pivots the panel solves
    share) and ⌈n/64⌉ + 2 integers (a flag a panel, the grid barrier)."""
    if W.ndim != 2 or W.shape[0] != W.shape[1] or not _build.on_card(W):
        raise ValueError(f"W must be a square CUDA matrix, got "
                         f"{tuple(W.shape)} on {W.device}")
    n = W.shape[0]
    if n == 0:
        raise ValueError("W is empty")
    _build.check("W", W, device=W.device, dtypes=(torch.float32,))
    panels = -(-n // PANEL)
    rdiag = torch.empty((panels * PANEL,), dtype=torch.float32,
                        device=W.device)
    sync = torch.empty((panels + 2,), dtype=torch.int32, device=W.device)
    L = torch.empty((n, n), dtype=torch.float32, device=W.device)
    if _build.would_launch(W.device, "cholesky", flops=n ** 3 / 3,
                           nbytes=_build.nbytes(W, L)):
        return L
    _build.call(_build.library("cholesky", _SIGNATURES), "cholesky_launch",
                W.device, W.data_ptr(), L.data_ptr(), rdiag.data_ptr(),
                sync.data_ptr(), n, _build.stream_of(W))
    LAUNCHES["cholesky"] += 1
    return L
