"""CUDA launch wrapper: the panel Cholesky factorization of Algorithm 1.

Replaces ``repro/kernels/cholesky.py`` (``cholesky_pallas``); the kernels
are in ``csrc/cholesky.cu``: one launch per panel of 16 columns, whose
blocks split the correction from the columns already factored by rows and
by depth, and whose last block per slab of rows factors the panel's
diagonal block and solves the slab's rows against it — all launched from C
on one stream. Pivots are clamped at 1e-30 as on the TPU, so only SPD
inputs agree with the plain version (which gives NaN otherwise).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, P

__all__ = ["LAUNCHES", "PANEL", "cholesky_cuda"]

LAUNCHES = {"cholesky": 0}

PANEL = 16                      # mirrors kPanel in csrc/cholesky.cu
_SLAB = 64                      # mirrors kSlab and kDepth in csrc/cholesky.cu

_SIGNATURES = {"cholesky_launch": [P, P, P, P, I, P]}


def cholesky_cuda(W: torch.Tensor) -> torch.Tensor:
    """Lower L (n, n) fp32 with W = L·Lᵀ; the upper triangle is zero.
    W (n, n) fp32 contiguous on CUDA, symmetric positive definite. Any n:
    W and L stay in device memory and the scratch is about n²/4 floats."""
    if W.ndim != 2 or W.shape[0] != W.shape[1] or W.device.type != "cuda":
        raise ValueError(f"W must be a square CUDA matrix, got "
                         f"{tuple(W.shape)} on {W.device}")
    n = W.shape[0]
    if n == 0:
        raise ValueError("W is empty")
    _build.check("W", W, device=W.device, dtypes=(torch.float32,))
    slabs = -(-n // _SLAB)
    # per depth slice: the row partials (n, 16), then per slab and slice
    # the diagonal block's (16, 16)
    scratch = torch.empty((slabs * n * PANEL + slabs * slabs * PANEL * PANEL,),
                          dtype=torch.float32, device=W.device)
    counters = torch.empty((slabs,), dtype=torch.int32, device=W.device)
    L = torch.empty((n, n), dtype=torch.float32, device=W.device)
    _build.call(_build.library("cholesky", _SIGNATURES), "cholesky_launch",
                W.device, W.data_ptr(), scratch.data_ptr(),
                counters.data_ptr(), L.data_ptr(), n, _build.stream_of(W))
    LAUNCHES["cholesky"] += 1
    return L
