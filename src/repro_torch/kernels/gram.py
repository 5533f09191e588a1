"""CUDA launch wrappers: the Gram family of Algorithm 1.

Replaces ``repro/kernels/gram.py`` (``gram_pallas``, ``gram_acc_pallas``)
and ``repro/kernels/gram_sv.py`` (``gram_sv_pallas``); the kernels are in
``csrc/gram.cu``: a split-m pass over the lower (128, 128) tiles of
W = S·Sᵀ, then a fixed-order sum of the partials that mirrors W, seeds it
from W_in (``gram_acc``) and sums u = S·v (``gram_sv``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, P
from repro_torch.kernels.serve_solve import check_window

__all__ = ["LAUNCHES", "gram_acc_cuda", "gram_cuda", "gram_split",
           "gram_sv_cuda"]

LAUNCHES = {"gram": 0, "gram_acc": 0, "gram_sv": 0}

# Mirrors kT / kK in csrc/gram.cu. The split of m aims at a fixed number of
# blocks (8 per SM of an H100), independent of the card, so the reduction
# order — and the result bits — depend on the shape only. The scratch is
# about _TARGET_BLOCKS × 64 KB (≈ 70 MB) whatever the shape.
_TILE = 128
_DEPTH = 16
_TARGET_BLOCKS = 1056

_SIGNATURES = {"gram_launch": [P, I, P, P, P, P, P, P, I, I, I, I, I, P]}


def gram_split(n: int, m: int) -> tuple[int, int, int]:
    """(tiles, P, chunk): the lower tiles of W and the split of m into P
    chunks of ``chunk`` columns (a multiple of the kernel's stage depth)."""
    t = -(-n // _TILE)
    tiles = t * (t + 1) // 2
    P_ = max(1, min(-(-_TARGET_BLOCKS // tiles), -(-m // _DEPTH)))
    chunk = -(-(-(-m // P_)) // _DEPTH) * _DEPTH
    return tiles, -(-m // chunk), chunk


def _launch(S: torch.Tensor, v: Optional[torch.Tensor],
            W_in: Optional[torch.Tensor], W: torch.Tensor,
            u: Optional[torch.Tensor]) -> None:
    n, m = S.shape
    tiles, Pn, chunk = gram_split(n, m)
    part = torch.empty((Pn, tiles, _TILE, _TILE), dtype=torch.float32,
                       device=S.device)
    part_u = None if v is None else torch.empty(
        (Pn, -(-n // _TILE) * _TILE), dtype=torch.float32, device=S.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.call(_build.library("gram", _SIGNATURES), "gram_launch", S.device,
                S.data_ptr(), int(S.dtype == torch.bfloat16), ptr(v),
                ptr(W_in), W.data_ptr(), ptr(u), part.data_ptr(),
                ptr(part_u), n, m, tiles, Pn, chunk, _build.stream_of(S))


def gram_cuda(S: torch.Tensor) -> torch.Tensor:
    """W = S·Sᵀ (n, n) fp32. S (n, m) fp32|bf16."""
    n, _ = check_window(S)
    W = torch.empty((n, n), dtype=torch.float32, device=S.device)
    _launch(S, None, None, W, None)
    LAUNCHES["gram"] += 1
    return W


def gram_acc_cuda(S: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """W ← W + S·Sᵀ in place, returned. S (n, m) fp32|bf16; W (n, n) fp32.
    The port's counterpart of the TPU kernel's donated accumulator."""
    n, _ = check_window(S)
    _build.check("W", W, device=S.device, dtypes=(torch.float32,),
                 shape=(n, n))
    _launch(S, None, W, W, None)
    LAUNCHES["gram_acc"] += 1
    return W


def gram_sv_cuda(S: torch.Tensor, v: torch.Tensor,
                 W: Optional[torch.Tensor] = None):
    """(W, u) = ([W +] S·Sᵀ, S·v), (n, n) and (n,) fp32, in one pass over S.
    S (n, m) fp32|bf16; v (m,) is rounded to S's dtype first, as
    ``gram_sv_pallas`` casts it (``repro/kernels/gram_sv.py:86``). A given
    W (n, n) fp32 seeds the sum and receives it in place, as ``gram_acc``."""
    n, m = check_window(S)
    if v.numel() != m:
        raise ValueError(f"v must have {m} elements, got {tuple(v.shape)}")
    if v.device != S.device:
        raise ValueError(f"v is on {v.device}, the kernel runs on {S.device}")
    v = v.reshape(m).to(S.dtype).contiguous()
    W_in = W
    if W is None:
        W = torch.empty((n, n), dtype=torch.float32, device=S.device)
    else:
        _build.check("W", W, device=S.device, dtypes=(torch.float32,),
                     shape=(n, n))
    u = torch.empty((n,), dtype=torch.float32, device=S.device)
    _launch(S, v, W_in, W, u)
    LAUNCHES["gram_sv"] += 1
    return W, u
