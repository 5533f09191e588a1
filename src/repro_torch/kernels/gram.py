"""CUDA launch wrappers: the Gram family of Algorithm 1.

Replaces ``repro/kernels/gram.py`` (``gram_pallas``, ``gram_acc_pallas``)
and ``repro/kernels/gram_sv.py`` (``gram_sv_pallas``); the kernels are in
``csrc/gram.cu``: a split-m pass over the lower (128, 128) tiles of
W = S·Sᵀ, then a fixed-order sum of the partials that mirrors W, seeds it
from W_in (``gram_acc``) and sums u = S·v (``gram_sv``).

The pass has two routes, chosen by ``tensor_core_route`` from the shape,
the dtype and the view's offset alone: ``wgmma`` fed by TMA (3xTF32 for an
fp32 window, one bf16 pass for a bf16 one) where TMA can read the window,
else fp32 FMAs on the CUDA cores. ``ROUTES`` counts the launches of each.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, P
from repro_torch.kernels.serve_solve import check_window

__all__ = ["LAUNCHES", "ROUTES", "box_columns", "gram_acc_cuda", "gram_cuda",
           "gram_split", "gram_sv_cuda", "tensor_core_route"]

LAUNCHES = {"gram": 0, "gram_acc": 0, "gram_sv": 0}
# launches of the three wrappers by route: "wgmma" (tensor cores, TMA) or
# "cuda_cores" (fp32 FMAs)
ROUTES = {"wgmma": 0, "cuda_cores": 0}

# Mirrors kT / kK and tc::Cfg<T>::kCols in csrc/gram.cu. The split of m aims
# at a fixed number of blocks (8 per SM of an H100), independent of the card,
# so the reduction order — and the result bits — depend on the shape only.
# The scratch is about _TARGET_BLOCKS × 64 KB (≈ 70 MB) whatever the shape.
_TILE = 128
_DEPTH = 16                     # CUDA-core route: columns a stage
_BOX_BYTES = 128                # tensor-core route: a TMA box is 128 bytes wide
_TARGET_BLOCKS = 1056

_SIGNATURES = {"gram_launch": [P, I, P, P, P, P, P, P, I, I, I, I, I, I, P]}


def box_columns(dtype: torch.dtype) -> int:
    """Columns of m in one TMA box of the tensor-core route: 32 fp32, 64
    bf16."""
    return _BOX_BYTES // torch.empty((), dtype=dtype).element_size()


def tensor_core_route(n: int, m: int, dtype: torch.dtype,
                      byte_offset: int = 0) -> bool:
    """Whether the Gram of an (n, m) row-major window of ``dtype`` whose
    data starts ``byte_offset`` bytes into its storage takes the ``wgmma``
    + TMA kernel: fp32 or bf16, and TMA's 16-byte alignment of the row
    stride (m·itemsize) and of the base (the storage itself is allocated
    aligned). A pure rule on the shape, the dtype and the offset — the
    same answer for a tensor on any device."""
    if dtype not in (torch.float32, torch.bfloat16) or n < 1 or m < 1:
        return False
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (m * itemsize) % 16 == 0 and byte_offset % 16 == 0


def gram_split(n: int, m: int, depth: int = _DEPTH) -> tuple[int, int, int]:
    """(tiles, P, chunk): the lower tiles of W and the split of m into P
    chunks of ``chunk`` columns, a multiple of ``depth`` — the CUDA-core
    route's stage (16, the default) or the tensor-core route's box
    (``box_columns``), so that no box reads into the next chunk."""
    t = -(-n // _TILE)
    tiles = t * (t + 1) // 2
    P_ = max(1, min(-(-_TARGET_BLOCKS // tiles), -(-m // depth)))
    chunk = -(-(-(-m // P_)) // depth) * depth
    return tiles, -(-m // chunk), chunk


def _launch(name: str, S: torch.Tensor, v: Optional[torch.Tensor],
            W_in: Optional[torch.Tensor], W: torch.Tensor,
            u: Optional[torch.Tensor]) -> None:
    """One launch of the pass for the wrapper ``name``, counted under it
    and under its route; on meta operands, the scratch and a would-be
    launch (operations: the lower triangle's products, 2·n(n+1)/2·m, and
    u's 2·n·m; bytes: S, v, W_in, W and u once each)."""
    n, m = S.shape
    tc = tensor_core_route(n, m, S.dtype,
                           S.storage_offset() * S.element_size())
    depth = box_columns(S.dtype) if tc else _DEPTH
    tiles, Pn, chunk = gram_split(n, m, depth)
    part = torch.empty((Pn, tiles, _TILE, _TILE), dtype=torch.float32,
                       device=S.device)
    part_u = None if v is None else torch.empty(
        (Pn, -(-n // _TILE) * _TILE), dtype=torch.float32, device=S.device)

    flops = n * (n + 1) * m + (0 if v is None else 2 * n * m)
    if _build.would_launch(S.device, name, flops=flops,
                           nbytes=_build.nbytes(S, v, W_in, W, u)):
        return

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.call(_build.library("gram", _SIGNATURES), "gram_launch", S.device,
                S.data_ptr(), int(S.dtype == torch.bfloat16), ptr(v),
                ptr(W_in), W.data_ptr(), ptr(u), part.data_ptr(),
                ptr(part_u), n, m, tiles, Pn, chunk, int(tc),
                _build.stream_of(S))
    ROUTES["wgmma" if tc else "cuda_cores"] += 1
    LAUNCHES[name] += 1


def gram_cuda(S: torch.Tensor) -> torch.Tensor:
    """W = S·Sᵀ (n, n) fp32. S (n, m) fp32|bf16."""
    n, _ = check_window(S)
    W = torch.empty((n, n), dtype=torch.float32, device=S.device)
    _launch("gram", S, None, None, W, None)
    return W


def gram_acc_cuda(S: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """W ← W + S·Sᵀ in place, returned. S (n, m) fp32|bf16; W (n, n) fp32.
    The port's counterpart of the TPU kernel's donated accumulator."""
    n, _ = check_window(S)
    _build.check("W", W, device=S.device, dtypes=(torch.float32,),
                 shape=(n, n))
    _launch("gram_acc", S, None, W, W, None)
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
    if v.data_ptr() % 16:           # the kernels read v 16 bytes at a time
        v = v.clone()
    W_in = W
    if W is None:
        W = torch.empty((n, n), dtype=torch.float32, device=S.device)
    else:
        _build.check("W", W, device=S.device, dtypes=(torch.float32,),
                     shape=(n, n))
    u = torch.empty((n,), dtype=torch.float32, device=S.device)
    _launch("gram_sv", S, v, W_in, W, u)
    return W, u
