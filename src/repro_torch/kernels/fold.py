"""CUDA launch wrapper: fused fold cross columns for the FIFO window update.

Replaces ``repro/kernels/fold.py`` (``fold_cols_pallas``); the kernel is
``csrc/fold.cu``. One launch of the split-m cross pass covers the window's
n rows and the k fold rows, so ``cols = S·rowsᵀ`` and
``corner = rows·rowsᵀ`` come out of one pass over ``rows``; a second
launch sums the partials in fixed order. The window and the rows are
read 16 bytes a lane where ``serve_solve.stream_route`` allows (both
aligned), counted in ``serve_solve.ROUTES``; a bf16 window's pass at 8
or 16 fold rows a block runs on the tensor cores
(``serve_solve.cross_tensor_cores``).

The rows must already be in the window's storage dtype
(``serve.adapt.pad_to_window_cols`` is the single cast point), so the
columns describe exactly the values the FIFO write will store.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, P
from repro_torch.kernels.serve_solve import (_count, check_window,
                                             cross_split, cross_tile,
                                             stream_route_of)

__all__ = ["LAUNCHES", "fold_cols_cuda"]

LAUNCHES = {"fold_cols": 0}

_SIGNATURES = {"fold_cols_launch": [P, P, I, P, P, I, I, I, I, I, I, P],
               "repro_stream_launches": [P]}


def fold_cols_cuda(S: torch.Tensor, rows: torch.Tensor):
    """(cols (n, k), corner (k, k)) fp32. S (n, m) and rows (k, m) in the
    same storage dtype, fp32 or bf16."""
    n, m = check_window(S)
    if rows.ndim != 2 or rows.shape[1] != m:
        raise ValueError(f"rows must be (k, {m}), got {tuple(rows.shape)}")
    _build.check("rows", rows, device=S.device, dtypes=(S.dtype,))
    k = rows.shape[0]
    if k < 1:
        raise ValueError("empty fold: rows has no row")
    Pn, chunk = cross_split(n + k, m, cross_tile(S.dtype, k))
    route = stream_route_of(S, rows)
    part = torch.empty((Pn, n + k, k), dtype=torch.float32, device=S.device)
    out = torch.empty((n + k, k), dtype=torch.float32, device=S.device)
    if _build.would_launch(S.device, "fold_cols", flops=2 * (n + k) * m * k,
                           nbytes=_build.nbytes(S, rows, out)):
        return out[:n], out[n:]
    _build.call(_build.library("fold", _SIGNATURES), "fold_cols_launch",
                S.device, S.data_ptr(), rows.data_ptr(),
                int(S.dtype == torch.bfloat16), part.data_ptr(),
                out.data_ptr(), n, m, k, Pn, chunk, int(route == "vector"),
                _build.stream_of(S))
    LAUNCHES["fold_cols"] += 1
    _count(route, S.dtype, k, cross=True)
    return out[:n], out[n:]
