"""CUDA launch wrapper: the NGD apply pass x = (v − Sᵀw)/λ.

Replaces ``repro/kernels/ngd_apply.py`` (``ngd_apply_pallas``); the kernel
(``csrc/ngd_apply.cu``) is the one-right-hand-side apply pass: 16-byte
streaming loads of the window, its rows split over the warps of a block
and summed in a fixed order, v in fp32 or bf16 (widened on load).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F, I, P
from repro_torch.kernels.serve_solve import WINDOW_DTYPES, check_window

__all__ = ["LAUNCHES", "ngd_apply_cuda"]

LAUNCHES = {"ngd_apply": 0}

_SIGNATURES = {"ngd_apply_launch": [P, I, P, P, I, P, I, I, F, P]}


def ngd_apply_cuda(S: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                   lam: float) -> torch.Tensor:
    """x = (v − Sᵀw)/λ (m,) fp32. S (n, m) fp32|bf16; w (n,) fp32;
    v (m,) fp32|bf16."""
    n, m = check_window(S)
    _build.check("w", w, device=S.device, dtypes=(torch.float32,),
                 shape=(n,))
    _build.check("v", v, device=S.device, dtypes=WINDOW_DTYPES, shape=(m,))
    x = torch.empty((m,), dtype=torch.float32, device=S.device)
    if _build.would_launch(S.device, "ngd_apply", flops=2 * n * m,
                           nbytes=_build.nbytes(S, w, v, x)):
        return x
    _build.call(_build.library("ngd_apply", _SIGNATURES), "ngd_apply_launch",
                S.device, S.data_ptr(), int(S.dtype == torch.bfloat16),
                w.data_ptr(), v.data_ptr(), int(v.dtype == torch.bfloat16),
                x.data_ptr(), n, m, float(lam), _build.stream_of(S))
    LAUNCHES["ngd_apply"] += 1
    return x
