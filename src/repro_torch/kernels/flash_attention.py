"""CUDA launch wrapper: the flash-attention forward.

Replaces ``repro/kernels/flash_attention.py`` (``flash_attention_pallas``);
the kernels are in ``csrc/flash_attention.cu``: bf16 at hd ≤ 128 on the
tensor cores (``mma.sync``), fp32 and hd 256 on the CUDA cores. Both read
q (B, Tq, H, hd) and k, v (B, Tk, KH, hd) in the model's layout, in
place — no (B·H, T, hd) transpose, no repeated K/V for GQA, no padding of
ragged Tq or Tk — and write o (B, Tq, H, hd) in q's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F, I, P

__all__ = ["HEAD_DIMS", "LAUNCHES", "flash_attention_cuda"]

LAUNCHES = {"flash_attention": 0}

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)

_SIGNATURES = {"flash_attention_launch": [P, P, P, P, I, I, I, I, I, I, I, F,
                                          I, I, P]}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """o = softmax(mask(q·kᵀ·scale))·v, (B, Tq, H, hd) in q's dtype; p is
    rounded to v's dtype before P·V. q (B, Tq, H, hd), k and v (B, Tk, KH,
    hd), one dtype (fp32 or bf16), contiguous, on one CUDA device."""
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError("q must be (B, Tq, H, hd) and k, v (B, Tk, KH, hd)")
    B, Tq, H, hd = q.shape
    _, Tk, KH, _ = k.shape
    _build.check("q", q, device=q.device, dtypes=_DTYPES)
    if q.device.type != "cuda":
        raise ValueError(f"q is on {q.device}; the kernel needs CUDA")
    for name, t in (("k", k), ("v", v)):
        _build.check(name, t, device=q.device, dtypes=(q.dtype,),
                     shape=(B, Tk, KH, hd))
    if KH < 1 or H % KH:
        raise ValueError(f"{H} query heads do not group over {KH} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if Tq < 1 or Tk < 1 or B < 1 or B * H > 65535:
        raise ValueError(f"unsupported shape q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    o = torch.empty_like(q)
    _build.call(_build.library("flash_attention", _SIGNATURES),
                "flash_attention_launch", q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), int(q.dtype == torch.bfloat16),
                B, H, KH, Tq, Tk, hd,
                float(hd ** -0.5 if scale is None else scale), int(causal),
                0 if window is None else int(window), _build.stream_of(q))
    LAUNCHES["flash_attention"] += 1
    return o
