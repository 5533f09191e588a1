"""CUDA launch wrapper: the flash-attention forward.

Replaces ``repro/kernels/flash_attention.py`` (``flash_attention_pallas``);
the kernels are in ``csrc/flash_attention.cu``:

* bf16 at hd 64 and 128 (the LM's head dims): ``wgmma`` fed by TMA
  (``csrc/flash_wgmma.cuh``), one producer warp and two consumer
  warpgroups a block of 128 q rows, 128-key tiles in a ring of two;
* bf16 at hd 16 and 32: ``mma.sync`` m16n8k16, 64 q rows × 64-key tiles;
* fp32, and bf16 at hd 256: fp32 FMAs on the CUDA cores.

All read q (B, Tq, H, hd) and k, v (B, Tk, KH, hd) in the model's layout,
in place — no (B·H, T, hd) transpose, no repeated K/V for GQA, no padding
of ragged Tq or Tk — and write o (B, Tq, H, hd) in q's dtype.
``supported(q, k)`` states which shapes and dtypes they take; the wrapper
raises on any other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F, I, P

__all__ = ["HEAD_DIMS", "LAUNCHES", "MAX_BH", "flash_attention_cuda",
           "live_pairs", "supported"]

LAUNCHES = {"flash_attention": 0}

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_BH = 65535       # B·H: the grid's y extent of the 64-row-tile kernels
_DTYPES = (torch.float32, torch.bfloat16)

_SIGNATURES = {"flash_attention_launch": [P, P, P, P, I, I, I, I, I, I, I, F,
                                          I, I, P]}


def _unsupported(q, k) -> Optional[str]:
    """None when the kernels take attention of these shapes and dtypes,
    else the reason."""
    if q.ndim != 4 or k.ndim != 4:
        return "q must be (B, Tq, H, hd) and k, v (B, Tk, KH, hd)"
    B, Tq, H, hd = q.shape
    Bk, Tk, KH, hdk = k.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype:
        return (f"q and k have dtypes {q.dtype}, {k.dtype}; the kernels take "
                "one of fp32 and bf16")
    if (Bk, hdk) != (B, hd):
        return f"q {tuple(q.shape)} and k {tuple(k.shape)} do not pair"
    if KH < 1 or H % KH:
        return f"{H} query heads do not group over {KH} KV heads"
    if hd not in HEAD_DIMS:
        return f"head_dim {hd} not in {HEAD_DIMS}"
    if min(B, Tq, Tk) < 1 or B * H > MAX_BH:
        return (f"unsupported shape q {tuple(q.shape)}, k {tuple(k.shape)} "
                f"(B, Tq, Tk >= 1, B·H <= {MAX_BH})")
    return None


def live_pairs(Tq: int, Tk: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs the mask keeps: query i sees keys j ≤ i when
    causal, of which the last ``window``; every key otherwise."""
    if not causal:
        return Tq * Tk
    w = min(Tk, window or Tk)
    # Σ_{i<Tq} min(i + 1, w): a ramp up to w, then w a row
    ramp = min(Tq, w)
    return ramp * (ramp + 1) // 2 + (Tq - ramp) * w


def supported(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether the kernels take attention of q (B, Tq, H, hd) against k
    (and v, k's shape) (B, Tk, KH, hd): one dtype, fp32 or bf16; hd in
    ``HEAD_DIMS``; H % KH == 0; B, Tq, Tk ≥ 1; B·H ≤ ``MAX_BH``. A pure
    rule on shapes and dtypes — it answers the same for CPU tensors as for
    the card's, so a caller can route by it on either."""
    return _unsupported(q, k) is None


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """o = softmax(mask(q·kᵀ·scale))·v, (B, Tq, H, hd) in q's dtype; p is
    rounded to v's dtype before P·V. q (B, Tq, H, hd), k and v (B, Tk, KH,
    hd), one dtype (fp32 or bf16), contiguous, on one CUDA device;
    raises on a CPU tensor first, then on shapes ``supported`` refuses."""
    if not isinstance(q, torch.Tensor) or not _build.on_card(q):
        where = q.device if isinstance(q, torch.Tensor) else type(q).__name__
        raise ValueError(f"q is on {where}; the kernel needs CUDA")
    why = _unsupported(q, k)
    if why is not None:
        raise ValueError(f"flash_attention_cuda: {why}")
    _build.check("q", q, device=q.device, dtypes=_DTYPES)
    for name, t in (("k", k), ("v", v)):
        _build.check(name, t, device=q.device, dtypes=(q.dtype,),
                     shape=tuple(k.shape))
    B, Tq, H, hd = q.shape
    _, Tk, KH, _ = k.shape
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    o = torch.empty_like(q)
    if _build.would_launch(
            q.device, "flash_attention",
            flops=4 * hd * H * B * live_pairs(Tq, Tk, causal, window),
            nbytes=_build.nbytes(q, k, v, o)):
        return o
    _build.call(_build.library("flash_attention", _SIGNATURES),
                "flash_attention_launch", q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), int(q.dtype == torch.bfloat16),
                B, H, KH, Tq, Tk, hd,
                float(hd ** -0.5 if scale is None else scale), int(causal),
                0 if window is None else int(window), _build.stream_of(q))
    LAUNCHES["flash_attention"] += 1
    return o
