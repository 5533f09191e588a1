"""Streaming Gram accumulation — W without ever holding all of S.

Port of ``repro/curvature/streaming.py``. The Gram is a sum over the
parameter axis, so any partition of S's columns — per-layer
``BlockedScores`` blocks, dense column chunks, one microbatch's lazily
built score blocks at a time — folds into one resident (n, n)
accumulator, fp32 or complex64 at least:

    W = Σ_pieces  S_piece · S_piece†

so the peak score footprint is one piece, never the full (n, m) matrix.
``StreamingGram`` is functional (``update`` returns a new accumulator, the
held W is never written in place); ``accumulate_gram`` is the one-shot
fold, and ``factorize`` hands the finished W to
``chol_factorize(..., W=...)``, skipping its Gram pass. fp32 products run
without TF32, as the reference's ``Precision.HIGHEST``.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.operator import BlockedScores, LazyBlockedScores

__all__ = ["StreamingGram", "accumulate_gram"]

MODES = ("real", "complex", "real_part")


def _piece_blocks(piece) -> tuple:
    """A piece — dense (n, m_b) tensor, ``BlockedScores`` or lazy — as a
    tuple of (n, m_b) tensors."""
    if isinstance(piece, LazyBlockedScores):
        piece = piece.materialize()
    if isinstance(piece, BlockedScores):
        return piece.blocks
    piece = torch.as_tensor(piece)
    if piece.ndim == 1:
        piece = piece[:, None]
    return (piece,)


def _acc_dtype(dtype: torch.dtype, mode: str) -> torch.dtype:
    floor = torch.complex64 if mode == "complex" else torch.float32
    return torch.promote_types(dtype, floor)


class StreamingGram:
    """W = Σ S_piece·S_piece† over parameter-axis pieces, fp32+ accumulated.

    Args:
      n: dual-space dimension (the sample count; twice it when feeding
        complex scores in real_part mode).
      mode: "real" | "complex" | "real_part". Complex pieces build a
        Hermitian complex64+ W; in real_part mode complex pieces are
        realified ([Re; Im] along the sample axis) first.
      dtype: accumulator dtype floor (promoted to ≥ fp32 / complex64).
      device: where W lives; CUDA unless the caller asks for another.
    """

    def __init__(self, n: int, *, mode: str = "real",
                 dtype: torch.dtype = torch.float32, device=None,
                 _W: Optional[torch.Tensor] = None, _m: int = 0):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        self.n = int(n)
        self.mode = mode
        if _W is None:
            _W = torch.zeros((self.n, self.n), dtype=_acc_dtype(dtype, mode),
                             device=resolve_device(device))
        self.W = _W
        self.m = _m                      # columns folded in so far

    def _blocks(self, piece):
        for b in _piece_blocks(piece):
            if self.mode == "real_part" and b.is_complex():
                b = torch.cat([b.real, b.imag], dim=0)
            if b.shape[0] != self.n:
                raise ValueError(f"piece has {b.shape[0]} dual rows, "
                                 f"accumulator has n={self.n}")
            b = b.to(device=self.W.device, dtype=self.W.dtype)
            yield b, (b.mH if self.mode == "complex" else b.mT)

    def update(self, piece) -> "StreamingGram":
        """Fold one piece in: W + S_piece·S_piece† (per block of a blocked
        piece). Returns a new accumulator; the caller may drop ``piece``."""
        W, m = self.W, self.m
        for b, bt in self._blocks(piece):
            W = W + b @ bt
            m += b.shape[1]
        return StreamingGram(self.n, mode=self.mode, _W=W, _m=m)

    def downdate(self, piece) -> "StreamingGram":
        """Remove a piece's contribution (the retiring half of a sliding
        block window): W − S_piece·S_piece†."""
        W, m = self.W, self.m
        for b, bt in self._blocks(piece):
            W = W - b @ bt
            m -= b.shape[1]
        return StreamingGram(self.n, mode=self.mode, _W=W, _m=m)

    def gram(self) -> torch.Tensor:
        """The accumulated undamped (n, n) Gram."""
        return self.W

    def factorize(self, S, damping, **kw):
        """``chol_factorize`` with the Gram pass skipped: S (dense or
        blocked) is still needed for the solve's two passes, but its
        O(n²·m) contraction never reruns."""
        from repro_torch.core.solvers import chol_factorize
        return chol_factorize(S, damping, W=self.W, **kw)

    def __repr__(self):
        return (f"StreamingGram(n={self.n}, mode={self.mode!r}, "
                f"m_folded={self.m})")


def accumulate_gram(pieces: Iterable, *, n: Optional[int] = None,
                    mode: str = "real", dtype: torch.dtype = torch.float32,
                    device=None) -> torch.Tensor:
    """One-shot fold: W = Σ over an iterable of pieces (dense chunks,
    ``BlockedScores``, or lazy builders materialized one at a time). W
    lives on ``device``, by default the first piece's."""
    acc = None
    for piece in pieces:
        if acc is None:
            b0 = _piece_blocks(piece)[0]
            if n is None:
                n = 2 * b0.shape[0] if (mode == "real_part"
                                        and b0.is_complex()) else b0.shape[0]
            acc = StreamingGram(n, mode=mode, dtype=dtype,
                                device=b0.device if device is None else device)
        acc = acc.update(piece)
    if acc is None:
        raise ValueError("no pieces to accumulate")
    return acc.gram()
