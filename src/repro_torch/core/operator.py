"""Blocked score-matrix operator — S as per-layer blocks, never flat.

Port of ``repro/core/operator.py``. Algorithm 1 only touches S through
three block-separable contractions,

    gram:     W = S·Sᵀ   = Σ_b  S_b · S_bᵀ          (n, n)
    matvec:   u = S·v    = Σ_b  S_b · v_b           (n,) / (n, k)
    rmatvec:  y = Sᵀ·w   = [S_bᵀ · w  for b]        blocked (m_b,) pieces

so S can stay a sequence of per-layer (n, m_b) blocks end to end.
Parameter-space vectors are plain tuples of per-block tensors.
Accumulation is fp32 or wider whatever the storage dtype.
``LazyBlockedScores`` defers building the blocks to their first use.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import pytree

__all__ = ["BlockedScores", "LazyBlockedScores", "ScoreOperator",
           "as_blocked_vector", "block_norm", "is_blocked"]

BlockedVector = Tuple[torch.Tensor, ...]


def acc_dtype(*dtypes: torch.dtype) -> torch.dtype:
    """fp32-or-wider accumulation dtype of the operands (storage may be
    bf16, accumulation never is)."""
    return functools.reduce(torch.promote_types, dtypes, torch.float32)


def ct(A: torch.Tensor, mode: str) -> torch.Tensor:
    """Transpose, or conjugate-transpose in complex mode."""
    return A.mH if mode == "complex" else A.mT


class BlockedScores:
    """Score matrix S (n, m) stored as ordered per-layer (n, m_b) blocks.
    ``names`` are optional per-block labels, e.g. parameter-leaf paths."""

    def __init__(self, blocks: Sequence[torch.Tensor],
                 names: Optional[Sequence[str]] = None):
        blocks = tuple(blocks)
        if not blocks:
            raise ValueError("BlockedScores needs at least one block")
        self.blocks = blocks
        self.names = tuple(names) if names is not None else None

    @property
    def n(self) -> int:
        return self.blocks[0].shape[0]

    @property
    def m(self) -> int:
        return sum(b.shape[1] for b in self.blocks)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.m)

    @property
    def block_widths(self) -> tuple[int, ...]:
        return tuple(b.shape[1] for b in self.blocks)

    @property
    def dtype(self) -> torch.dtype:
        return functools.reduce(torch.promote_types,
                                [b.dtype for b in self.blocks])

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    def __repr__(self):
        return (f"BlockedScores(n={self.n}, m={self.m}, "
                f"blocks={len(self.blocks)}, dtype={self.dtype})")

    def astype(self, dtype: torch.dtype) -> "BlockedScores":
        return BlockedScores([b.to(dtype) for b in self.blocks],
                             names=self.names)

    def realify(self) -> "BlockedScores":
        """Paper §3 real-part transform per block: S_b ← [Re S_b; Im S_b]."""
        return BlockedScores(
            [torch.cat([b.real, b.imag], dim=0) for b in self.blocks],
            names=self.names)

    def to_dense(self) -> torch.Tensor:
        """Concatenate to the flat (n, m) tensor (tests and oracles only)."""
        return torch.cat(self.blocks, dim=1)

    @classmethod
    def from_dense(cls, S: torch.Tensor, widths: Sequence[int],
                   names: Optional[Sequence[str]] = None) -> "BlockedScores":
        """Split a flat window into blocks. Each block is a contiguous copy,
        as the kernels read blocks row-major."""
        if sum(widths) != S.shape[1]:
            raise ValueError(f"widths {tuple(widths)} don't sum to m={S.shape[1]}")
        return cls([p.contiguous() for p in torch.split(S, list(widths), dim=1)],
                   names=names)

    @classmethod
    def from_grads_pytree(cls, tree) -> "BlockedScores":
        """Blocks from a per-sample-gradient tree: each leaf (n, *shape)
        becomes an (n, prod(shape)) block, in flatten order (dict keys
        sorted, as ``jax.tree_util`` orders them); names are the JAX key
        paths' ``str``, as the reference writes them."""
        pairs = pytree.leaves_with_path(tree)
        return cls([leaf.reshape(leaf.shape[0], -1) for _, leaf in pairs],
                   names=[pytree.pathstr(p) for p, _ in pairs])

    def split(self, v: torch.Tensor) -> BlockedVector:
        """Split a flat (m,) or (m, k) tensor into matching blocks."""
        if v.shape[0] != self.m:
            raise ValueError(f"vector length {v.shape[0]} != m={self.m}")
        return tuple(torch.split(v, list(self.block_widths), dim=0))

    @staticmethod
    def concat(v_blocks: BlockedVector) -> torch.Tensor:
        return torch.cat(tuple(v_blocks), dim=0)

    def gram(self, *, mode: str = "real") -> torch.Tensor:
        """W = S·Sᵀ (S·S† in complex mode), accumulated fp32+ across blocks
        without concatenating."""
        acc = acc_dtype(self.dtype)
        W = None
        for b in self.blocks:
            b = b.to(acc)
            Wb = b @ ct(b, mode)
            W = Wb if W is None else W + Wb
        return W

    def matvec(self, v: Union[torch.Tensor, BlockedVector]) -> torch.Tensor:
        """u = S·v, fp32+ accumulation. ``v`` flat (m,)/(m, k) or blocked."""
        v_blocks = self.split(v) if not isinstance(v, (tuple, list)) else v
        acc = acc_dtype(self.dtype, *(vb.dtype for vb in v_blocks))
        u = None
        for b, vb in zip(self.blocks, v_blocks):
            ub = b.to(acc) @ vb.to(acc)
            u = ub if u is None else u + ub
        return u

    def rmatvec(self, w: torch.Tensor, *, mode: str = "real") -> BlockedVector:
        """y = Sᵀ·w (S†·w in complex mode), returned blocked."""
        acc = acc_dtype(self.dtype, w.dtype)
        w = w.to(acc)
        return tuple(ct(b.to(acc), mode) @ w for b in self.blocks)


class LazyBlockedScores:
    """Deferred ``BlockedScores``: holds a builder and materializes the
    blocks on first use (then caches them). The builder typically wraps
    the per-sample-gradient pass (``repro_torch.optim.lazy_score_blocks``);
    it may return a ``BlockedScores`` or a gradient tree."""

    def __init__(self, builder: Callable[[], Any]):
        self._builder = builder
        self._cached: Optional[BlockedScores] = None

    def materialize(self) -> BlockedScores:
        if self._cached is None:
            blocks = self._builder()
            if not isinstance(blocks, BlockedScores):
                blocks = BlockedScores.from_grads_pytree(blocks)
            self._cached = blocks
        return self._cached

    def __getattr__(self, name):
        # only for attributes this class lacks: gram, matvec, shape, ...
        return getattr(self.materialize(), name)


# Either concrete or lazy blocked scores — what solvers dispatch on.
ScoreOperator = (BlockedScores, LazyBlockedScores)


def is_blocked(S) -> bool:
    """True if ``S`` is a blocked score operator rather than a dense tensor."""
    return isinstance(S, ScoreOperator)


def materialize(S):
    """``S`` with a lazy operator built; anything else unchanged."""
    return S.materialize() if isinstance(S, LazyBlockedScores) else S


def as_blocked_vector(S: BlockedScores, v) -> tuple[BlockedVector, bool]:
    """Normalize a right-hand side against operator ``S``: returns
    ``(v_blocks, was_flat)`` so a solver can hand back the form it got."""
    if isinstance(v, (tuple, list)):
        widths = tuple(b.shape[0] for b in v)
        if widths != S.block_widths:
            raise ValueError(
                f"blocked vector widths {widths} != operator widths "
                f"{S.block_widths}")
        return tuple(v), False
    return S.split(v), True


def block_norm(v_blocks: BlockedVector) -> torch.Tensor:
    """Global 2-norm over a blocked vector (fp32+)."""
    sq = sum(torch.sum((b * b.conj()).real.to(torch.float32))
             for b in v_blocks)
    return torch.sqrt(sq)
