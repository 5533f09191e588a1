"""Per-sample score matrices — the S in (SᵀS + λI)x = v.

Port of ``repro/optim/scores.py``: ``S[i, j] = (1/√n)·∂ log P_θ(x_i)/∂θ_j``
(paper §2), built with ``torch.func.vmap`` of the gradient of ``logp_fn``
over the batch (``grad_and_value``: ``torch.func.grad`` without its
graph of the backward pass). ``logp_fn(params, example)`` takes a tree of parameters (dicts
of tensors) and one example (each leaf of ``batch`` has a leading sample
axis). The native form is blocked: one (n, m_b) block per parameter leaf,
in ``jax.tree_util``'s flatten order (dict keys sorted) with its ``keystr``
names, so blocked vectors and gradients line up with the reference's.
``chunk`` runs the batch in sample chunks (a Python loop), bounding the
memory of the backward pass to one chunk's. Numpy inputs become tensors
on ``device`` (CUDA by default); tensors stay where they are.

Also the matrix-free Fisher matvec (for CG) from ``jvp``/``vjp``.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import numpy as np
import torch
from torch import func

from repro_torch.core.device import resolve_device
from repro_torch.core.operator import BlockedScores, LazyBlockedScores
from repro_torch.core.pytree import (keystr, leaves, leaves_with_path,
                                     tree_map, unflatten_like)

__all__ = ["flatten_like", "grad_and_value", "lazy_score_blocks",
           "make_fisher_matvec", "per_sample_score_blocks",
           "per_sample_scores"]


def flatten_like(params):
    """(flat, unravel) for a parameter tree, as ``ravel_pytree``: leaves
    concatenated in flatten order in their promoted dtype; ``unravel``
    restores the shapes and, where the leaves' dtypes differ, each leaf's
    dtype. Where they share one dtype ``unravel`` keeps the dtype of what
    it is given (``ravel_pytree``'s dtype-polymorphic unravel), so an fp32
    natural gradient of a bf16 model stays fp32."""
    ls = leaves(params)
    dtype = functools.reduce(torch.promote_types, [p.dtype for p in ls])
    flat = torch.cat([p.reshape(-1).to(dtype) for p in ls])
    uniform = all(p.dtype == dtype for p in ls)
    shapes = [(p.shape, p.dtype, p.numel()) for p in ls]

    def unravel(x: torch.Tensor):
        out, off = [], 0
        for shape, dt, size in shapes:
            piece = x[off:off + size].reshape(shape)
            out.append(piece if uniform else piece.to(dt))
            off += size
        return unflatten_like(params, out)

    return flat, unravel


def grad_and_value(fn: Callable, *, has_aux: bool = False) -> Callable:
    """``torch.func.grad_and_value(fn, has_aux=has_aux)`` with respect to
    the first argument, its backward pass recording no graph of its own.
    ``torch.func.grad`` always asks autograd for one (``create_graph=True``,
    so that transforms nest), and that graph keeps every layer's backward
    temporaries alive to the end of the pass: 2.7 GB a Mamba2 layer for
    two 1,024-token examples, where plain autograd keeps 1.4 GB (H100).
    Nothing in the port differentiates a gradient. The gradients are the
    same to fp32 rounding; it goes under ``vmap`` as ``torch.func.grad``
    does."""
    def wrapped(params, *args):
        out = func.vjp(lambda p: fn(p, *args), params, has_aux=has_aux)
        value, vjp_fn = out[0], out[1]
        (grads,) = vjp_fn(torch.ones_like(value), retain_graph=False,
                          create_graph=False)
        return (grads, (value, out[2])) if has_aux else (grads, value)
    return wrapped


def _on_device(tree, device):
    """Numpy leaves → tensors on ``resolve_device(device)``."""
    def one(x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            resolve_device(device))
    return tree_map(one, tree)


def _per_sample_grads(logp_fn: Callable, params, batch, *,
                      chunk: Optional[int]):
    """Tree of per-sample gradients, each leaf (n, *leaf_shape)."""
    grad = grad_and_value(logp_fn)
    grads = func.vmap(lambda p, ex: grad(p, ex)[0], in_dims=(None, 0))
    n = leaves(batch)[0].shape[0]
    if chunk is None or chunk >= n:
        return grads(params, batch), n
    if n % chunk:
        raise ValueError(f"chunk={chunk} does not divide the batch of {n}")
    parts = [grads(params, tree_map(lambda x: x[i:i + chunk], batch))
             for i in range(0, n, chunk)]
    return tree_map(lambda *xs: torch.cat(xs), *parts), n


def per_sample_score_blocks(logp_fn: Callable, params, batch, *,
                            chunk: Optional[int] = None,
                            center: bool = False, dtype=None, scale=None,
                            device=None, n_total=None) -> BlockedScores:
    """Blocked S: one (n, m_b) block per parameter leaf, never
    concatenated.

    ``center`` subtracts the sample mean (SR mode, paper §3); ``dtype`` is
    the blocks' storage dtype (default: the gradients'); ``scale``
    overrides the default 1/√n row multiplier (serving uses 1/√n_window).
    ``n_total``: the n of the default 1/√n when ``batch`` is one piece of
    a larger batch (a data-parallel position's rows are divided by the
    whole batch's √n, as the single-device rows are).
    """
    params, batch = _on_device(params, device), _on_device(batch, device)
    G, n = _per_sample_grads(logp_fn, params, batch, chunk=chunk)
    root_n = torch.tensor(float(n if n_total is None else n_total)).sqrt()

    def to_block(g):
        b = g.reshape(n, -1)
        if dtype is not None:
            b = b.to(dtype)
        if center:
            b = b - b.mean(dim=0, keepdim=True)
        if scale is not None:
            return b * torch.as_tensor(scale, dtype=b.dtype)
        return b / root_n.to(b.dtype)

    pairs = leaves_with_path(G)
    return BlockedScores([to_block(g) for _, g in pairs],
                         names=[keystr(p) for p, _ in pairs])


def lazy_score_blocks(logp_fn: Callable, params, batch, *,
                      chunk: Optional[int] = None, center: bool = False,
                      dtype=None, scale=None,
                      device=None) -> LazyBlockedScores:
    """Deferred blocked S: the per-sample-gradient pass runs on first use
    (and is cached)."""
    return LazyBlockedScores(functools.partial(
        per_sample_score_blocks, logp_fn, params, batch, chunk=chunk,
        center=center, dtype=dtype, scale=scale, device=device))


def per_sample_scores(logp_fn: Callable, params, batch, *,
                      chunk: Optional[int] = None, center: bool = False,
                      dtype=None, scale=None, device=None,
                      n_total=None) -> torch.Tensor:
    """Dense S (n, m): the blocked S concatenated in flatten order (the
    order of ``flatten_like``). Baselines and oracles; prefer the blocks."""
    return per_sample_score_blocks(
        logp_fn, params, batch, chunk=chunk, center=center, dtype=dtype,
        scale=scale, device=device, n_total=n_total).to_dense()


def make_fisher_matvec(logp_fn: Callable, params, batch, *,
                       damping=0.0, device=None) -> Callable:
    """Matrix-free x ↦ (SᵀS + λI)·x on flat vectors: S·x is a ``jvp`` of
    the batched log-probability, Sᵀ(·) its ``vjp``. No S is built."""
    params, batch = _on_device(params, device), _on_device(batch, device)
    flat0, unravel = flatten_like(params)
    root_n = math.sqrt(leaves(batch)[0].shape[0])

    def batched_logp(p):
        return func.vmap(lambda ex: logp_fn(p, ex))(batch) / root_n

    def matvec(x_flat: torch.Tensor) -> torch.Tensor:
        _, Sx = func.jvp(batched_logp, (params,),
                         (unravel(x_flat.to(flat0.dtype)),))
        _, vjp = func.vjp(batched_logp, params)
        (STSx,) = vjp(Sx)
        flat, _ = flatten_like(STSx)
        return flat + torch.as_tensor(damping, dtype=flat.dtype) * x_flat

    return matvec
