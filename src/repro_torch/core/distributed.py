"""Algorithm 1 with the score window sharded over a mesh (torch port of
``repro/core/distributed.py``).

The paper (§3) notes that the algorithm shares RVB+23's parallelization.
One process drives every position of the mesh (``launch.mesh``):

* **Parameter-axis sharding (1d)** — position j holds the column slab
  S_j : (n, m_j) and v_j. The Gram and S·v are sums of per-slab terms,
  one ``psum`` each; the n×n Cholesky and the substitution are
  replicated (O(n³) ≪ O(n²·m_j)); the apply x_j = (v_j − S_jᵀw)/λ is
  local to the slab.
* **Sample and parameter sharding (2d)** — S split over (data, model);
  each column slab gathers its sample pieces (``all_gather``, n·m_j
  words), then the 1d path.
* **Blocked** — per-layer blocks, each column-sharded; every position
  accumulates its slab of every block before the one n² sum.

Per slab each term is a kernel, as in ``ops.chol_solve_fused``: for one
right-hand side ``gram_sv`` (one pass for W and u, its W the accumulator
of the position's later blocks) and ``ngd_apply``; for k of them ``gram``
/ ``gram_acc``, ``sv_cross`` and ``serve_apply``. The replicated n×n work
is ``ops.cholesky`` and ``ops.trisolve``. A CUDA slab takes the kernels,
a CPU slab their plain versions. An m (or n) that does not divide the
mesh splits into slabs that differ by one column (``torch.tensor_split``;
the reference's ``shard_map`` needs even shards). Real windows only, as
the kernels.
"""
from __future__ import annotations

import functools
from typing import List, Sequence

import torch

from repro_torch.core.operator import is_blocked, materialize
from repro_torch.core.solvers import real_scalar
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh, all_gather, psum

__all__ = ["make_sharded_solver", "sharded_blocked_chol_solve",
           "sharded_chol_solve", "sharded_chol_solve_2d"]


def _split(t: torch.Tensor, count: int, dim: int) -> tuple:
    return torch.tensor_split(t, count, dim=dim) if count > 1 else (t,)


def _place(parts, devices) -> list:
    """Each part, contiguous, on its position's device (the kernels read
    whole rows)."""
    return [p.to(d).contiguous() for p, d in zip(parts, devices)]


def _dual_solve_slabs(S_pos: Sequence[Sequence[torch.Tensor]],
                      v_pos: Sequence[Sequence[torch.Tensor]],
                      damping, *, mode=None) -> List[List[torch.Tensor]]:
    """Algorithm 1 over position-local slabs: ``S_pos[p]`` the blocks of
    position p (each (n, m_pb)), ``v_pos[p]`` their right-hand sides
    ((m_pb,) or (m_pb, k)). Returns x in the same nesting."""
    for blocks in S_pos:
        for b in blocks:
            if b.is_complex():
                raise TypeError("the sharded solver is real-only, as the "
                                "kernels")
    lam = real_scalar(damping, torch.float32)
    multi = v_pos[0][0].ndim == 2
    W_parts, u_parts = [], []
    for blocks, vs in zip(S_pos, v_pos):
        W = u = None
        for b, vb in zip(blocks, vs):
            if multi:
                W = ops.gram(b, mode=mode) if W is None \
                    else ops.gram_acc(b, W, mode=mode)
                ub = ops.sv_cross(b, vb, mode=mode)
            else:
                W, ub = ops.gram_sv(b, vb, W=W, mode=mode)
            u = ub if u is None else u + ub
        W_parts.append(W)
        u_parts.append(u)
    W = psum(W_parts)                       # replicated n×n from here on
    u = psum(u_parts)
    W.diagonal().add_(lam)
    L = ops.cholesky(W, mode=mode)
    w = ops.trisolve(L, u, mode=mode)
    out = []
    for blocks, vs in zip(S_pos, v_pos):
        wd = w.to(blocks[0].device)
        apply = ops.serve_apply if multi else ops.ngd_apply
        out.append([apply(b, wd, vb, lam, mode=mode).to(vb.dtype)
                    for b, vb in zip(blocks, vs)])
    return out


def _model_devices(mesh: Mesh, model_axis: str, extra_sum_axes, **fixed):
    """The positions a parameter slab is laid on: ``extra_sum_axes`` then
    the model axis, jointly (the parameter axis sharded over all of
    them)."""
    return mesh.axis_devices(tuple(extra_sum_axes) + (model_axis,), **fixed)


def sharded_chol_solve(S: torch.Tensor, v: torch.Tensor, damping, *,
                       mesh: Mesh, model_axis: str = "model",
                       extra_sum_axes: tuple = (), mode=None
                       ) -> torch.Tensor:
    """Algorithm 1 with S (n, m) column-sharded over ``model_axis`` (and
    ``extra_sum_axes``, jointly). ``v`` (m,) or (m, k) is split the same
    way; the result is x whole, on the first position's device. ``mode``
    is ``ops``'s kernel mode."""
    devices = _model_devices(mesh, model_axis, extra_sum_axes)
    S_pos = [[s] for s in _place(_split(S, len(devices), 1), devices)]
    v_pos = [[p] for p in _place(_split(v, len(devices), 0), devices)]
    x = _dual_solve_slabs(S_pos, v_pos, damping, mode=mode)
    return all_gather([xp[0] for xp in x], dim=0)


def sharded_chol_solve_2d(S: torch.Tensor, v: torch.Tensor, damping, *,
                          mesh: Mesh, data_axis: str = "data",
                          model_axis: str = "model",
                          extra_sum_axes: tuple = (), mode=None
                          ) -> torch.Tensor:
    """Algorithm 1 with S split over (samples → ``data_axis``, params →
    ``model_axis``). Each column slab first gathers its sample pieces onto
    its data-row-0 position (the reference's tiled ``all_gather``; every
    data row then holds the same slab, so the sums run over the model
    axis only), then the 1d path. ``v`` and x are split over the model
    axis."""
    cols = _model_devices(mesh, model_axis, extra_sum_axes)
    n_data = mesh.shape[data_axis]
    S_pos = []
    for j, piece in enumerate(_split(S, len(cols), 1)):
        rows = [r.to(d).contiguous() for r, d in zip(
            _split(piece, n_data, 0),
            [_model_devices(mesh, model_axis, extra_sum_axes,
                            **{data_axis: i})[j] for i in range(n_data)])]
        S_pos.append([all_gather(rows, dim=0, device=cols[j])])
    v_pos = [[p] for p in _place(_split(v, len(cols), 0), cols)]
    x = _dual_solve_slabs(S_pos, v_pos, damping, mode=mode)
    return all_gather([xp[0] for xp in x], dim=0)


def sharded_blocked_chol_solve(S, v_blocks, damping, *, mesh: Mesh,
                               model_axis: str = "model",
                               extra_sum_axes: tuple = (), mode=None):
    """Algorithm 1 on a ``BlockedScores`` whose blocks are each
    column-sharded over ``model_axis``: every position accumulates its
    slab of every block before the one n² sum, so no flat (n, m) array
    exists anywhere. ``v_blocks``: the per-block right-hand sides; the
    result keeps the block structure (each block whole)."""
    S = materialize(S)
    if not is_blocked(S):
        raise TypeError("sharded_blocked_chol_solve needs a BlockedScores; "
                        "use sharded_chol_solve for dense S")
    v_blocks = tuple(v_blocks)
    devices = _model_devices(mesh, model_axis, extra_sum_axes)
    count = len(devices)
    S_split = [_place(_split(b, count, 1), devices) for b in S.blocks]
    v_split = [_place(_split(vb, count, 0), devices) for vb in v_blocks]
    S_pos = [[blk[p] for blk in S_split] for p in range(count)]
    v_pos = [[blk[p] for blk in v_split] for p in range(count)]
    x = _dual_solve_slabs(S_pos, v_pos, damping, mode=mode)
    return tuple(all_gather([x[p][b] for p in range(count)], dim=0)
                 for b in range(len(S.blocks)))


def make_sharded_solver(mesh: Mesh, *, layout: str = "1d",
                        data_axis: str = "data", model_axis: str = "model",
                        extra_sum_axes: tuple = ()):
    """``solve(S, v, λ) -> x`` closed over a mesh and a layout:
    "1d" (S sharded over params, the RVB+23 strategy), "2d" (over samples
    and params) or "blocked" (per-layer ``BlockedScores``, each block
    column-sharded)."""
    if layout == "blocked":
        return functools.partial(sharded_blocked_chol_solve, mesh=mesh,
                                 model_axis=model_axis,
                                 extra_sum_axes=extra_sum_axes)
    if layout == "1d":
        return functools.partial(sharded_chol_solve, mesh=mesh,
                                 model_axis=model_axis,
                                 extra_sum_axes=extra_sum_axes)
    if layout == "2d":
        return functools.partial(sharded_chol_solve_2d, mesh=mesh,
                                 data_axis=data_axis, model_axis=model_axis,
                                 extra_sum_axes=extra_sum_axes)
    raise ValueError(f"unknown layout {layout!r}")
