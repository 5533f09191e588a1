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

A train step that already holds S in column slabs (``launch.train``)
passes them as they are: ``sharded_chol_solve_slabs`` takes per-position
slabs and returns per-position x, and ``ShardedScores`` carries the slabs
through ``NaturalGradient`` to it, so no flat (n, m) S is built on one
position to be split again.
"""
from __future__ import annotations

import functools
from typing import List, Sequence

import torch

from repro_torch.core.operator import BlockedScores, is_blocked, materialize
from repro_torch.core.solvers import _op_matvec, _op_rmatvec, real_scalar
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh, all_gather, psum

__all__ = ["ShardedScores", "make_sharded_solver",
           "sharded_blocked_chol_solve", "sharded_chol_solve",
           "sharded_chol_solve_2d", "sharded_chol_solve_slabs",
           "takes_sharded"]


def _split(t: torch.Tensor, count: int, dim: int) -> tuple:
    return torch.tensor_split(t, count, dim=dim) if count > 1 else (t,)


def _place(parts, devices) -> list:
    """Each part, contiguous, on its position's device (the kernels read
    whole rows)."""
    return [p.to(d).contiguous() for p, d in zip(parts, devices)]


def _dual_solve_slabs(S_pos: Sequence[Sequence[torch.Tensor]],
                      v_pos: Sequence[Sequence[torch.Tensor]],
                      damping, *, mode=None, W=None, jitter: float = 0.0,
                      return_gram: bool = False):
    """Algorithm 1 over position-local slabs: ``S_pos[p]`` the blocks of
    position p (each (n, m_pb)), ``v_pos[p]`` their right-hand sides
    ((m_pb,) or (m_pb, k)). Returns x in the same nesting. ``W``: a cached
    undamped Gram (n, n) fp32: the pass over the slabs then forms only u
    (``sv_cross``), as ``CholFactorization`` re-damps a cached W;
    ``jitter`` joins λ on the diagonal only; ``return_gram``: return (x,
    the undamped W) — the streaming policy's refresh keeps it."""
    for blocks in S_pos:
        for b in blocks:
            if b.is_complex():
                raise TypeError("the sharded solver is real-only, as the "
                                "kernels")
    lam = real_scalar(damping, torch.float32)
    multi = v_pos[0][0].ndim == 2
    cached = W is not None
    W_parts, u_parts = [], []
    for blocks, vs in zip(S_pos, v_pos):
        Wp = u = None
        for b, vb in zip(blocks, vs):
            if cached or multi:
                if not cached:
                    Wp = ops.gram(b, mode=mode) if Wp is None \
                        else ops.gram_acc(b, Wp, mode=mode)
                ub = ops.sv_cross(b, vb, mode=mode)
            else:
                Wp, ub = ops.gram_sv(b, vb, W=Wp, mode=mode)
            u = ub if u is None else u + ub
        W_parts.append(Wp)
        u_parts.append(u)
    u = psum(u_parts)
    if cached:
        W = W.to(u.device)
    else:
        W = psum(W_parts)                   # replicated n×n from here on
    Wd = W.clone() if cached or return_gram else W
    Wd.diagonal().add_(real_scalar(lam + jitter, torch.float32))
    L = ops.cholesky(Wd, mode=mode)
    w = ops.trisolve(L, u, mode=mode)
    out = []
    for blocks, vs in zip(S_pos, v_pos):
        wd = w.to(blocks[0].device)
        apply = ops.serve_apply if multi else ops.ngd_apply
        out.append([apply(b, wd, vb, lam, mode=mode).to(vb.dtype)
                    for b, vb in zip(blocks, vs)])
    return (out, W) if return_gram else out


def sharded_chol_solve_slabs(S_pos, v_pos, damping, *, mode=None) -> list:
    """Algorithm 1 over per-position column slabs: ``S_pos[p]`` is
    position p's slab (n, m_p), or its list of blocks [(n, m_pb), ...],
    on p's device; ``v_pos[p]`` its right-hand side in the same form
    ((m_p,) or (m_p, k) a slab). Returns x per position, in that form.
    Per slab one ``gram_sv`` (the accumulator of the position's later
    blocks) and one ``ngd_apply``; one ``psum`` of the n×n Gram, one
    replicated ``cholesky`` and substitution."""
    if len(S_pos) != len(v_pos):
        raise ValueError(f"{len(S_pos)} slabs of S, {len(v_pos)} of v")
    whole = [isinstance(s, torch.Tensor) for s in S_pos]
    S_n = [[s] if one else list(s) for s, one in zip(S_pos, whole)]
    v_n = [[v] if one else list(v) for v, one in zip(v_pos, whole)]
    for blocks, vs in zip(S_n, v_n):
        if len(blocks) != len(vs) or any(
                b.shape[1] != vb.shape[0] for b, vb in zip(blocks, vs)):
            raise ValueError("each slab of S needs a piece of v as wide")
    x = _dual_solve_slabs(S_n, v_n, damping, mode=mode)
    return [xp[0] if one else xp for xp, one in zip(x, whole)]


def takes_sharded(solver) -> bool:
    """Whether ``solver`` takes a ``ShardedScores`` as it is: its
    ``takes_sharded`` attribute, or that of the function a
    ``functools.partial`` wraps."""
    return bool(getattr(getattr(solver, "func", solver), "takes_sharded",
                        False))


class ShardedScores:
    """S held as column slabs over a mesh's positions, the form a
    sharded train step builds: ``slabs[p]`` is position p's list of
    blocks (one block for a dense S), each (n, m_pb) on p's device. Block
    b's columns are its slabs' in position order. ``NaturalGradient``
    hands it to its streaming curvature policy or to a solver that takes
    it (``takes_sharded``: Algorithm 1, ``chol_solve`` and
    ``ops.chol_solve_fused``), which run per slab; any other solver gets
    ``gather()``."""

    def __init__(self, slabs, *, blocked: bool, names=None):
        self.slabs = [list(blocks) for blocks in slabs]
        self.blocked = bool(blocked)
        self.names = names
        if not self.blocked and any(len(b) != 1 for b in self.slabs):
            raise ValueError("a dense ShardedScores holds one block a slab")

    @property
    def n(self) -> int:
        return self.slabs[0][0].shape[0]

    @property
    def block_widths(self) -> tuple:
        return tuple(sum(blocks[b].shape[1] for blocks in self.slabs)
                     for b in range(len(self.slabs[0])))

    @property
    def shape(self) -> tuple:
        return (self.n, sum(self.block_widths))

    @property
    def dtype(self) -> torch.dtype:
        return self.slabs[0][0].dtype

    @property
    def device(self) -> torch.device:
        return self.slabs[0][0].device

    def split(self, v) -> list:
        """A right-hand side (flat, or per block for a blocked S) as the
        positions' pieces, each on its position's device."""
        v_blocks = tuple(v) if self.blocked else (v,)
        out = [[] for _ in self.slabs]
        for b, vb in enumerate(v_blocks):
            widths = [blocks[b].shape[1] for blocks in self.slabs]
            for p, piece in enumerate(torch.split(vb, widths)):
                out[p].append(piece.to(self.slabs[p][b].device).contiguous())
        return out

    def join(self, x_pos):
        """The inverse of ``split``: per-position pieces gathered, on the
        first position's device."""
        blocks = tuple(all_gather([xp[b] for xp in x_pos], dim=0)
                       for b in range(len(x_pos[0])))
        return blocks if self.blocked else blocks[0]

    def gather(self):
        """S whole on the first position's device: a tensor, or a
        ``BlockedScores`` for a blocked S."""
        blocks = [all_gather([slab[b] for slab in self.slabs], dim=1)
                  for b in range(len(self.slabs[0]))]
        return BlockedScores(blocks, names=self.names) if self.blocked \
            else blocks[0]

    def solve(self, v, damping, *, mode=None):
        """x of (SᵀS + λI)x = v by ``sharded_chol_solve_slabs``, in v's
        form, on the first position's device."""
        return self.join(sharded_chol_solve_slabs(
            self.slabs, self.split(v), damping, mode=mode))

    def solve_with_gram(self, v, damping, *, W=None, jitter: float = 0.0,
                        mode=None):
        """(x, the undamped Gram W): with ``W`` (a cached Gram) the slabs'
        pass forms only u, one ``sv_cross`` a slab; without it one
        ``gram_sv`` a slab forms both. The streaming curvature policy's
        solve."""
        x, W = _dual_solve_slabs(self.slabs, self.split(v), damping,
                                 mode=mode, W=W, jitter=jitter,
                                 return_gram=True)
        return self.join(x), W

    def residual(self, v, x, damping) -> torch.Tensor:
        """‖(SᵀS + λI)x − v‖/‖v‖ over the slabs (plain products, widened a
        column chunk at a time as ``core.solvers.residual``), the sums in
        position order."""
        v_pos, x_pos = self.split(v), self.split(x)
        Sx = psum([sum(_op_matvec(b, xb) for b, xb in zip(blocks, xs))
                   for blocks, xs in zip(self.slabs, x_pos)])
        r2, v2 = [], []
        for blocks, vs, xs in zip(self.slabs, v_pos, x_pos):
            Sxd = Sx.to(blocks[0].device)
            r2.append(sum(torch.sum(torch.square(
                _op_rmatvec(b, Sxd, mode="real") + damping * xb - vb))
                for b, vb, xb in zip(blocks, vs, xs)))
            v2.append(sum(torch.sum(torch.square(vb)) for vb in vs))
        return torch.sqrt(psum(r2)) / torch.sqrt(psum(v2))


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
