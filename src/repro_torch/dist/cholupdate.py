"""Distributed rank-k Cholesky maintenance of the sharded window (torch
port of ``repro/dist/cholupdate.py``).

Every maintenance operation of the replicated window algebra
(``repro_torch.serve.adapt``) splits into two kinds of work:

* **m-sized passes over S** — the Gram cross columns ``cols = S·rows†``
  of a fold: the only O(n·m·k) work. Each slab runs ``ops.fold_cols``
  (the CUDA kernel on the card), and the per-slab columns are summed in
  position order (``psum``); in 2d each data row's partial columns are
  gathered (``all_gather``).
* **n-sized factor algebra** — the 2k×2k replacement core and the rank-k
  update of the replicated factor, O(n²·k), exactly the replicated fold's
  (``replacement_core``, the core split in float64 on the host with the
  rows' finiteness flag, ``chol_downdate(chol_update(L, X), Y)``).

The new rows then land in each position's slab. The full refresh runs
``ops.gram``/``ops.gram_acc`` per slab and ``ops.cholesky`` on the summed
Gram.

The rank-k update with the update columns themselves sharded comes in
the reference's two methods:

* ``method="composed"`` — each slab solves P_j = L⁻¹X_j; the n×n core
  P·P† = Σ_j P_j·P_j† is one sum, then L·chol(Ĩ ± P·P†) (``ops.cholesky``);
* ``method="rotations"`` — a ring of rank-1 sweeps: the factor stays put
  while the column slabs move one hop (``ppermute``) after each sweep;
  after as many hops as positions every position has swept every column.
  The sweeps are ``ops.cholupdate`` (the rotation kernel on the card; its
  plain version on the CPU). Positions sweep the slabs in different
  cyclic orders but, the factor with a positive diagonal being unique,
  agree to rounding; the first position's factor is returned.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.operator import acc_dtype
from repro_torch.core.solvers import cholesky
from repro_torch.curvature.update import (chol_downdate, chol_update,
                                          replacement_core, signed_split)
from repro_torch.dist.state import (DistSpec, ShardedWindow, _check_layout,
                                    is_sharded, shard_window, split_columns)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh, all_gather, ppermute, psum

__all__ = ["make_sharded_fold", "make_sharded_refresh",
           "sharded_chol_downdate", "sharded_chol_update",
           "sharded_window_cols"]


# ---------------------------------------------------------------------------
# rank-k update/downdate with the update columns themselves sharded
# ---------------------------------------------------------------------------

def _sharded_rank_k(L, X, *, mesh: Mesh, model_axis: str, method: str,
                    sign: int, eps: float) -> torch.Tensor:
    if method not in ("composed", "rotations"):
        raise ValueError(f"method must be 'composed' or 'rotations', "
                         f"got {method!r}")
    L, X = torch.as_tensor(L), torch.as_tensor(X)
    if X.ndim == 1:
        X = X[:, None]
    dtype = acc_dtype(L.dtype, X.dtype)
    L, X = L.to(dtype), X.to(dtype)
    devices = mesh.axis_devices((model_axis,))
    size = len(devices)
    pad = (-X.shape[1]) % size
    if pad:                     # zero columns are exact no-ops in both methods
        X = torch.cat([X, X.new_zeros((X.shape[0], pad))], dim=1)
    slabs = [p.to(d).contiguous()
             for p, d in zip(torch.tensor_split(X, size, dim=1), devices)]
    if method == "composed":
        parts = []
        for Xj in slabs:
            Pj = torch.linalg.solve_triangular(L.to(Xj.device), Xj,
                                               upper=False)
            parts.append(Pj @ Pj.mH)
        core = psum(parts)
        n = L.shape[0]
        M = torch.eye(n, dtype=dtype, device=core.device) + sign * core
        return L.to(core.device) @ (cholesky(M) if M.is_complex()
                                    else ops.cholesky(M))
    # the ring, from the first position: its own slab, then each hop's
    del eps             # the rotation kernel clamps r² at 1e-30 itself
    L = L.to(devices[0])
    for _ in range(size):
        L = ops.cholupdate(L, slabs[0].to(L.device), sign=sign)
        slabs = ppermute(slabs, devices)
    return L


def sharded_chol_update(L, X, *, mesh: Mesh, model_axis: str = "model",
                        method: str = "composed", eps: float = 1e-30):
    """L' = chol(L·L† + X·X†) with X (n, k) column-sharded over
    ``model_axis``; L replicated in and out."""
    return _sharded_rank_k(L, X, mesh=mesh, model_axis=model_axis,
                           method=method, sign=+1, eps=eps)


def sharded_chol_downdate(L, X, *, mesh: Mesh, model_axis: str = "model",
                          method: str = "composed", eps: float = 1e-30):
    """L' = chol(L·L† − X·X†), sharded like ``sharded_chol_update``."""
    return _sharded_rank_k(L, X, mesh=mesh, model_axis=model_axis,
                           method=method, sign=-1, eps=eps)


# ---------------------------------------------------------------------------
# the m-sized pass: Gram cross columns of incoming rows, per slab
# ---------------------------------------------------------------------------

def _row_blocks(rows) -> tuple:
    return tuple(rows) if isinstance(rows, (tuple, list)) else (rows,)


def _window_rows(window: ShardedWindow, rows) -> list:
    """Fold rows (per block, padded and cast to the window) as slab
    pieces: ``out[b][j]`` (k, m_bj), contiguous on slab j's device."""
    from repro_torch.serve.adapt import pad_to_window_cols
    padded = pad_to_window_cols(window, rows, axis=1)
    return [[p.contiguous() for p in blk]
            for blk in split_columns(window, _row_blocks(padded), axis=1)]


def _cols(window: ShardedWindow, row_pieces):
    """(cols, corner) = (S·rows†, rows·rows†), fp32 or wider: per data
    row, the sum over slabs (and blocks) of each piece's ``fold_cols``,
    the data rows' columns then gathered; the corner of data row 0."""
    spec = window.spec
    home = spec.home
    col_rows, corner = [], None
    for i in range(len(window.pieces[0])):
        parts, corners = [], []
        for j in range(spec.m_mult):
            cj = kj = None
            for b, blk in enumerate(window.pieces):
                c, k = ops.fold_cols(
                    blk[i][j], row_pieces[b][j].to(blk[i][j].device))
                cj = c if cj is None else cj + c
                kj = k if kj is None else kj + k
            parts.append(cj)
            corners.append(kj)
        col_rows.append(psum(parts))
        if corner is None:
            corner = psum(corners)
    return all_gather(col_rows, dim=0, device=home), corner.to(home)


def sharded_window_cols(S, rows, *, mesh: Mesh, layout: str = "1d",
                        model_axis: str = "model", data_axis: str = "data",
                        mode: str = "real"):
    """Replicated ``(cols, corner)`` = ``(S·rows†, rows·rows†)`` of a
    window laid out on ``mesh`` (a ``ShardedWindow``, or a whole window,
    which is split first): the O(n·m·k) input the replicated factor
    algebra consumes. The rows are cast to the window's dtype first."""
    _check_layout(layout)
    window = S if is_sharded(S) else shard_window(
        S, DistSpec(mesh, layout, model_axis=model_axis,
                    data_axis=data_axis))
    del mode            # the cross pass is the same in every mode
    cols, corner = _cols(window, _window_rows(window, rows))
    return cols[:window.n], corner


# ---------------------------------------------------------------------------
# the FIFO window fold, distributed end to end
# ---------------------------------------------------------------------------

class ShardedFold:
    """The distributed FIFO fold ``(S, W, L, slot, rows) -> (S', W', L',
    slot')`` of one layout (``make_sharded_fold``): the twin of the
    replicated ``serve.adapt._fold_window``. ``S`` a ``ShardedWindow`` (a
    whole window is laid out first and gathered back). The old window is
    left intact: every slab a fold writes to is copied."""

    def __init__(self, spec: DistSpec, *, method: str,
                 fifo_n: Optional[int]):
        self.spec = spec
        self.method = method
        self.fifo_n = fifo_n

    def __call__(self, S, W, L, slot: int, rows):
        window = S if is_sharded(S) else shard_window(S, self.spec)
        out = self.apply(window, W, L, slot, rows)
        if out is None:
            raise ValueError("fold rows hold a NaN or an Inf")
        Sp, Wp, Lp, slot2, _ = out
        return (Sp if is_sharded(S) else Sp.gather(S.device)), Wp, Lp, slot2

    def apply(self, window: ShardedWindow, W, L, slot: int, rows, *,
              with_aux: bool = False):
        """(S', W', L', slot', aux), or None when the rows hold a NaN/Inf
        (the fold is rejected); ``aux`` the downdate's ``DowndateAux``
        when ``with_aux``."""
        n = W.shape[0] if self.fifo_n is None else self.fifo_n
        pieces = _window_rows(window, rows)
        k = pieces[0][0].shape[0]
        home = W.device
        idx = (torch.arange(k, device=home) + slot) % n
        finite = torch.stack([torch.isfinite(p).all().to(home)
                              for blk in pieces for p in blk]).all()
        cols, corner = _cols(window, pieces)
        acc = acc_dtype(W.dtype)
        cols = cols.to(acc)
        cols[idx, :] = corner.to(acc)
        U, core, Wp = replacement_core(W, cols, idx)
        host = torch.cat([finite.to(core.dtype).reshape(1),
                          core.reshape(-1)]).cpu()
        if not bool(host[0]):
            return None
        X, Y = signed_split(U, host[1:].reshape(core.shape))
        aux = None
        if with_aux:
            Lp, aux = chol_downdate(chol_update(L, X, method=self.method), Y,
                                    method=self.method, return_aux=True)
        else:
            Lp = chol_downdate(chol_update(L, X, method=self.method), Y,
                               method=self.method)
        return (self._write_rows(window, pieces, idx.tolist()), Wp, Lp,
                (slot + k) % n, aux)

    @staticmethod
    def _write_rows(window: ShardedWindow, pieces, idx) -> ShardedWindow:
        """The window with row ``idx[r]`` of every slab replaced by fold row
        r: each piece holding a replaced row is copied and written, the
        others shared."""
        offs = window.row_offsets()
        new = []
        for b, blk in enumerate(window.pieces):
            rows_out = []
            for i, row in enumerate(blk):
                lo, hi = offs[i], offs[i] + row[0].shape[0]
                local = [(r, g - lo) for r, g in enumerate(idx)
                         if lo <= g < hi]
                if not local:
                    rows_out.append(row)
                    continue
                src = torch.tensor([r for r, _ in local])
                dst = torch.tensor([g for _, g in local])
                out_row = []
                for j, p in enumerate(row):
                    q = p.clone()
                    q[dst.to(p.device)] = \
                        pieces[b][j][src.to(p.device)].to(p.device, p.dtype)
                    out_row.append(q)
                rows_out.append(out_row)
            new.append(rows_out)
        return ShardedWindow(new, window.spec, blocked=window.blocked,
                             names=window.names)


def make_sharded_fold(mesh: Mesh, *, layout: str = "1d",
                      model_axis: str = "model", data_axis: str = "data",
                      mode: str = "real", method: str = "composed",
                      fifo_n: Optional[int] = None) -> ShardedFold:
    """The distributed FIFO fold for a window laid out like
    ``make_sharded_solver(layout=...)``: S sharded, the factor and the
    FIFO slot replicated. ``fifo_n`` pins the FIFO modulus to the logical
    sample count of a 2d window padded in its sample axis. ``mode`` is
    taken for the reference's signature: the cross pass and the factor
    algebra are the same in every mode."""
    del mode
    _check_layout(layout)
    spec = DistSpec(mesh, layout, model_axis=model_axis, data_axis=data_axis)
    return ShardedFold(spec, method=method, fifo_n=fifo_n)


# ---------------------------------------------------------------------------
# full refresh (off the request path): per-slab Grams, the replicated chol
# ---------------------------------------------------------------------------

class ShardedRefresh:
    """``(S, lam) -> (W, L)`` of one layout (``make_sharded_refresh``)."""

    def __init__(self, spec: DistSpec, *, mode: str, jitter: float):
        self.spec = spec
        self.mode = mode
        self.jitter = float(jitter)

    def __call__(self, S, lam):
        window = S if is_sharded(S) else shard_window(S, self.spec)
        home = self.spec.home
        parts = []
        for j in range(self.spec.m_mult):
            Wj = None
            for blk in window.pieces:
                # 2d: the slab's sample pieces gathered, as the reference's
                # all_gather, so the Gram holds the cross-piece products
                slab = all_gather([row[j] for row in blk], dim=0)
                if self.mode == "complex":
                    g = slab @ slab.mH
                    Wj = g if Wj is None else Wj + g
                else:
                    Wj = ops.gram(slab) if Wj is None \
                        else ops.gram_acc(slab, Wj)
            parts.append(Wj)
        W = psum(parts).to(home)
        Wd = W.clone()
        Wd.diagonal().add_(float(lam) + self.jitter)
        L = cholesky(Wd) if self.mode == "complex" else ops.cholesky(Wd)
        return W, L


def make_sharded_refresh(mesh: Mesh, *, layout: str = "1d",
                         model_axis: str = "model", data_axis: str = "data",
                         mode: str = "real",
                         jitter: float = 0.0) -> ShardedRefresh:
    """The distributed full refactorization ``(S, lam) -> (W, L)``: the
    O(n²·m) Gram per slab with one n² sum, the O(n³) Cholesky replicated
    — the split of the sharded solvers in ``core.distributed``."""
    _check_layout(layout)
    spec = DistSpec(mesh, layout, model_axis=model_axis, data_axis=data_axis)
    return ShardedRefresh(spec, mode=mode, jitter=jitter)
