"""``ShardedServeState`` — the resident serving asset laid out on a mesh
(torch port of ``repro/dist/state.py``).

The contract mirrors the sharded solvers (``core.distributed``): the big
thing, the (n, m) score window S, is sharded — 1d over the model axis,
2d over (data, model), or per-layer blocked slabs — while everything
n-sized (the undamped Gram W, the factor L, the FIFO slot/age/stats) is
replicated. A ``DistSpec`` names that layout once; placement, the
distributed fold and refresh (``dist.cholupdate``) and the sharded
request path (``dist.server``) all read it.

One process drives every position (``launch.mesh``), so the window is
held as a ``ShardedWindow``: its pieces, one per position, each on its
position's device — block b's column slab j at data row i. A layout
replicated over an axis (1d and blocked over a data axis) keeps one copy,
on the positions at index 0 of that axis, and the n-sized state lives on
the mesh's first position: every replica would hold the same values.

Uneven windows zero-pad to the mesh at init (``pad_window_to_mesh``):
zero columns and zero sample rows are exact no-ops in the Gram and the
rank-k sweeps. ``widths`` and ``n_logical`` keep the logical sizes; the
server pads right-hand sides and un-pads solutions against them.

Checkpoints keep the reference's leaves — whole arrays, the padded
window gathered — so a sharded checkpoint written by either package
restores in the other, onto any mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.operator import BlockedScores, is_blocked, materialize
from repro_torch.launch.mesh import Mesh, all_gather, psum
from repro_torch.serve.state import (ServeState, _window_to,
                                     init_serve_state, save_serve_state,
                                     serve_mode,
                                     serve_state_from_tree, serve_state_tree)

__all__ = ["DistSpec", "ShardedServeState", "ShardedWindow", "ceil_to",
           "init_sharded_serve_state", "pad_axis", "pad_window_to_mesh",
           "place_serve_state", "restore_sharded_serve_state",
           "save_sharded_serve_state", "shard_window", "sharded_serve_mode"]

LAYOUTS = ("1d", "2d", "blocked")


def _check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; have {LAYOUTS}")


def ceil_to(x: int, mult: int) -> int:
    return -(-int(x) // int(mult)) * int(mult) if mult > 1 else int(x)


def pad_axis(x: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    """``x`` zero-padded along ``axis`` to ``size`` (itself when it has
    that size already)."""
    if x.shape[axis] == size:
        return x
    shape = list(x.shape)
    shape[axis] = size - x.shape[axis]
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


@dataclasses.dataclass(frozen=True)
class DistSpec:
    """A mesh plus the window layout (as ``make_sharded_solver``'s)."""
    mesh: Mesh
    layout: str = "1d"            # "1d" | "2d" | "blocked"
    model_axis: str = "model"
    data_axis: str = "data"

    def __post_init__(self):
        _check_layout(self.layout)
        if self.layout == "2d" and self.data_axis not in self.mesh.axis_names:
            raise ValueError(f"layout='2d' needs a {self.data_axis!r} mesh "
                             f"axis; mesh has {self.mesh.axis_names}")
        if self.model_axis not in self.mesh.axis_names:
            raise ValueError(f"mesh has no {self.model_axis!r} axis: "
                             f"{self.mesh.axis_names}")

    # -- positions ---------------------------------------------------------
    def device(self, i: int = 0, j: int = 0) -> torch.device:
        """The device holding row piece ``i``, column slab ``j``."""
        coords = {self.model_axis: j}
        if self.layout == "2d":
            coords[self.data_axis] = i
        return self.mesh.device(**coords)

    @property
    def home(self) -> torch.device:
        """The first position's device: where the replicated n-sized state
        and the psums live."""
        return self.device(0, 0)

    # -- uneven-shard padding ----------------------------------------------
    @property
    def m_mult(self) -> int:
        """Column slabs of every block: the model axis's size."""
        return int(self.mesh.shape[self.model_axis])

    @property
    def n_mult(self) -> int:
        """Sample-axis multiple, and the window's row pieces: the data
        axis's size in 2d, else 1."""
        return int(self.mesh.shape[self.data_axis]) \
            if self.layout == "2d" else 1

    def padded_m(self, m: int) -> int:
        return ceil_to(m, self.m_mult)

    def padded_n(self, n: int) -> int:
        return ceil_to(n, self.n_mult)


class ShardedWindow:
    """The score window as its per-position pieces.

    ``pieces[b][i][j]``: block b's rows of data piece i and columns of
    slab j, on ``spec.device(i, j)`` (one block for a dense window, one
    row piece outside the 2d layout). Pieces of one slab have equal
    widths up to one column (``torch.tensor_split``); a window padded by
    ``pad_window_to_mesh`` splits evenly."""

    def __init__(self, pieces, spec: DistSpec, *, blocked: bool = False,
                 names: Optional[Tuple[str, ...]] = None):
        self.pieces = tuple(tuple(tuple(row) for row in blk)
                            for blk in pieces)
        self.spec = spec
        self.blocked = bool(blocked)
        self.names = names

    # -- shape ---------------------------------------------------------------
    @property
    def n(self) -> int:
        return sum(row[0].shape[0] for row in self.pieces[0])

    @property
    def block_widths(self) -> Tuple[int, ...]:
        return tuple(sum(p.shape[1] for p in blk[0]) for blk in self.pieces)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, sum(self.block_widths))

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0][0][0].dtype

    @property
    def device(self) -> torch.device:
        return self.pieces[0][0][0].device

    def __repr__(self):
        return (f"ShardedWindow({self.spec.layout}, shape={self.shape}, "
                f"blocks={len(self.pieces)}, dtype={self.dtype})")

    def row_offsets(self) -> Tuple[int, ...]:
        """First window row of each data piece."""
        offs, at = [], 0
        for row in self.pieces[0]:
            offs.append(at)
            at += row[0].shape[0]
        return tuple(offs)

    def col_ranges(self, b: int = 0) -> Tuple[Tuple[int, int], ...]:
        """(start, stop) columns of block ``b``'s slabs."""
        out, at = [], 0
        for p in self.pieces[b][0]:
            out.append((at, at + p.shape[1]))
            at += p.shape[1]
        return tuple(out)

    def slab_pieces(self):
        """Every piece with its (block, row piece, slab) index."""
        for b, blk in enumerate(self.pieces):
            for i, row in enumerate(blk):
                for j, p in enumerate(row):
                    yield (b, i, j), p

    def templates(self) -> Tuple[torch.Tensor, ...]:
        """One empty (0, width) tensor per block, of the window's dtype on
        its first device: what ``pad_to_window_cols`` reads of a block."""
        return tuple(torch.empty((0, w), dtype=self.dtype,
                                 device=self.device)
                     for w in self.block_widths)

    def cross(self, rows, fn) -> torch.Tensor:
        """The (n, k) sum over blocks and slabs of ``fn(piece, rows
        piece)`` for each data row piece, the row pieces gathered on the
        first device. ``rows``: (k, m_b) per block, zero-padded here to
        the window's widths."""
        from repro_torch.serve.adapt import pad_to_window_cols
        rows = pad_to_window_cols(self, rows, axis=1, cast=False)
        row_pieces = split_columns(
            self, tuple(rows) if isinstance(rows, (tuple, list)) else (rows,),
            axis=1)
        out = []
        for i in range(len(self.pieces[0])):
            parts = []
            for j in range(self.spec.m_mult):
                acc = None
                for b, blk in enumerate(self.pieces):
                    p = blk[i][j]
                    t = fn(p, row_pieces[b][j].to(p.device))
                    acc = t if acc is None else acc + t
                parts.append(acc)
            out.append(psum(parts))
        return all_gather(out, dim=0, device=self.device)

    def gather(self, device=None):
        """The whole window (a tensor, or ``BlockedScores`` for a blocked
        one) on ``device`` (default: the first piece's), written piece by
        piece into one buffer."""
        dev = self.device if device is None else torch.device(device)
        offs = self.row_offsets()
        blocks = []
        for b, blk in enumerate(self.pieces):
            cols = self.col_ranges(b)
            if len(blk) == 1 and len(cols) == 1:
                blocks.append(blk[0][0].to(dev))
                continue
            out = torch.empty((self.n, self.block_widths[b]),
                              dtype=self.dtype, device=dev)
            for i, row in enumerate(blk):
                for (a, z), p in zip(cols, row):
                    out[offs[i]:offs[i] + p.shape[0], a:z].copy_(p)
            blocks.append(out)
        if self.blocked:
            return BlockedScores(blocks, names=self.names)
        return blocks[0]


def is_sharded(S) -> bool:
    return isinstance(S, ShardedWindow)


def shard_window(S, spec: DistSpec) -> ShardedWindow:
    """Lay a whole window (tensor or ``BlockedScores``) on ``spec``'s mesh:
    contiguous pieces on each position's device (views where a piece is
    the whole block on its own device). A ``ShardedWindow`` passes
    through."""
    if is_sharded(S):
        return S
    S = materialize(S)
    blocked = is_blocked(S)
    src = S.blocks if blocked else (S,)
    pieces = []
    for blk in src:
        rows = torch.tensor_split(blk, spec.n_mult, dim=0) \
            if spec.n_mult > 1 else (blk,)
        pieces.append([
            [p.to(spec.device(i, j)).contiguous()
             for j, p in enumerate(torch.tensor_split(r, spec.m_mult, dim=1)
                                   if spec.m_mult > 1 else (r,))]
            for i, r in enumerate(rows)])
    return ShardedWindow(pieces, spec, blocked=blocked,
                         names=S.names if blocked else None)


def split_columns(window: ShardedWindow, values, *, axis: int):
    """Per-block, per-slab pieces of ``values`` (one (k, m_b) or
    (m_b, k) tensor per block, already padded to the window's widths),
    each on its slab's device at data row 0: ``out[b][j]``."""
    out = []
    for b, v in enumerate(values):
        slabs = []
        for j, (a, z) in enumerate(window.col_ranges(b)):
            piece = v.narrow(axis, a, z - a)
            slabs.append(piece.to(window.spec.device(0, j)))
        out.append(slabs)
    return out


def pad_window_to_mesh(S, spec: DistSpec):
    """Zero-pad a score window so its axes divide ``spec``'s mesh.

    Parameter columns pad to a multiple of the model-axis size (per block
    for a blocked window); for the 2d layout the sample axis pads to the
    data-axis size too. The pad rows are zero samples that the FIFO never
    folds over (``n_logical`` → ``fifo_n``), so they stay zero.

    Returns ``(S_padded, widths)``: ``widths`` the logical per-block
    column counts ((m,) for dense)."""
    S = materialize(S)
    if is_blocked(S):
        widths = tuple(int(b.shape[1]) for b in S.blocks)
        blocks = tuple(pad_axis(b, 1, spec.padded_m(b.shape[1]))
                       for b in S.blocks)
        if all(b is o for b, o in zip(blocks, S.blocks)):
            return S, widths
        return BlockedScores(blocks, names=S.names), widths
    widths = (int(S.shape[1]),)
    S = pad_axis(S, 1, spec.padded_m(S.shape[1]))
    S = pad_axis(S, 0, spec.padded_n(S.shape[0]))
    return S, widths


class ShardedServeState:
    """A ``ServeState`` whose window is a ``ShardedWindow``, with its
    ``DistSpec``. Field reads delegate to the wrapped state.

    ``widths``: logical per-block column counts before zero padding
    (None: the stored shapes are the logical ones). ``n_logical``: the
    sample count before 2d padding — the FIFO modulus (None: the stored
    count)."""

    def __init__(self, state: ServeState, spec: DistSpec,
                 widths: Optional[tuple] = None,
                 n_logical: Optional[int] = None):
        self.state = state
        self.spec = spec
        self.widths = None if widths is None \
            else tuple(int(w) for w in widths)
        self.n_logical = None if n_logical is None else int(n_logical)

    def __getattr__(self, name):
        if name == "state":
            raise AttributeError(name)
        return getattr(self.state, name)

    def _replace(self, **kw) -> "ShardedServeState":
        return ShardedServeState(self.state._replace(**kw), self.spec,
                                 self.widths, self.n_logical)

    @property
    def padded(self) -> bool:
        """True when the stored window carries zero pad columns."""
        if self.widths is None:
            return False
        S = self.state.S
        stored = S.block_widths if is_sharded(S) else \
            tuple(int(b.shape[1])
                  for b in (S.blocks if is_blocked(S) else (S,)))
        return any(s != w for s, w in zip(stored, self.widths))


def place_serve_state(state: ServeState, spec: DistSpec) -> ServeState:
    """The state laid out per the contract: the window as pieces on their
    positions, the n-sized state on the first position."""
    home = spec.home
    return state._replace(S=shard_window(state.S, spec), W=state.W.to(home),
                          L=state.L.to(home))


def init_sharded_serve_state(S, damping, *, spec: DistSpec,
                             jitter: float = 0.0, mode: str = "auto",
                             window_dtype=None,
                             device=None) -> ShardedServeState:
    """Build the resident state and lay it out on the mesh. The seeding
    Gram runs once on the whole padded window (``init_serve_state``, on
    ``device`` or the window's); every later refresh is the sharded
    per-slab sum (``make_sharded_refresh``). The window need not divide
    the mesh: it is zero-padded, and the logical widths ride on the
    returned state."""
    S = _window_to(materialize(S), device)
    if spec.layout == "blocked" and not is_blocked(S):
        raise ValueError("layout='blocked' needs a BlockedScores window; "
                         "use layout='1d' for dense S")
    if spec.layout != "blocked" and is_blocked(S):
        raise ValueError(f"layout={spec.layout!r} needs a dense window; "
                         "use layout='blocked' for BlockedScores")
    n0 = int(S.shape[0])
    S, widths = pad_window_to_mesh(S, spec)
    state = init_serve_state(S, damping, jitter=jitter, mode=mode,
                             window_dtype=window_dtype, device=device)
    del S
    n_logical = n0 if int(state.W.shape[0]) != n0 else None
    return ShardedServeState(place_serve_state(state, spec), spec, widths,
                             n_logical)


def save_sharded_serve_state(ckpt_dir, step: int, state: ShardedServeState,
                             *, metadata: Optional[dict] = None,
                             keep: int = 3):
    """Checkpoint the plain leaves (the gathered window; placement is not
    data — a restore may target another mesh)."""
    meta = {"layout": state.spec.layout, **(metadata or {})}
    return save_serve_state(ckpt_dir, step, state.state, metadata=meta,
                            keep=keep)


def _template(state: ServeState) -> ServeState:
    """``state`` with a whole-window template of no storage in place of
    its window: the structure a checkpoint restores into."""
    S = state.S
    if not is_sharded(S):
        return state
    blocks = [torch.empty((S.n, w), dtype=S.dtype, device="meta")
              for w in S.block_widths]
    return state._replace(S=BlockedScores(blocks, names=S.names)
                          if S.blocked else blocks[0])


def restore_sharded_serve_state(ckpt_dir, step: int, like: ShardedServeState,
                                *, spec: Optional[DistSpec] = None):
    """Restore (a checkpoint of either package) and lay it on ``spec``'s
    mesh (default: ``like``'s). Returns (state, metadata)."""
    from repro_torch.checkpoint import checkpoint as ckpt
    spec = like.spec if spec is None else spec
    tmpl = _template(like.state)
    tree, meta = ckpt.restore(ckpt_dir, step, serve_state_tree(tmpl),
                              device="cpu")
    restored = serve_state_from_tree(tree, tmpl)
    return ShardedServeState(place_serve_state(restored, spec), spec,
                             like.widths, like.n_logical), meta


def sharded_serve_mode(state) -> str:
    """``serve_mode`` for either state flavour."""
    return serve_mode(state.state if isinstance(state, ShardedServeState)
                      else state)
