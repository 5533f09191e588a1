"""``ServeState`` — the serving subsystem's resident asset (torch port of
``repro/serve/state.py``).

The n-sample score window S (dense tensor or ``BlockedScores``), its
undamped Gram W and L = chol(W + (λ₀+jitter)Ĩ) live on the device. The
host-side scalars — ``lam0``, the FIFO ``slot``, the factor ``age`` and
the ``stats`` counters — are Python numbers: the server and the
adaptation policy read them on every request and fold, and a device
scalar would make each read wait on the device.

``serve_state_arrays`` / ``serve_state_from_arrays`` use exactly the
named-array format of the JAX package (bf16 stored as uint16 with a dtype
tag), and ``save_serve_state`` / ``restore_serve_state`` its checkpoint
layout (``repro_torch.checkpoint``: the window's blocks, W, L, then the
scalars as 0-d float32/int32 leaves), so a state written by one package
loads in the other.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.operator import BlockedScores, is_blocked
from repro_torch.core.solvers import (CholFactorization, _realify, cholesky,
                                      chol_factorize, gram, real_scalar)

__all__ = ["ServeStats", "ServeState", "init_serve_state", "serve_mode",
           "as_factorization", "resolve_device", "restore_serve_state",
           "save_serve_state", "serve_state_arrays", "serve_state_from_arrays",
           "serve_state_from_tree", "serve_state_tree", "whole_window"]


class ServeStats(NamedTuple):
    """Counters carried with the state."""
    served: int = 0             # requests completed
    microbatches: int = 0       # coalesced solves executed
    adapted: int = 0            # sample rows folded into the window
    refreshes: int = 0          # full W refactorizations
    last_residual: float = -1.0  # last monitored relative residual (−1: none)


def _host(t: torch.Tensor) -> np.ndarray:
    """Host copy as numpy; bf16 as its raw uint16 bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_tag(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def whole_window(S, device=None):
    """The window as one tensor (or ``BlockedScores``): a sharded window
    (``repro_torch.dist``) gathered onto ``device`` (default: its first
    position's), any other returned as it is."""
    from repro_torch.dist.state import is_sharded
    return S.gather(device) if is_sharded(S) else S


class ServeState(NamedTuple):
    """The resident curvature window + factorization.

    ``S``: (n, m) window, dense or ``BlockedScores``. ``W``: undamped Gram
    of S. ``L``: chol(W + (lam0+jitter)Ĩ). ``lam0``: base damping (a float
    rounded to W's dtype). ``slot``: next FIFO row a fold replaces.
    ``age``: microbatches since the last full refresh.
    """
    S: Union[torch.Tensor, BlockedScores]
    W: torch.Tensor
    L: torch.Tensor
    lam0: float
    slot: int
    age: int
    stats: ServeStats

    def fingerprint(self, *, full: bool = True) -> str:
        """blake2b digest of the window/W/L buffers (shape and dtype
        tagged), byte-compatible with ``repro``'s: equal buffers hash the
        same in both packages. ``full=False`` hashes W and L only. Copies
        the buffers to the host — call it where the device already synced.
        """
        h = hashlib.blake2b(digest_size=16)
        h.update(b"full" if full else b"light")
        if full:
            S = whole_window(self.S, "cpu")
            arrs = (*(S.blocks if is_blocked(S) else (S,)), self.W, self.L)
        else:
            arrs = (self.W, self.L)
        for t in arrs:
            a = np.ascontiguousarray(_host(t))
            h.update(str(a.shape).encode())
            h.update(_dtype_tag(t).encode())
            h.update(a.view(np.uint8).reshape(-1))
        return h.hexdigest()


def _window_to(S, device):
    """Host data (numpy) → tensors on ``resolve_device(device)``; tensors
    stay where they are unless ``device`` is given."""
    def one(b):
        if isinstance(b, torch.Tensor):
            return b if device is None else b.to(resolve_device(device))
        return torch.as_tensor(np.asarray(b)).to(resolve_device(device))
    if is_blocked(S):
        return BlockedScores([one(b) for b in S.blocks], names=S.names)
    return one(S)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    wd = getattr(torch, str(dtype), None)
    if not isinstance(wd, torch.dtype):
        raise ValueError(f"unknown window_dtype {dtype!r}")
    return wd


def init_serve_state(S, damping, *, jitter: float = 0.0, mode: str = "auto",
                     window_dtype=None, device=None) -> ServeState:
    """Build the resident state: one O(n²·m) Gram pass + O(n³) Cholesky.

    ``S``: dense (n, m) window or ``BlockedScores``; numpy data goes to ``device`` (CUDA by default), tensors stay on their
    device unless ``device`` is given. ``window_dtype`` (e.g.
    ``torch.bfloat16`` or ``"bfloat16"``): storage dtype of the window; W
    and L are built, fp32-accumulated, from the rounded values. Real
    windows only (a complex window realifies via ``mode="real_part"``).
    """
    S = _window_to(S, device)
    if window_dtype is None:
        fac = chol_factorize(S, damping, mode=mode, jitter=jitter)
        return ServeState(S=fac.S, W=fac.W, L=fac.L, lam0=fac.lam, slot=0,
                          age=0, stats=ServeStats())
    wd = _torch_dtype(window_dtype)
    if not wd.is_floating_point:
        raise ValueError(f"window_dtype must be a real float dtype, got {wd}")
    if S.dtype.is_complex and mode != "real_part":
        raise ValueError(
            "low-precision window storage is real-only; use "
            "mode='real_part' (realification) for a complex score window")
    S_in, _ = _realify(S, "real_part")
    S_store = S_in.astype(wd) if is_blocked(S_in) else S_in.to(wd)
    W = gram(S_store)
    lam = real_scalar(damping, W.dtype)
    eye = torch.eye(W.shape[0], dtype=W.dtype, device=W.device)
    L = cholesky(W + real_scalar(lam + real_scalar(jitter, W.dtype),
                                 W.dtype) * eye)
    return ServeState(S=S_store, W=W, L=L, lam0=lam, slot=0, age=0,
                      stats=ServeStats())


def serve_mode(state: ServeState) -> str:
    """Resolved solver mode of the window: realification happened at
    ``init_serve_state``, so only real and complex remain."""
    return "complex" if state.S.dtype.is_complex else "real"


def as_factorization(state: ServeState, *,
                     jitter: float = 0.0) -> CholFactorization:
    """View the resident state as a ``CholFactorization`` (multi-RHS
    ``solve``, ``with_damping``, ``solve_batch``, ``update``/``downdate``)."""
    return CholFactorization(S=whole_window(state.S, state.W.device),
                             mode=serve_mode(state), W=state.W, L=state.L,
                             lam=state.lam0, jitter=jitter,
                             take_real_v=False)


# host-scalar fields and the numpy dtypes the JAX package stores them in
_SCALARS = {"lam0": np.float32, "slot": np.int32, "age": np.int32,
            "stats_served": np.int32, "stats_microbatches": np.int32,
            "stats_adapted": np.int32, "stats_refreshes": np.int32,
            "stats_last_residual": np.float32}


def serve_state_tree(state: ServeState) -> ServeState:
    """The state as the reference's pytree flattens it, for a checkpoint:
    S as the tuple of its blocks (``BlockedScores`` is a pytree of its
    blocks there), the host scalars as 0-d numpy arrays of the dtypes the
    reference holds them in."""
    def scalar(key, value):
        return np.asarray(value, _SCALARS[key])
    S = whole_window(state.S, "cpu")
    S = tuple(S.blocks) if is_blocked(S) else S
    stats = ServeStats(*(scalar(f"stats_{f}", v)
                         for f, v in zip(state.stats._fields, state.stats)))
    return ServeState(S=S, W=state.W, L=state.L,
                      lam0=scalar("lam0", state.lam0),
                      slot=scalar("slot", state.slot),
                      age=scalar("age", state.age), stats=stats)


def serve_state_from_tree(tree: ServeState, like: ServeState) -> ServeState:
    """Inverse of ``serve_state_tree`` for a tree restored into
    ``serve_state_tree(like)``: ``like``'s window layout (its blocks'
    names) and Python numbers for the host scalars."""
    def num(value, ref):
        return type(ref)(np.asarray(value).item())
    S = BlockedScores(tree.S, names=like.S.names) if is_blocked(like.S) \
        else tree.S
    stats = ServeStats(*(num(v, r) for v, r in zip(tree.stats, like.stats)))
    return ServeState(S=S, W=tree.W, L=tree.L,
                      lam0=num(tree.lam0, like.lam0),
                      slot=num(tree.slot, like.slot),
                      age=num(tree.age, like.age), stats=stats)


def save_serve_state(ckpt_dir, step: int, state: ServeState, *,
                     metadata: Optional[dict] = None, keep: int = 3):
    """Checkpoint the state (atomic, keep-last-k — see
    ``repro_torch.checkpoint``), in the reference's leaf order and
    manifest: ``metadata`` carries ``{"kind": "serve_state", "blocked":
    ...}`` plus the caller's."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.dist.state import is_sharded
    blocked = state.S.blocked if is_sharded(state.S) else is_blocked(state.S)
    meta = {"kind": "serve_state", "blocked": bool(blocked),
            **(metadata or {})}
    return ckpt.save(ckpt_dir, step, serve_state_tree(state), metadata=meta,
                     keep=keep)


def restore_serve_state(ckpt_dir, step: int, like: ServeState, *,
                        device=None):
    """Restore into the structure of ``like`` (e.g. a freshly initialized
    state of the same shapes) — a checkpoint of either package. Tensors go
    to ``device`` (default: ``like``'s). Returns (state, metadata)."""
    from repro_torch.checkpoint import checkpoint as ckpt
    tree, meta = ckpt.restore(ckpt_dir, step, serve_state_tree(like),
                              device=device)
    return serve_state_from_tree(tree, like), meta


def serve_state_arrays(state: ServeState) -> Tuple[dict, dict]:
    """Flatten a ``ServeState`` to named host arrays + a JSON-safe meta
    dict, in ``repro.serve.state.serve_state_arrays``'s format. Inverse:
    ``serve_state_from_arrays`` (of either package)."""
    S = whole_window(state.S, "cpu")
    blocks = S.blocks if is_blocked(S) else (S,)
    names = list(S.names) if is_blocked(S) and S.names is not None else None
    arrays: dict = {}
    dtypes: dict = {}
    for i, b in enumerate(blocks):
        arrays[f"S{i}"], dtypes[f"S{i}"] = _host(b), _dtype_tag(b)
    for key in ("W", "L"):
        t = getattr(state, key)
        arrays[key], dtypes[key] = _host(t), _dtype_tag(t)
    values = {"lam0": state.lam0, "slot": state.slot, "age": state.age,
              **{f"stats_{f}": v for f, v in zip(state.stats._fields,
                                                  state.stats)}}
    for key, value in values.items():
        a = np.asarray(value, _SCALARS[key])
        arrays[key], dtypes[key] = a, str(a.dtype)
    meta = {"blocked": bool(is_blocked(S)),
            "n_blocks": len(blocks), "names": names, "dtypes": dtypes}
    return arrays, meta


def serve_state_from_arrays(arrays: dict, meta: dict, *,
                            device=None) -> ServeState:
    """Rebuild a ``ServeState`` from ``serve_state_arrays`` output (either
    package's) on ``device`` (CUDA by default)."""
    dev = resolve_device(device)

    def tensor(key):
        a = np.array(arrays[key])
        if meta["dtypes"].get(key) == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(a).to(dev)

    def scalar(key):
        a = np.asarray(arrays[key])
        return float(a) if np.issubdtype(_SCALARS[key], np.floating) \
            else int(a)

    blocks = tuple(tensor(f"S{i}") for i in range(int(meta["n_blocks"])))
    names = meta.get("names")
    S = BlockedScores(blocks, names=tuple(names) if names else None) \
        if meta["blocked"] else blocks[0]
    stats = ServeStats(**{f: scalar(f"stats_{f}") for f in ServeStats._fields})
    return ServeState(S=S, W=tensor("W"), L=tensor("L"), lam0=scalar("lam0"),
                      slot=scalar("slot"), age=scalar("age"), stats=stats)
