"""Device meshes and their collectives (port of ``repro/launch/mesh.py``).

The port drives a mesh from one process, as the reference does: one
server and one program address every position, where the reference runs
``shard_map`` over ``jax.make_mesh``. A ``Mesh`` is its shape, its axis
names and one explicit ``torch.device`` per position. Positions may share
a device: the CPU tests lay every position on the CPU, and one card can
hold a mesh of several positions.

The collectives are plain functions over the per-position tensors of one
axis, in position order:

* ``psum`` — the sum, taken on the first position's device in position
  order (never with float atomics), so a repeated call is bit-identical;
* ``all_gather`` — the tiled gather, ``torch.cat`` in position order;
* ``ppermute`` — the rotation of the list by one position along a ring.

``torch.distributed`` is not used: NCCL takes one rank per GPU, so a
multi-process mesh could not lay more than one position on a card.

Inside ``counting_collectives()`` (the dry run) each collective over more
than one position is counted under the reference's HLO op name, with its
per-position bytes and ring wire bytes by the reference's rule
(``launch/hlo_analysis.py``): an all-reduce moves 2·B·(k−1)/k, an
all-gather B·(k−1)/k, a permute B. Outside it nothing is counted.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

__all__ = ["DATA", "MODEL", "POD", "Mesh", "all_gather",
           "counting_collectives", "dp_axes", "make_mesh",
           "make_production_mesh", "mesh_from_shape", "ppermute", "psum",
           "record_collective"]

POD, DATA, MODEL = "pod", "data", "model"
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_counts: Optional[dict] = None


@contextlib.contextmanager
def counting_collectives():
    """Count the collectives run inside the block; yields
    {op: {"count", "bytes", "wire_bytes"}} for the ops of ``COLLECTIVES``,
    filled as they run."""
    global _counts
    saved, _counts = _counts, {c: {"count": 0, "bytes": 0.0,
                                   "wire_bytes": 0.0} for c in COLLECTIVES}
    try:
        yield _counts
    finally:
        _counts = saved


def record_collective(kind: str, nbytes: float, k: int) -> None:
    """Count one ``kind`` collective over ``k`` positions whose result is
    ``nbytes`` a position, when counting is on and k > 1."""
    if _counts is None or k < 2:
        return
    wire = {"all-reduce": 2 * nbytes * (k - 1) / k,
            "collective-permute": nbytes}.get(kind, nbytes * (k - 1) / k)
    rec = _counts[kind]
    rec["count"] += 1
    rec["bytes"] += nbytes
    rec["wire_bytes"] += wire


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Mesh:
    """A named grid of positions, each with its ``torch.device``.

    ``shape`` maps each axis name to its size, in axis order (as
    ``jax.sharding.Mesh.shape`` does); ``devices`` is the nested list of
    devices, indexed by position coordinates."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence[torch.device]):
        sizes = tuple(int(s) for s in shape)
        names = tuple(str(a) for a in axis_names)
        if len(sizes) != len(names):
            raise ValueError(f"mesh shape {sizes} does not match its axes "
                             f"{names}")
        if len(set(names)) != len(names):
            raise ValueError(f"mesh axes repeat a name: {names}")
        if any(s < 1 for s in sizes):
            raise ValueError(f"mesh sizes must be >= 1, got {sizes}")
        devices = [torch.device(d) for d in devices]
        count = 1
        for s in sizes:
            count *= s
        if len(devices) != count:
            raise ValueError(f"a {sizes} mesh has {count} positions; got "
                             f"{len(devices)} devices")
        self.axis_names: Tuple[str, ...] = names
        self.shape: Dict[str, int] = dict(zip(names, sizes))
        self._flat: Tuple[torch.device, ...] = tuple(devices)

    @property
    def size(self) -> int:
        return len(self._flat)

    @property
    def devices(self) -> list:
        """The devices as a nested list over the axes."""
        def nest(flat, sizes):
            if len(sizes) == 1:
                return list(flat)
            step = len(flat) // sizes[0]
            return [nest(flat[i * step:(i + 1) * step], sizes[1:])
                    for i in range(sizes[0])]
        return nest(self._flat, tuple(self.shape.values()))

    def device(self, **coords: int) -> torch.device:
        """The device of the position at ``coords`` (axis name → index;
        axes not named are at 0)."""
        for name in coords:
            if name not in self.shape:
                raise ValueError(f"mesh has no {name!r} axis: "
                                 f"{self.axis_names}")
        flat = 0
        for name in self.axis_names:
            i = int(coords.get(name, 0))
            if not 0 <= i < self.shape[name]:
                raise IndexError(f"{name}={i} outside the mesh's "
                                 f"{self.shape[name]}")
            flat = flat * self.shape[name] + i
        return self._flat[flat]

    def coords(self) -> List[Dict[str, int]]:
        """Every position's coordinates (axis name → index), in position
        order."""
        return [dict(zip(self.axis_names, idx)) for idx in
                itertools.product(*(range(s) for s in self.shape.values()))]

    def axis_devices(self, axes: Iterable[str], **fixed: int
                     ) -> List[torch.device]:
        """Devices of the positions along ``axes`` (jointly, the first
        axis major), the other axes at ``fixed`` (default 0)."""
        axes = tuple(axes)
        ranges = [range(self.shape[a]) for a in axes]
        return [self.device(**fixed, **dict(zip(axes, idx)))
                for idx in itertools.product(*ranges)]

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, devices="
                f"{sorted({str(d) for d in self._flat})})")


def make_mesh(shape, axes, *, device=None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` named ``axes``.

    By default its positions take ``cuda:0``, ``cuda:1``, … in position
    order, and it raises when the machine has fewer cards than positions
    (as ``jax.make_mesh`` raises with fewer devices). ``device`` lays every
    position on that one device (``"cpu"``: the CPU tests; ``"cuda"``:
    several positions on one card); ``devices`` names each position's
    device, repeats allowed."""
    shape = tuple(int(s) for s in shape)
    count = 1
    for s in shape:
        count *= s
    if devices is not None:
        if device is not None:
            raise ValueError("pass device= or devices=, not both")
        devices = list(devices)
    elif device is not None:
        devices = [torch.device(device)] * count
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < count:
            raise RuntimeError(
                f"a {shape} mesh needs {count} CUDA devices, this machine "
                f"has {have}; pass device= to lay several positions on one "
                "device")
        devices = [torch.device("cuda", i) for i in range(count)]
    return Mesh(shape, axes, devices)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """Single pod: (16, 16) ("data", "model") = 256 positions.
    Multi-pod: (2, 16, 16) ("pod", "data", "model") = 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = (POD, DATA, MODEL) if multi_pod else (DATA, MODEL)
    return make_mesh(shape, axes, device=device)


def mesh_from_shape(mesh_shape: str, device=None) -> Mesh:
    """A ``--mesh-shape`` argument ("4", "2,2", "2,1,2") as a mesh with the
    reference's axes: ("data",), ("data", "model") or ("pod", "data",
    "model"). Without ``device`` the positions take a card each; with it
    they all lie on ``device``."""
    shape = tuple(int(x) for x in mesh_shape.split(","))
    axes = (DATA, MODEL)[:len(shape)] if len(shape) <= 2 \
        else (POD, DATA, MODEL)
    return make_mesh(shape, axes, device=device)


def dp_axes(mesh: Mesh) -> tuple:
    """Batch-sharding axes: ('pod', 'data') when a pod axis exists."""
    return tuple(a for a in (POD, DATA) if a in mesh.axis_names)


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of the per-position ``parts``, in position order, on the
    first position's device. Every replica would compute this same sum;
    the caller moves it where each position needs it."""
    parts = list(parts)
    record_collective("all-reduce", _nbytes(parts[0]), len(parts))
    acc = parts[0].clone()
    for p in parts[1:]:
        acc += p.to(acc.device)
    return acc


def all_gather(parts: Sequence[torch.Tensor], *, dim: int = 0,
               device=None) -> torch.Tensor:
    """The tiled gather: the parts concatenated along ``dim`` in position
    order, on ``device`` (default: the first part's)."""
    parts = list(parts)
    record_collective("all-gather", sum(map(_nbytes, parts)), len(parts))
    dev = parts[0].device if device is None else torch.device(device)
    if len(parts) == 1:
        return parts[0].to(dev)
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def ppermute(parts: Sequence[torch.Tensor],
             devices: Optional[Sequence[torch.device]] = None
             ) -> List[torch.Tensor]:
    """One hop of the ring i → i + 1: position i receives the part of
    position i − 1 (on its own device, when ``devices`` are given)."""
    parts = list(parts)
    record_collective("collective-permute", _nbytes(parts[0]), len(parts))
    rolled = parts[-1:] + parts[:-1]
    if devices is None:
        return rolled
    return [p.to(d) for p, d in zip(rolled, devices)]
