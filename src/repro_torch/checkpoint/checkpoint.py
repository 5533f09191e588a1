"""Checkpointing: atomic, resumable (port of ``repro/checkpoint/checkpoint.py``).

Layout (one directory per step), the reference's byte for byte::

    <dir>/step_000000120/
        MANIFEST.json        # step, treedef, n_leaves, metadata, leaves[{shape, dtype}]
        leaf_00000.npy ...   # one .npy per leaf, in flatten order
    <dir>/step_000000120.tmp/   # staging dir — renamed when complete

* **Atomicity** — writes go to ``.tmp``; the manifest is fsynced and the
  directory renamed only then, so a crash mid-write never corrupts the
  latest checkpoint.
* **Keep-last-k** — older steps are pruned after a successful save.
* **Both packages** — leaves are written in ``jax.tree_util``'s flatten
  order (``repro_torch.core.pytree``: dict keys sorted, NamedTuple fields
  in declaration order), bf16 as its ``uint16`` view, so a parameter
  checkpoint written by either package restores in the other.

``restore`` takes ``device=`` where the reference takes target
shardings: the port runs on one device.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
from typing import Optional

import numpy as np
import torch

from repro_torch.core.pytree import leaves, unflatten_like

__all__ = ["save", "restore", "latest_step", "all_steps"]


def treedef_str(tree) -> str:
    """The structure of ``tree`` as ``str(jax.tree_util.tree_structure)``
    writes it: ``PyTreeDef({'a': *, 'b': [*, (*, *)]})``. Descriptive
    only: ``restore`` reads the structure from its ``like``."""
    def node(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                    + ", ".join(node(c) for c in t) + "])")
        if isinstance(t, tuple):
            inner = ", ".join(node(c) for c in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        if isinstance(t, list):
            return "[" + ", ".join(node(c) for c in t) + "]"
        return "*"
    return f"PyTreeDef({node(tree)})"


def _host(leaf) -> tuple[np.ndarray, str]:
    """(the array written to disk, its dtype in the manifest); bf16, which
    numpy has not of its own, is written as its uint16 view."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir, step: int, tree, *, metadata: Optional[dict] = None,
         keep: int = 3) -> pathlib.Path:
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:09d}"
    tmp = ckpt_dir / f"step_{step:09d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    ls = leaves(tree)
    manifest = {
        "step": step,
        "treedef": treedef_str(tree),
        "n_leaves": len(ls),
        "metadata": metadata or {},
        "leaves": [],
    }
    for i, leaf in enumerate(ls):
        arr, dtype = _host(leaf)
        np.save(tmp / f"leaf_{i:05d}.npy", arr)
        manifest["leaves"].append({"shape": list(arr.shape),
                                   "dtype": dtype})
    with open(tmp / "MANIFEST.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)

    # prune
    for old in all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{old:09d}", ignore_errors=True)
    return final


def all_steps(ckpt_dir) -> list[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for p in ckpt_dir.iterdir():
        if p.is_dir() and p.name.startswith("step_") \
                and not p.name.endswith(".tmp") \
                and (p / "MANIFEST.json").exists():
            out.append(int(p.name[5:]))
    return sorted(out)


def latest_step(ckpt_dir) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _leaf_like(arr: np.ndarray, dtype: str, ref, device):
    """The stored array as a leaf of ``ref``'s kind: a tensor of ``ref``'s
    dtype (on ``device``, else on ``ref``'s device), a numpy array of its
    dtype, or a Python number."""
    if isinstance(ref, np.ndarray):
        return arr.astype(ref.dtype)
    if isinstance(ref, torch.Tensor):
        if dtype == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.as_tensor(arr)
        return t.to(device=ref.device if device is None else device,
                    dtype=ref.dtype)
    return type(ref)(arr.item())


def restore(ckpt_dir, step: int, like, *, device=None):
    """Restore into the structure of ``like`` (a tree of tensors, numpy
    arrays and Python numbers; its leaves give each restored leaf its kind
    and dtype).
    ``device``: where tensor leaves go (default: each ``like`` leaf's
    device). Returns (tree, metadata)."""
    path = pathlib.Path(ckpt_dir) / f"step_{step:09d}"
    manifest = json.loads((path / "MANIFEST.json").read_text())
    leaves_like = leaves(like)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(f"{path} holds {manifest['n_leaves']} leaves; the "
                         f"tree to restore into has {len(leaves_like)}")
    out = []
    for i, ref in enumerate(leaves_like):
        arr = np.load(path / f"leaf_{i:05d}.npy")
        expect = manifest["leaves"][i]
        if list(arr.shape) != expect["shape"]:
            raise ValueError(f"leaf {i}: shape {list(arr.shape)} on disk, "
                             f"{expect['shape']} in the manifest")
        out.append(_leaf_like(arr, expect["dtype"], ref, device))
    return unflatten_like(like, out), manifest["metadata"]
