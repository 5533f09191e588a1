"""Parameter trees: nested dicts, lists and tuples of tensors.

The port's counterpart of the ``jax.tree_util`` calls the JAX package
makes. Leaves come in ``jax.tree_util``'s flatten order — dict keys
sorted, sequences in order, ``None`` an empty subtree — so a blocked
vector, the score blocks and the optimizer state line up leaf for leaf
with the JAX package's pytrees (``{"w1", "b1", ...}`` flattens as
``b1, ..., w1, ...``, not in insertion order). A path is a tuple of
``("dict", key)`` / ``("seq", index)`` steps.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device

__all__ = ["keystr", "leaves", "leaves_with_path", "params_from_arrays",
           "params_to_arrays", "pathstr", "tree_map", "unflatten_like"]

Path = Tuple[Tuple[str, Any], ...]
_END = object()


def _children(tree):
    """[(step, child)] of an inner node, or None for a leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [(("dict", k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(("seq", i), c) for i, c in enumerate(tree)]
    return None


def leaves_with_path(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """[(path, leaf)] in flatten order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for step, child in kids:
        out.extend(leaves_with_path(child, prefix + (step,)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def keystr(path: Path) -> str:
    """``jax.tree_util.keystr`` of the path: ``"['w1']"``, ``"['a'][0]"``."""
    return "".join(f"[{k!r}]" if kind == "dict" else f"[{k}]"
                   for kind, k in path)


def pathstr(path: Path) -> str:
    """``str`` of the JAX key path: ``"(DictKey(key='w1'),)"``."""
    items = [f"DictKey(key={k!r})" if kind == "dict" else f"SequenceKey(idx={k})"
             for kind, k in path]
    return "(" + ", ".join(items) + ("," if len(items) == 1 else "") + ")"


def unflatten_like(tree, new_leaves):
    """``tree``'s structure with its leaves replaced, in flatten order."""
    it = iter(new_leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        if node is None:
            return None
        if isinstance(node, dict):
            return {step[1]: build(child) for step, child in kids}
        rebuilt = [build(child) for _, child in kids]
        if isinstance(node, tuple):
            return type(node)(*rebuilt) if hasattr(node, "_fields") \
                else tuple(rebuilt)
        return rebuilt

    out = build(tree)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of each same-shaped ``rest``."""
    cols = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees have different numbers of leaves")
    return unflatten_like(tree, [fn(*xs) for xs in zip(*cols)])


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes, as jax.device_get gives
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def params_from_arrays(tree, *, device=None):
    """A tree of numpy arrays (e.g. ``jax.device_get`` of the JAX package's
    parameters) → the same tree of tensors on ``device`` (CUDA by default),
    with the same names, shapes (the JAX layout: ``w1`` stays (d_in,
    width)), dtypes and flatten order."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), tree)


def params_to_arrays(params):
    """A tree of tensors → the same tree of numpy arrays on the host; bf16
    leaves widen to fp32 (exact), since numpy has no bf16 of its own."""
    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(host, params)
