"""Hybrid optimizer: exact NGD on a selected parameter group, AdamW on the
rest (port of ``repro/optim/hybrid.py``).

The Fisher block is solved exactly with Algorithm 1 for the parameters
where curvature matters most (the output head, the final blocks, the
embedding), while the bulk of the network uses AdamW. The score matrix
is only n × m_subset, so the memory envelope is linear in the subset's
size.

Selection is by a predicate over "/"-joined paths (``filter_fn(path) ->
bool``), built as the reference's ``path_of`` builds them from a JAX key
path, so one filter selects the same leaves in both packages. The parts
hold ``None`` where the other part's leaves are; ``core.pytree`` treats
``None`` as an empty subtree, as ``jax.tree_util`` does, so both
optimizers run on their part as on a whole tree.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

from repro_torch.core.pytree import leaves_with_path, unflatten_like
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.ngd import NaturalGradient

__all__ = ["HybridNGD", "HybridState", "merge_params", "partition_params",
           "path_of"]


def path_of(keypath) -> str:
    """A ``core.pytree`` path as the reference's ``path_of`` writes a key
    path: the dict keys and sequence indices joined by "/"."""
    return "/".join(str(k) for _, k in keypath)


def partition_params(params, filter_fn: Callable[[str], bool]):
    """Split a tree into (selected, rest), each with ``None`` placeholders
    where the other's leaves are."""
    pairs = leaves_with_path(params)
    picked = [filter_fn(path_of(p)) for p, _ in pairs]
    sel = unflatten_like(params, [x if k else None
                                  for (_, x), k in zip(pairs, picked)])
    rest = unflatten_like(params, [None if k else x
                                   for (_, x), k in zip(pairs, picked)])
    return sel, rest


def merge_params(a, b):
    """Inverse of ``partition_params``: ``a``'s structure, leaf by leaf the
    first that is not ``None`` (where ``a`` holds ``None``, ``b``'s
    subtree there)."""
    if a is None:
        return b
    if isinstance(a, dict):
        return {k: merge_params(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        merged = [merge_params(x, y) for x, y in zip(a, b)]
        if isinstance(a, list):
            return merged
        return type(a)(*merged) if hasattr(a, "_fields") else tuple(merged)
    return a


class HybridState(NamedTuple):
    ngd: Any
    adamw: Any


class HybridNGD:
    """NGD (``ngd``, default ``NaturalGradient()``) on the leaves
    ``filter_fn`` selects, ``adamw`` (default ``AdamW()``) on the rest."""

    requires_scores = True

    def __init__(self, filter_fn: Callable[[str], bool], *,
                 ngd: Optional[NaturalGradient] = None,
                 adamw: Optional[AdamW] = None):
        self.filter_fn = filter_fn
        self.ngd = ngd or NaturalGradient()
        self.adamw = adamw or AdamW()

    def init(self, params) -> HybridState:
        sel, rest = partition_params(params, self.filter_fn)
        return HybridState(self.ngd.init(sel), self.adamw.init(rest))

    def update(self, grads, state: HybridState, params, *, scores):
        """``scores`` must be built over the *selected* subset only (a
        ``per_sample_scores`` of the subset's log P closure)."""
        gsel, grest = partition_params(grads, self.filter_fn)
        psel, prest = partition_params(params, self.filter_fn)
        usel, s_ngd = self.ngd.update(gsel, state.ngd, psel, scores=scores)
        urest, s_aw = self.adamw.update(grest, state.adamw, prest)
        return merge_params(usel, urest), HybridState(s_ngd, s_aw)
