"""Sharding rules as data (port of ``repro/launch/shardings.py``):
parameter, activation and cache ``PartitionSpec``s over a
``launch.mesh.Mesh``, from MaxText-style logical rules expressed as
path-pattern matching over the parameter tree.

Layout summary (mesh axes: optional "pod", "data", "model"):

* batch           → ("pod", "data")        (DP across pods composes with DP)
* attn heads / mlp hidden / experts / vocab → "model"   (TP / EP)
* d_model dim of big weights → "data"      (FSDP / ZeRO-3, opt-in)
* decode KV cache → batch over DP, head_dim over "model" (kv-head counts
  are below the model-axis size on every assigned arch, so head_dim is the
  clean TP axis for cache tensors)
* norms / scalars → replicated

FSDP is enabled per-arch ("auto": on when the param count exceeds 1B).

The port's steps do not lay tensors out by these rules: they replicate
the parameters on every device of a mesh (``launch/train.py``). The rules
are data here — what each leaf's spec is, and the shard each position
would hold under it (``LeafSharding.shard_shape``) — which the dry run
(``launch/dryrun.py``) reports beside the replicated layout's bytes.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Tuple

from repro_torch.core.pytree import leaves, leaves_with_path, unflatten_like
from repro_torch.launch.mesh import DATA, MODEL, Mesh, dp_axes

__all__ = ["batch_spec", "cache_shardings", "input_shardings",
           "opt_state_shardings", "param_shardings", "tree_size"]


class PartitionSpec(tuple):
    """A tuple with one entry per tensor axis: a mesh axis name, a tuple of
    names (the axis split over their product), or ``None`` (replicated).
    Compares equal to ``tuple(jax.sharding.PartitionSpec(...))``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class LeafSharding:
    """One leaf's layout: its spec and the shape of the shard each
    position holds under it (an axis split over k positions keeps
    ⌈size/k⌉ of it: the largest shard). A leaf of the port's trees."""
    spec: PartitionSpec
    shard_shape: Tuple[int, ...]


def tree_size(tree) -> int:
    total = 0
    for x in leaves(tree):
        count = 1
        for s in getattr(x, "shape", ()):
            count *= int(s)
        total += count
    return total


def _key_str(path) -> str:
    return "/".join(str(k) for _, k in path)


def _lead(shape, trailing: int):
    """None specs for leading (stacked-repeat) axes."""
    return (None,) * (len(shape) - trailing)


# (regex over path, spec builder taking (shape, fsdp_axis) -> P)
# Stacked block leaves carry a leading repeat axis (never sharded).
_PARAM_RULES = [
    # attention projections
    (r"(wq|wk|wv|xq|xk|xv)$", lambda s, f: P(*_lead(s, 2), f, MODEL)),
    (r"(wo|xo)$",             lambda s, f: P(*_lead(s, 2), MODEL, f)),
    # dense mlp
    (r"w_(gate|up)$",         lambda s, f:
        P(*_lead(s, 2), f, MODEL) if len(s) <= 3 else
        P(*_lead(s, 3), MODEL, f, None)),          # (R,E,D,F): experts→model
    (r"w_down$",              lambda s, f:
        P(*_lead(s, 2), MODEL, f) if len(s) <= 3 else
        P(*_lead(s, 3), MODEL, None, f)),          # (R,E,F,D)
    (r"router$",              lambda s, f: P(*_lead(s, 2), f, None)),
    # mamba
    (r"in_proj$",             lambda s, f: P(*_lead(s, 2), f, MODEL)),
    (r"out_proj$",            lambda s, f: P(*_lead(s, 2), MODEL, f)),
    (r"conv_w$",              lambda s, f: P(*_lead(s, 2), None, MODEL)),
    (r"(A_log|D|dt_bias)$",   lambda s, f: P(*_lead(s, 1), MODEL)),
    (r"norm_g$",              lambda s, f: P(*_lead(s, 1), MODEL)),
    # embeddings
    (r"pos_embed$",           lambda s, f: P()),
    (r"(^|/)embed$",          lambda s, f: P(MODEL, f)),
    (r"head$",                lambda s, f: P(f, MODEL)),
]


def param_pspec(path: str, shape, *, fsdp: bool,
                ep_over_data: bool = False) -> PartitionSpec:
    f = DATA if fsdp else None
    if ep_over_data and len(shape) == 4 and re.search(r"w_(gate|up|down)$",
                                                      path):
        # EP-over-data expert layout: expert axis → data, per-expert
        # hidden → model, d_model unsharded, for every expert weight
        return P(None, DATA, None, MODEL)
    for pat, rule in _PARAM_RULES:
        if re.search(pat, path):
            return rule(shape, f)
    return P()          # norms, biases, scalars → replicated


def shard_shape(shape, spec, mesh: Mesh) -> Tuple[int, ...]:
    """The largest shard of a ``shape`` tensor laid out by ``spec`` over
    ``mesh``: each axis divided (rounded up) by the product of the sizes
    of the mesh axes it names. Names the mesh lacks split nothing."""
    out = []
    for i, size in enumerate(shape):
        names = spec[i] if i < len(spec) else None
        names = () if names is None else \
            (names,) if isinstance(names, str) else tuple(names)
        parts = 1
        for a in names:
            parts *= mesh.shape.get(a, 1)
        out.append(-(-int(size) // parts))
    return tuple(out)


def _sharding(x, spec, mesh) -> LeafSharding:
    return LeafSharding(spec, shard_shape(tuple(x.shape), spec, mesh))


def _map_with_path(fn, tree):
    pairs = leaves_with_path(tree)
    return unflatten_like(tree, [fn(path, x) for path, x in pairs])


def param_shardings(param_tree, mesh: Mesh, *, fsdp="auto",
                    ep_over_data: bool = False):
    """A ``LeafSharding`` tree for a parameter tree (tensors, meta tensors
    or anything with a ``shape``)."""
    if fsdp == "auto":
        fsdp = tree_size(param_tree) > 1_000_000_000

    def one(path, x):
        spec = param_pspec(_key_str(path), tuple(x.shape), fsdp=fsdp,
                           ep_over_data=ep_over_data)
        return _sharding(x, spec, mesh)
    return _map_with_path(one, param_tree)


def batch_spec(mesh: Mesh) -> PartitionSpec:
    dp = dp_axes(mesh)
    return P(dp if len(dp) > 1 else dp[0])


def input_shardings(batch_tree, mesh: Mesh):
    """Inputs: leading batch axis over DP (replicated when batch == 1)."""
    dp = batch_spec(mesh)

    def one(path, x):
        ndim = len(x.shape)
        if ndim == 0:
            return _sharding(x, P(), mesh)
        if x.shape[0] == 1:     # long-context single stream: replicate batch
            return _sharding(x, P(*(None,) * ndim), mesh)
        return _sharding(x, P(*dp, *(None,) * (ndim - 1)), mesh)
    return _map_with_path(one, batch_tree)


def cache_shardings(cache_tree, mesh: Mesh):
    """Decode caches. Leaves are stacked (R, B, ...):

    * attn k/v (R,B,S,KH,hd):   B → DP, hd → model
    * cross ck/cv:              same
    * mamba conv (R,B,K-1,ch):  B → DP, ch → model
    * mamba ssm (R,B,nh,ds,hp): B → DP, nh → model
    """
    dp = batch_spec(mesh)

    def one(path, x):
        key = _key_str(path)
        b = dp if x.shape[1] > 1 else (None,)
        if re.search(r"(k|v|ck|cv)$", key) and len(x.shape) == 5:
            spec = P(None, *b, None, None, MODEL)
        elif key.endswith("conv"):
            spec = P(None, *b, None, MODEL)
        elif key.endswith("ssm"):
            spec = P(None, *b, MODEL, None, None)
        else:
            spec = P()
        return _sharding(x, spec, mesh)
    return _map_with_path(one, cache_tree)


def opt_state_shardings(opt_state, param_shard_tree, mesh: Mesh):
    """Optimizer state: moments follow their parameter's sharding; step
    counters, damping and the streaming-curvature state are replicated
    (the cached n×n Gram is the post-psum dual-space matrix every position
    already holds). Any other state is replicated."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.optim.ngd import NGDState

    def like_params(subtree):
        return unflatten_like(subtree, leaves(param_shard_tree))

    def replicated(subtree):
        return _map_with_path(lambda _, x: _sharding(
            x, P(), mesh) if hasattr(x, "shape") else LeafSharding(P(), ()),
            subtree)

    if isinstance(opt_state, AdamWState):
        return AdamWState(LeafSharding(P(), ()), like_params(opt_state.mu),
                          like_params(opt_state.nu))
    if isinstance(opt_state, NGDState):
        return NGDState(LeafSharding(P(), ()),
                        like_params(opt_state.momentum),
                        replicated(opt_state.damping),
                        replicated(opt_state.curvature))
    return replicated(opt_state)


def sharded_bytes(tree, shardings) -> int:
    """Bytes one position holds of ``tree`` laid out by ``shardings`` (its
    largest shard of every tensor leaf)."""
    total = 0
    for x, s in zip(leaves(tree), leaves(shardings)):
        if not hasattr(x, "element_size"):
            continue
        count = 1
        for d in s.shard_shape:
            count *= d
        total += count * x.element_size()
    return total
