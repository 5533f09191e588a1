"""Step factories: the AdamW and NGD train steps and the serving path's
steps (port of ``repro/launch/train.py``).

Plain callables: the reference jits them with explicit shardings (its
``jit_*`` wrappers) and GSPMD partitions them; PyTorch runs eagerly, so
the port has no ``jit_*`` wrappers, and the two train steps take the
mesh themselves. Over a ``launch.mesh.Mesh`` one process drives every
position, as in the serving tier:

* the parameters are replicated on each distinct device of the mesh
  (positions that share a device share the tensors);
* the batch is ``place``d over the data-parallel (DP) axes; each DP
  position takes its piece's gradient of its own masked mean, weighted
  by its share of the whole batch's mask count, and the pieces are
  summed in position order, so the gradient and the loss are the whole
  batch's masked mean (``SyntheticLM`` packs documents: the rows' counts
  differ, and a plain mean of the pieces' means would be another loss).
  A MoE model's capacity and router loss are functions of the whole
  batch, so its gradient is taken on the first DP position whole;
* the NGD step's score rows are computed where their samples lie, each
  divided by the whole batch's √n, and laid out as column slabs over the
  ``model`` axis (``core.distributed.ShardedScores``), which
  ``NaturalGradient`` solves per slab on the kernels.

* ``make_train_step`` — value-and-grad → optimizer → apply (AdamW, the
  production default), with gradient accumulation over microbatches;
* ``make_ngd_train_step`` — the paper's optimizer as a train step: mean
  gradient v, per-sample scores S (dense or blocked), the NGD update;
* ``make_score_grads`` — the serve-path front half of the NGD step:
  (loss, mean gradient v, per-sample score rows S) for an adaptation
  batch;
* ``make_prefill`` — prompt in, (last-position logits, cache, index) out;
* ``make_serve_step`` — one greedy decode token.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distributed import ShardedScores
from repro_torch.core.operator import is_blocked
from repro_torch.core.pytree import leaves, tree_map
from repro_torch.data.pipeline import place
from repro_torch.launch.mesh import (DATA, MODEL, Mesh, all_gather, dp_axes,
                                     make_mesh, record_collective)
from repro_torch.optim.scores import (flatten_like, grad_and_value,
                                      per_sample_score_blocks,
                                      per_sample_scores)

__all__ = ["batch_to", "make_ngd_train_step", "make_prefill",
           "make_score_grads", "make_serve_step", "make_train_step"]


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors → tensors on ``device``."""
    def one(x):
        t = x if isinstance(x, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(x))
        return t.to(device)
    return tree_map(one, batch)


def _device(params) -> torch.device:
    return leaves(params)[0].device


def _apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


# ---------------------------------------------------------------------------
# the steps over a mesh
# ---------------------------------------------------------------------------

def _canonical(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _replicas(params, devices) -> dict:
    """The parameters on each distinct device of ``devices``: the tensors
    themselves on their own device, one copy on each other."""
    home = _canonical(_device(params))
    out = {}
    for d in map(_canonical, devices):
        if d not in out:
            out[d] = params if d == home \
                else tree_map(lambda t: t.to(d), params)
    return out


def _dp_index(mesh, coords: dict) -> int:
    i = 0
    for a in dp_axes(mesh):
        i = i * mesh.shape[a] + coords[a]
    return i


def _dp_pieces(mesh, batch) -> list:
    """The batch's DP pieces, one a DP index in order, each on the device
    of its index's first position."""
    return [b for b, c in zip(place(batch, mesh), mesh.coords())
            if all(c[a] == 0 for a in mesh.axis_names
                   if a not in dp_axes(mesh))]


def _count(piece) -> float:
    """The piece's loss-token count, as ``lm.chunked_ce`` takes it."""
    mask = piece.get("mask")
    return float(piece["labels"].numel() if mask is None else mask.sum())


def _accumulate(acc, part, weight: float, device):
    """acc + weight·part in fp32 on ``device``; called in position order,
    this is ``launch.mesh.psum``'s order."""
    term = (torch.as_tensor(part).detach().to(torch.float32) * weight
            ).to(device)
    return term if acc is None else acc.add_(term)


def _dp_grads(grad_and_loss, api, mesh, replicas, home, batch):
    """(grads, loss, metrics) of the whole batch's loss from its DP
    pieces: piece p's gradient of its own masked mean weighted by
    max(c_p, 1)/max(c, 1) (c the mask counts; ``chunked_ce`` divides by
    max(c, 1)), summed in position order on ``home``, each leaf back in
    its gradient's dtype."""
    if getattr(api.cfg, "n_experts", 0):
        pieces = [batch_to(batch, mesh.device())]
    else:
        pieces = _dp_pieces(mesh, batch)
    counts = [_count(p) for p in pieces]
    total = max(sum(counts), 1.0)
    acc = dtypes = loss = None
    metrics = {}
    for piece, c in zip(pieces, counts):
        w = max(c, 1.0) / total
        g, (l, m) = grad_and_loss(
            replicas[_canonical(leaves(piece)[0].device)], piece)
        if acc is None:
            dtypes = tree_map(lambda t: t.dtype, g)
            acc = tree_map(lambda t: _accumulate(None, t, w, home), g)
        else:
            acc = tree_map(lambda a, t: _accumulate(a, t, w, home), acc, g)
        del g
        loss = _accumulate(loss, l, w, home)
        metrics = {k: _accumulate(metrics.get(k), v, w, home)
                   for k, v in m.items()}
    # the pieces' sum is the DP all-reduce of the fp32 gradient
    record_collective("all-reduce", sum(
        a.numel() * a.element_size() for a in leaves(acc)), len(pieces))
    return tree_map(lambda a, dt: a.to(dt), acc, dtypes), loss, metrics


def _score_groups(mesh, batch, flat: bool) -> list:
    """[(piece, DP index)] in sample order: the batch over the DP positions,
    or with ``flat`` over every position (pod × data × model), each piece
    on its position's device. A batch of one row is one group."""
    if leaves(batch)[0].shape[0] == 1:
        return [(batch_to(batch, mesh.device()), 0)]
    if not flat:
        return [(p, i) for i, p in enumerate(_dp_pieces(mesh, batch))]
    # every position in position order, as one data-parallel axis
    coords = mesh.coords()
    flat_mesh = Mesh((len(coords),), (DATA,),
                     [mesh.device(**c) for c in coords])
    return [(p, _dp_index(mesh, c))
            for p, c in zip(place(batch, flat_mesh), coords)]


def _column_slabs(groups, mesh, layout: str) -> ShardedScores:
    """The groups' score rows as column slabs over the ``model`` axis, each
    slab on its data-row-0 position: "1d" gathers each slab's sample
    pieces there; "2d" first lays piece i's columns j on position (i, j),
    as ``core.distributed.sharded_chol_solve_2d`` holds S, then gathers
    over the DP axes. Blocked scores split every block."""
    cols = mesh.shape.get(MODEL, 1)
    devs = mesh.axis_devices((MODEL,)) if MODEL in mesh.shape \
        else [mesh.device()]
    dp = dp_axes(mesh)

    def at(i, j):
        coords = {}
        for a in reversed(dp):
            i, coords[a] = divmod(i, mesh.shape[a])
        return mesh.device(**coords, **({MODEL: j} if MODEL in mesh.shape
                                        else {}))

    pieces = [(S.blocks if is_blocked(S) else (S,), i) for S, i in groups]
    slabs = [[] for _ in range(cols)]
    for b in range(len(pieces[0][0])):
        split = [(torch.tensor_split(blocks[b], cols, dim=1), i)
                 for blocks, i in pieces]
        for j in range(cols):
            rows = [sp[j] if layout == "1d" else sp[j].to(at(i, j))
                    for sp, i in split]
            slabs[j].append(all_gather(rows, dim=0,
                                       device=devs[j]).contiguous())
    S0 = groups[0][0]
    return ShardedScores(slabs, blocked=is_blocked(S0),
                         names=S0.names if is_blocked(S0) else None)


def make_train_step(api, optimizer, *, microbatches: int = 1, mesh=None):
    """Standard step: value-and-grad → optimizer → apply;
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.

    ``microbatches > 1`` accumulates the gradient over batch slices — a
    Python loop where the reference scans: fp32 gradient and loss sums,
    each divided by the count at the end, as the scan does.

    ``mesh``: data-parallel over its DP axes (the module's docstring): each
    microbatch's gradient is the DP pieces' weighted sum; the optimizer
    runs once, on the parameters' device (every replica would compute
    the same update).
    """
    grad_and_loss = grad_and_value(api.loss, has_aux=True)

    def grads_of(params, batch):
        if mesh is None:
            g, (l, m) = grad_and_loss(params, batch_to(batch, _device(params)))
            return g, l, m
        home = _canonical(_device(params))
        reps = _replicas(params, [mesh.device(**c) for c in mesh.coords()])
        return _dp_grads(grad_and_loss, api, mesh, reps, home, batch)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            grads, loss, metrics = grads_of(params, batch)
        else:
            mb = leaves(batch)[0].shape[0] // microbatches
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=_device(params))
            for i in range(microbatches):
                g, l, _ = grads_of(params, tree_map(
                    lambda x: x[i * mb:(i + 1) * mb], batch))
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = {}
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = _apply_updates(params, updates)
        return params, opt_state, {"loss": loss.detach(), **metrics}

    return train_step


def make_ngd_train_step(api, optimizer, mesh=None, *, score_chunk=None,
                        score_dtype=None, score_sharding: str = "1d",
                        flat_scores: bool = False, blocked: bool = False):
    """The paper's optimizer as a train step:

    1. mean gradient v (one backward pass);
    2. the score matrix S by ``vmap(grad)`` of the per-sample log P
       (``score_chunk`` samples at a time);
    3. the NGD update (``optimizer.update(..., scores=S)``).

    ``blocked``: S stays a per-layer ``BlockedScores`` operator, so the
    flat (n, m) buffer — the dense path's memory ceiling — never exists.

    ``mesh`` (a ``launch.mesh.Mesh``): v is the DP pieces' weighted sum and
    S is held as column slabs over the ``model`` axis, every block split
    when ``blocked`` (the module's docstring). ``score_sharding``: "1d"
    gathers each column slab's sample pieces onto its position; "2d"
    keeps samples over the DP axes and columns over ``model`` and gathers
    per column slab, as ``core.distributed.sharded_chol_solve_2d``.
    ``flat_scores``: the score rows are computed over every position (pod
    × data × model), then laid out as ``score_sharding`` says (the
    reference's ``jit_ngd_train_step(replicate_model=True)``). Without a
    mesh, "2d" or ``flat_scores`` run on a (1, 1) mesh on the parameters'
    device. The solve is ``optimizer``'s: ``"chol"`` and
    ``ops.chol_solve_fused`` run per slab on the kernels, any other
    solver on the gathered S.
    """
    if score_sharding not in ("1d", "2d"):
        raise ValueError(f"unknown score_sharding {score_sharding!r}: "
                         "'1d' or '2d'")
    grad_and_loss = grad_and_value(api.loss, has_aux=True)
    scores = per_sample_score_blocks if blocked else per_sample_scores
    sharded = mesh is not None or score_sharding != "1d" or flat_scores

    def sharded_grads_and_scores(params, batch):
        m = mesh if mesh is not None else make_mesh(
            (1, 1), (DATA, MODEL), device=_device(params))
        home = _canonical(_device(params))
        reps = _replicas(params, [m.device(**c) for c in m.coords()])
        grads, loss, metrics = _dp_grads(grad_and_loss, api, m, reps, home,
                                         batch)
        n = leaves(batch)[0].shape[0]
        groups = [(scores(api.sample_logp,
                          reps[_canonical(leaves(piece)[0].device)], piece,
                          chunk=score_chunk, dtype=score_dtype, n_total=n), i)
                  for piece, i in _score_groups(m, batch, flat_scores)]
        S = _column_slabs(groups, m, score_sharding)
        return grads, loss, metrics, S

    def train_step(params, opt_state, batch):
        if sharded:
            grads, loss, metrics, S = sharded_grads_and_scores(params, batch)
        else:
            batch = batch_to(batch, _device(params))
            grads, (loss, metrics) = grad_and_loss(params, batch)
            S = scores(api.sample_logp, params, batch, chunk=score_chunk,
                       dtype=score_dtype)
        updates, opt_state = optimizer.update(grads, opt_state, params,
                                              scores=S)
        del S, grads
        params = _apply_updates(params, updates)
        metrics = {"loss": loss.detach(), **metrics}
        if opt_state.curvature is not None:
            # streaming-curvature cache diagnostics ride the metrics dict
            cs = opt_state.curvature.stats
            metrics["curvature_hits"] = cs.hits
            metrics["curvature_refreshes"] = cs.refreshes
        return params, opt_state, metrics

    return train_step


def make_score_grads(api, *, score_chunk=None, score_dtype=None, scale=None):
    """``score_grads(params, batch) -> (loss, v, S)`` for a coalesced
    adaptation batch: the mean-gradient RHS ``v`` (flat, fp32, in
    ``ravel_pytree`` order) and the per-sample score rows S (n, m) in the
    same column order. No optimizer and no update: the serving loop owns
    both.

    ``scale``: row normalization override — pass 1/√n_window so request
    rows can be folded into an n_window-sample curvature window.
    """
    grad_and_loss = grad_and_value(api.loss, has_aux=True)

    def score_grads(params, batch):
        batch = batch_to(batch, _device(params))
        grads, (loss, _) = grad_and_loss(params, batch)
        S = per_sample_scores(api.sample_logp, params, batch,
                              chunk=score_chunk, dtype=score_dtype,
                              scale=scale)
        v, _ = flatten_like(grads)
        return loss.detach(), v.to(torch.float32), S

    return score_grads


def make_prefill(api):
    """``prefill(params, batch) -> (logits (B, 1, V), cache, next_index)``
    for a prompt batch ``{"tokens": (B, T)[, "max_len"][, "frames"][,
    "prefix_embeds"]}``; its arrays are moved to the parameters' device."""
    def prefill(params, batch):
        arrays = {k: v for k, v in batch.items() if k != "max_len"}
        return api.prefill(params, {**batch,
                                    **batch_to(arrays, _device(params))})
    return prefill


def make_serve_step(api):
    """``step(params, cache, cache_index, tokens) -> (next, cache, logits)``:
    one decode token and its greedy successor (B,) int32. The cache is
    written in place; ``logits`` (B, V) fp32 are the step's last-position
    logits (the reference's jitted step drops them; here they are already
    on the device)."""
    def step(params, cache, cache_index, tokens):
        logits, cache = api.decode_step(params, cache, cache_index, tokens)
        last = logits[:, -1]
        return torch.argmax(last, dim=-1).to(torch.int32), cache, last
    return step
