"""Step factories: the AdamW and NGD train steps and the serving path's
steps (port of ``repro/launch/train.py``).

Plain callables: the reference jits them with explicit shardings (its
``jit_*`` wrappers); PyTorch runs eagerly on the parameters' device, with
no sharding, so the port has no ``jit_*`` wrappers.

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

from repro_torch.core.pytree import leaves, tree_map
from repro_torch.optim.scores import (flatten_like, grad_and_value,
                                      per_sample_score_blocks,
                                      per_sample_scores)
from repro_torch.roadmap import queue

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


def make_train_step(api, optimizer, *, microbatches: int = 1):
    """Standard step: value-and-grad → optimizer → apply;
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.

    ``microbatches > 1`` accumulates the gradient over batch slices — a
    Python loop where the reference scans: fp32 gradient and loss sums,
    each divided by the count at the end, as the scan does.
    """
    grad_and_loss = grad_and_value(api.loss, has_aux=True)

    def train_step(params, opt_state, batch):
        batch = batch_to(batch, _device(params))
        if microbatches == 1:
            grads, (loss, metrics) = grad_and_loss(params, batch)
        else:
            mb = leaves(batch)[0].shape[0] // microbatches
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=_device(params))
            for i in range(microbatches):
                g, (l, _) = grad_and_loss(params, tree_map(
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
    ``mesh``, ``score_sharding`` and ``flat_scores`` place S over a
    device mesh in the reference; they are taken at their one-device
    values (None, "1d", False) and refused otherwise.
    """
    if mesh is not None or score_sharding != "1d" or flat_scores:
        raise NotImplementedError(
            "make_ngd_train_step(mesh=, score_sharding=, flat_scores=) lay "
            f"S over a mesh; they come with {queue('sharded')}")
    grad_and_loss = grad_and_value(api.loss, has_aux=True)
    scores = per_sample_score_blocks if blocked else per_sample_scores

    def train_step(params, opt_state, batch):
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
