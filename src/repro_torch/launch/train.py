"""Step factories of the serving path (port of ``repro/launch/train.py``).

Plain callables: the reference jits them with explicit shardings; here
PyTorch runs eagerly on the parameters' device, with no sharding.

* ``make_score_grads`` — the serve-path front half of the NGD step:
  (loss, mean gradient v, per-sample score rows S) for an adaptation
  batch;
* ``make_prefill`` — prompt in, (last-position logits, cache, index) out;
* ``make_serve_step`` — one greedy decode token.

The train steps (``make_train_step``, ``make_ngd_train_step``) come with
the trainer (``repro_torch.roadmap``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.pytree import leaves, tree_map
from repro_torch.optim.scores import flatten_like, per_sample_scores

__all__ = ["batch_to", "make_prefill", "make_score_grads", "make_serve_step"]


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors → tensors on ``device``."""
    def one(x):
        t = x if isinstance(x, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(x))
        return t.to(device)
    return tree_map(one, batch)


def _device(params) -> torch.device:
    return leaves(params)[0].device


def make_score_grads(api, *, score_chunk=None, score_dtype=None, scale=None):
    """``score_grads(params, batch) -> (loss, v, S)`` for a coalesced
    adaptation batch: the mean-gradient RHS ``v`` (flat, fp32, in
    ``ravel_pytree`` order) and the per-sample score rows S (n, m) in the
    same column order. No optimizer and no update: the serving loop owns
    both.

    ``scale``: row normalization override — pass 1/√n_window so request
    rows can be folded into an n_window-sample curvature window.
    """
    grad_and_loss = torch.func.grad_and_value(api.loss, has_aux=True)

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
    for a prompt batch ``{"tokens": (B, T)[, "max_len"]}``."""
    def prefill(params, batch):
        batch = dict(batch)
        batch["tokens"] = batch_to({"t": batch["tokens"]},
                                   _device(params))["t"]
        return api.prefill(params, batch)
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
