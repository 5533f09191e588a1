"""The serving front (port of the serving half of
``repro/launch/trainer.py``): config → model → seeded curvature window →
``SolveServer``.

``build_server`` is the eager replicated server of the reference. Its
other flavours raise ``NotImplementedError`` naming the queue that ports
them (``repro_torch.roadmap``): ``layout``/``async_`` (the sharded tier),
the tenant options and the observability hooks and audit. The trainer
(``build_trainer``, ``train_main``) and ``build_fleet`` come with later
slices too.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.pytree import leaves, params_from_arrays, tree_map
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as T
from repro_torch.models.api import get_api
from repro_torch.optim.scores import flatten_like
from repro_torch.roadmap import queue

__all__ = ["ServeHandles", "build_server"]


class ServeHandles:
    """Everything the serving loop needs besides the ``SolveServer``: the
    model api, live params, the score-grad pass for adaptation batches,
    the prefill and greedy serve steps, the data source seeding synthetic
    traffic, and the parameter unravel for applying flat natural-gradient
    updates."""

    def __init__(self, *, api, params, data, score_grads, unravel):
        self.api = api
        self.params = params
        self.data = data
        self.score_grads = score_grads     # (params, batch) -> (loss, v, S)
        self.unravel = unravel             # flat (m,) -> params-shaped tree
        self.device = leaves(params)[0].device
        self._prefill = T.make_prefill(api)
        self._step = T.make_serve_step(api)

    def loss(self, batch) -> float:
        """The adaptation loss of ``batch`` under the live params (the
        value ``score_grads`` returns, without its gradients)."""
        with torch.no_grad():
            loss, _ = self.api.loss(self.params,
                                    T.batch_to(batch, self.device))
        return float(loss)

    def apply_update(self, x_flat, *, lr: float):
        """θ ← θ − lr·x for a flat natural-gradient solve result, rounded
        to each leaf's dtype as the reference does."""
        delta = self.unravel(x_flat.to(self.device))
        self.params = tree_map(
            lambda p, d: (p - lr * d.to(p.dtype)).to(p.dtype),
            self.params, delta)
        return self.params

    def decode(self, prompt, *, new_tokens: int, return_logits: bool = False):
        """Prefill + greedy one-token decode of ``prompt`` (b, T); returns
        (b, new_tokens) generated ids, and with ``return_logits`` also the
        (b, new_tokens, V) fp32 logits each id was taken from."""
        prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int32)
        b, plen = prompt.shape
        with torch.no_grad():
            logits, cache, _ = self._prefill(
                self.params, {"tokens": prompt, "max_len": plen + new_tokens})
            last = logits[:, -1]
            out = [torch.argmax(last, dim=-1).to(torch.int32)[:, None]]
            steps = [last]
            for t in range(new_tokens - 1):
                nxt, cache, last = self._step(self.params, cache, plen + t,
                                              out[-1])
                out.append(nxt[:, None])
                steps.append(last)
        ids = torch.cat(out, dim=1)
        return (ids, torch.stack(steps, dim=1)) if return_logits else ids


def _build_serve_front(cfg, *, window: int, seq: int, score_chunk=None,
                       seed: int = 0, params=None, device=None):
    """The model-side half of serving: api + params + score-grad pass +
    seeded window S0 (n = ``window`` synthetic examples)."""
    dev = resolve_device(device)
    api = get_api(cfg)
    data = SyntheticLM(cfg, batch=window, seq=seq, seed=seed)
    if params is None:
        params = api.init_params(torch.Generator(device=dev).manual_seed(seed))
    elif all(isinstance(t, torch.Tensor) for t in leaves(params)):
        params = tree_map(lambda t: t.to(dev), params)
    else:                                  # numpy arrays, e.g. the JAX LM's
        params = params_from_arrays(params, device=dev)
    _, unravel = flatten_like(params)
    # request rows carry the window's 1/√n normalization so folds are
    # exchangeable with the seeded rows
    score_grads = T.make_score_grads(api, score_chunk=score_chunk,
                                     scale=1.0 / np.sqrt(window))
    _, _, S0 = score_grads(params, data.batch_at(0))
    handles = ServeHandles(api=api, params=params, data=data,
                           score_grads=score_grads, unravel=unravel)
    return handles, S0


# option → the key of the roadmap queue that ports it
_LATER = {
    "layout": "sharded",
    "async_": "sharded",
    "tenant_rank": "tenants",
    "tenant_budget_mb": "tenants",
    "audit_every": "observability",
    "registry": "observability",
    "tracer": "observability",
    "profile": "observability",
    "health": "observability",
    "recorder": "observability",
    "record_dir": "observability",
}


def build_server(cfg, *, window: int, seq: int, damping: float = 1e-3,
                 max_tokens: int = 4096, max_requests: int = 8,
                 refresh_every: int = 64, drift_tol=None, drift_frac=0.25,
                 jitter: float = 0.0, score_chunk=None, policy: str = "cached",
                 layout=None, async_: bool = False, oversize: str = "split",
                 window_dtype=None, tenant_rank=None, tenant_budget_mb=None,
                 seed: int = 0, audit_every: int = 0,
                 registry=None, tracer=None, profile=None, health=None,
                 recorder=None, record_dir=None, params=None, device=None):
    """Config → model → resident curvature window → eager ``SolveServer``.

    Builds the score-grad pass, the prefill and the greedy serve step,
    seeds an n=``window`` sample score window from synthetic data,
    factorizes it once, and wraps it in a request-driven server with
    token-budget batching and the age/drift online-adaptation policy.
    Returns ``(server, handles)``.

    ``params``: a parameter tree to serve (tensors, or numpy arrays such
    as the JAX LM's, through ``params_from_arrays``) in place of one drawn
    from ``seed``. ``device``: CUDA by default; ``"cpu"`` runs the plain
    versions. ``window_dtype`` (e.g. "bfloat16"): low-precision window
    storage, every S pass still accumulating fp32.
    """
    from repro_torch.serve import (OnlineAdaptation, SolveServer,
                                   TokenBudgetBatcher, init_serve_state)

    given = {"layout": layout, "async_": async_, "tenant_rank": tenant_rank,
             "tenant_budget_mb": tenant_budget_mb, "audit_every": audit_every,
             "registry": registry, "tracer": tracer, "profile": profile,
             "health": health, "recorder": recorder, "record_dir": record_dir}
    for name, value in given.items():
        if value not in (None, False, 0):
            raise NotImplementedError(
                f"build_server({name}=...) comes with {queue(_LATER[name])}")
    handles, S0 = _build_serve_front(cfg, window=window, seq=seq,
                                     score_chunk=score_chunk, seed=seed,
                                     params=params, device=device)
    adaptation = OnlineAdaptation(refresh_every=refresh_every,
                                  drift_tol=drift_tol, drift_frac=drift_frac,
                                  jitter=jitter)
    batcher = TokenBudgetBatcher(max_tokens=max_tokens,
                                 max_requests=max_requests, oversize=oversize)
    state = init_serve_state(S0, damping, jitter=jitter,
                             window_dtype=window_dtype)
    del S0
    server = SolveServer(state, batcher=batcher, adaptation=adaptation,
                         policy=policy, jitter=jitter)
    return server, handles
