"""AdamW — the production default optimizer for the model zoo.

Port of ``repro/optim/adamw.py``: decoupled weight decay, optional global
gradient-norm clip, fp32 moments whatever the parameter dtype. Parameter
trees are dicts of tensors; the state is per leaf, shaped like them. The
step counter is a Python int (host-side, as every scalar of the port).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.core.pytree import leaves, tree_map
from repro_torch.optim.schedules import constant

__all__ = ["AdamW", "AdamWState"]


class AdamWState(NamedTuple):
    step: int
    mu: Any       # first moments (tree, fp32)
    nu: Any       # second moments (tree, fp32)


class AdamW:
    requires_scores = False

    def __init__(self, learning_rate: Union[float, Callable] = 3e-4, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 clip_grad_norm: Optional[float] = 1.0):
        self.lr = learning_rate if callable(learning_rate) \
            else constant(learning_rate)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.wd = weight_decay
        self.clip = clip_grad_norm

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(0, tree_map(zeros, params), tree_map(zeros, params))

    def update(self, grads, state: AdamWState, params):
        """Returns (updates, new_state); add the updates to the params."""
        if self.clip is not None:
            gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                   for g in leaves(grads)))
            scale = torch.clamp(self.clip / (gnorm + 1e-12), max=1.0)
            grads = tree_map(lambda g: g * scale.to(g.dtype), grads)

        step = state.step + 1
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g.float() ** 2,
                      state.nu, grads)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** float(step)
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** float(step)
        lr = self.lr(step)

        def upd(p, m, v):
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.wd * p.float()
            return (-lr * u).to(p.dtype)

        return tree_map(upd, params, mu, nu), AdamWState(step, mu, nu)
