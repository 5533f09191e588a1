"""Learning-rate schedules (warmup-cosine is the production default).

Port of ``repro/optim/schedules.py``. A schedule maps a step (an int or a
0-d tensor) to a 0-d float32 CPU tensor, so reading it never waits on a
device and it scales a CUDA update as a scalar.
"""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "warmup_cosine", "warmup_linear"]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def warmup_cosine(peak: float, *, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def sched(step):
        step = _f32(step)
        warm = peak * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak * (final_frac + (1 - final_frac)
                      * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return sched


def warmup_linear(peak: float, *, warmup_steps: int, total_steps: int):
    def sched(step):
        step = _f32(step)
        warm = peak * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        return torch.where(step < warmup_steps, warm, peak * (1 - t))
    return sched
