"""Damping (λ) schedules for natural-gradient descent.

Port of ``repro/core/damping.py``: ``ConstantDamping`` (the paper's
setting) and ``LevenbergMarquardtDamping`` (trust-region adaptation).
The state is two 0-d float32 CPU tensors — host-side scalars, so reading
them never waits on a device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["ConstantDamping", "LevenbergMarquardtDamping", "DampingState",
           "auto_drift_tol"]


def _scalar(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32)


class DampingState(NamedTuple):
    lam: torch.Tensor           # current λ
    last_ratio: torch.Tensor    # last actual/predicted reduction ratio


class ConstantDamping:
    def __init__(self, lam: float):
        self.lam0 = float(lam)

    def init(self) -> DampingState:
        return DampingState(_scalar(self.lam0), _scalar(1.0))

    def update(self, state: DampingState, *, actual_reduction,
               predicted_reduction) -> DampingState:
        del actual_reduction, predicted_reduction
        return state


class LevenbergMarquardtDamping:
    """λ ← λ·grow if ρ < ρ_bad;  λ ← λ·shrink if ρ > ρ_good, clamped to
    [lam_min, lam_max], with ρ = actual / predicted reduction."""

    def __init__(self, lam: float, *, grow: float = 1.5, shrink: float = 0.9,
                 rho_bad: float = 0.25, rho_good: float = 0.75,
                 lam_min: float = 1e-8, lam_max: float = 1e4):
        self.lam0, self.grow, self.shrink = float(lam), float(grow), float(shrink)
        self.rho_bad, self.rho_good = float(rho_bad), float(rho_good)
        self.lam_min, self.lam_max = float(lam_min), float(lam_max)

    def init(self) -> DampingState:
        return DampingState(_scalar(self.lam0), _scalar(1.0))

    def update(self, state: DampingState, *, actual_reduction,
               predicted_reduction) -> DampingState:
        actual = torch.as_tensor(actual_reduction, dtype=torch.float32)
        predicted = torch.as_tensor(predicted_reduction, dtype=torch.float32)
        rho = actual / torch.clamp_min(predicted, 1e-30)
        lam = state.lam
        lam = torch.where(rho < self.rho_bad, lam * self.grow, lam)
        lam = torch.where(rho > self.rho_good, lam * self.shrink, lam)
        lam = torch.clamp(lam, self.lam_min, self.lam_max)
        return DampingState(lam, rho.to(torch.float32))


def auto_drift_tol(state: "DampingState | None", *, frac: float = 0.25,
                   floor: float = 1e-3, ceil: float = 1.0) -> torch.Tensor:
    """Curvature drift tolerance from the damping schedule:
    ``tol = clip(frac · ρ, floor, ceil)`` with ρ the last trust-region gain
    ratio (1 when ``state`` is None). ρ ≈ 1 tolerates a stale factor
    longer; ρ → 0 tightens toward an immediate refresh."""
    rho = _scalar(1.0) if state is None \
        else torch.as_tensor(state.last_ratio, dtype=torch.float32)
    return torch.clamp(frac * torch.clamp_min(rho, 0.0), floor, ceil)
