"""Damped natural-gradient descent — the paper's use case.

Port of ``repro/optim/ngd.py``. ``init``/``update`` in the optax shape,
with the per-sample score matrix S passed beside the mean gradient v:

    nat_grad = solve(S, v, λ)          # Algorithm 1 by default
    buf      = μ·buf + nat_grad        # heavy-ball momentum
    Δθ       = −lr · buf

``scores`` is a dense (n, m) tensor or a ``BlockedScores`` /
``LazyBlockedScores`` operator whose blocks follow the gradient tree's
flatten order, or a ``core.distributed.ShardedScores`` (column slabs over
a mesh, dense or blocked): Algorithm 1 (``"chol"``,
``ops.chol_solve_fused``) and the streaming policy solve it per slab on
the kernels, and any other solver runs on the gathered S, as GSPMD
partitions any solver with the same result. The state is per leaf: the
momentum buffer is a tree shaped like the parameters (fp32, or complex64
for complex leaves), so with blocked scores no length-m vector exists
anywhere. The solver is a
name in ``repro_torch.core.SOLVERS`` or any ``f(S, v, λ) -> x``, e.g.
``repro_torch.kernels.ops.chol_solve_fused``, which runs the hand-written
kernels on CUDA tensors.

``curvature=`` selects how the damped factorization is obtained: the
default (``None`` / ``"exact"``) solves from scratch every step — the
paper's method — while a ``repro_torch.curvature.StreamingCurvature``
policy carries the n×n Gram across steps (age/drift-triggered refresh,
re-damping at the current λ) with its ``CurvatureState`` inside
``NGDState``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.core import block_norm, get_solver, is_blocked
from repro_torch.core.damping import ConstantDamping, DampingState
from repro_torch.core.distributed import ShardedScores, takes_sharded
from repro_torch.core.pytree import leaves, tree_map, unflatten_like
from repro_torch.optim.schedules import constant
from repro_torch.optim.scores import flatten_like

__all__ = ["NGDState", "NaturalGradient", "global_norm"]


def global_norm(tree) -> torch.Tensor:
    """Global 2-norm over all leaves of a tree (fp32, complex-safe)."""
    return block_norm(tuple(leaves(tree)))


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 for real leaves, complex64+ for complex ones: the cast must never
    drop the imaginary part of a complex-mode natural gradient."""
    return torch.promote_types(dtype, torch.float32)


class NGDState(NamedTuple):
    step: int
    momentum: Any              # per-leaf heavy-ball tree (params-shaped)
    damping: DampingState
    curvature: Any = None      # CurvatureState when a streaming policy is on


class NaturalGradient:
    """Natural gradient descent with the Algorithm-1 solve, momentum and
    clipping.

    Args:
      learning_rate: float or schedule ``step -> lr``.
      damping: float λ, or a damping policy with ``init()``/``update()``.
      solver: a name in ``repro_torch.core.SOLVERS``, or any
        ``f(S, v, λ) -> x``.
      momentum: heavy-ball coefficient μ (0 disables).
      clip_natgrad_norm: optional global-norm clip on the natural gradient.
      curvature: ``None`` / ``"exact"`` for the per-step solve, or a
        ``repro_torch.curvature.StreamingCurvature`` policy to amortize the
        Gram across steps (replaces the solver; its state rides in
        ``NGDState.curvature``). The policy's ``n`` must equal the per-step
        sample count of ``scores``.
    """

    requires_scores = True

    def __init__(self, learning_rate: Union[float, Callable] = 1e-3, *,
                 damping=1e-3, solver: Union[str, Callable] = "chol",
                 momentum: float = 0.9,
                 clip_natgrad_norm: Optional[float] = None,
                 curvature=None):
        self.lr = learning_rate if callable(learning_rate) \
            else constant(learning_rate)
        self.damping_policy = damping if hasattr(damping, "init") \
            else ConstantDamping(damping)
        self.solver = get_solver(solver) if isinstance(solver, str) else solver
        self.momentum = float(momentum)
        self.clip = clip_natgrad_norm
        if isinstance(curvature, str) and curvature == "exact":
            curvature = None
        if curvature is not None and not hasattr(curvature, "solve"):
            raise ValueError(
                "curvature= takes None/'exact' or a policy with "
                "init()/solve() (e.g. repro_torch.curvature."
                "StreamingCurvature(n=batch)); got " + repr(curvature))
        self.curvature = curvature

    def init(self, params) -> NGDState:
        return NGDState(
            step=0,
            momentum=tree_map(lambda p: torch.zeros(
                p.shape, dtype=_acc_dtype(p.dtype), device=p.device), params),
            damping=self.damping_policy.init(),
            curvature=None if self.curvature is None
            else self.curvature.init())

    def _nat_grad_tree(self, grads, scores, damping: DampingState, cstate):
        """Solve (SᵀS + λI) x = v; returns (x as a grads-shaped tree,
        cstate')."""
        lam = damping.lam
        sharded = isinstance(scores, ShardedScores)
        if sharded and self.curvature is None \
                and not takes_sharded(self.solver):
            scores, sharded = scores.gather(), False
        if self.curvature is not None:
            # the whole DampingState rides along so a drift_frac policy can
            # autotune its refresh threshold from the trust-region ratio
            def solve(S, v, lam):
                return self.curvature.solve(S, v, lam, cstate,
                                            damping_state=damping)
        else:
            def solve(S, v, lam):
                return self.solver(S, v, lam), None
        gl = leaves(grads)
        if is_blocked(scores) or (sharded and scores.blocked):
            # the gradient tree IS the blocked RHS: one (m_b,) piece per leaf
            widths = tuple(g.numel() for g in gl)
            if widths != tuple(scores.block_widths):
                raise ValueError(
                    f"gradient leaf sizes {widths} don't match score block "
                    f"widths {tuple(scores.block_widths)}")
            v = tuple(g.reshape(-1).to(_acc_dtype(g.dtype)) for g in gl)
            x, cstate = solve(scores, v, lam)
            return unflatten_like(grads, [
                xb.reshape(g.shape).to(_acc_dtype(xb.dtype))
                for xb, g in zip(x, gl)]), cstate
        v, unravel = flatten_like(grads)
        nat, cstate = solve(scores, v.to(_acc_dtype(v.dtype)), lam)
        return tree_map(lambda x: x.to(_acc_dtype(x.dtype)),
                        unravel(nat)), cstate

    def update(self, grads, state: NGDState, params, *, scores):
        """Returns (updates, new_state); add the updates to the params.
        ``scores`` is S: dense (n, m) or blocked in flatten order."""
        del params  # the signature of the reference; NGD needs no params
        nat, cstate = self._nat_grad_tree(grads, scores, state.damping,
                                          state.curvature)
        if self.clip is not None:
            scale = torch.clamp(self.clip / (global_norm(nat) + 1e-12),
                                max=1.0)
            nat = tree_map(lambda x: x * scale, nat)
        buf = tree_map(lambda b, x: self.momentum * b + x, state.momentum, nat)
        lr = self.lr(state.step)
        updates = tree_map(lambda b, g: (-lr * b).to(g.dtype), buf, grads)
        return updates, NGDState(state.step + 1, buf, state.damping, cstate)

    def update_damping(self, state: NGDState, *, actual_reduction,
                       predicted_reduction) -> NGDState:
        """Trust-region λ adaptation hook (call after evaluating the step)."""
        d = self.damping_policy.update(
            state.damping, actual_reduction=actual_reduction,
            predicted_reduction=predicted_reduction)
        return state._replace(damping=d)
