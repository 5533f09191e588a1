"""Gradient compression for the cross-position reduction (port of
``repro/optim/compress.py``).

Two schemes, both with exact fp32 master math on the reduced result:

* ``bf16_allreduce`` — the gradients cast to bf16 before the sum (half
  the bytes on the wire), the sum widened to fp32;
* ``Int8ErrorFeedback`` — per-tensor symmetric int8 quantization with an
  error-feedback residual carried in its state, so the quantization error
  is re-injected next step (EF-SGD); a quarter of the bytes.

The reference runs them inside ``shard_map`` bodies over a named axis.
Here one process holds every position's gradients, so each takes the
per-position trees as a list in position order and sums them with
``launch.mesh.psum`` (in position order, on the first position's
device), where every position would hold the same sum. No trainer wires
them in, as in the reference: they are library pieces.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Sequence

import torch

from repro_torch.core.pytree import leaves, tree_map, unflatten_like
from repro_torch.launch.mesh import psum

__all__ = ["EFState", "Int8ErrorFeedback", "bf16_allreduce"]


def bf16_allreduce(grads_pos: Sequence):
    """The positions' gradient trees summed in bf16 (each leaf cast, the
    sum ``psum``'s), widened to fp32."""
    return tree_map(lambda *gs: psum([g.to(torch.bfloat16) for g in gs]
                                     ).to(torch.float32), *grads_pos)


class EFState(NamedTuple):
    residual: Any      # one position's tree of fp32 residuals


class Int8ErrorFeedback:
    """Quantize (g + residual) to int8 per tensor, sum, dequantize with
    the mean of the positions' scales; the quantization error becomes
    each position's next residual."""

    def init(self, grads) -> EFState:
        """One position's state (zero residuals shaped like ``grads``)."""
        return EFState(tree_map(
            lambda g: torch.zeros_like(g, dtype=torch.float32), grads))

    def allreduce(self, grads_pos: Sequence, states: Sequence[EFState]
                  ) -> tuple:
        """``grads_pos`` and ``states``: one tree and one ``EFState`` a
        position, in position order. Returns (the summed tree, fp32, on
        the first position's device; the positions' new states)."""
        count = len(grads_pos)
        flat_g = [leaves(g) for g in grads_pos]
        flat_r = [leaves(st.residual) for st in states]
        out: List[torch.Tensor] = []
        res: List[List[torch.Tensor]] = [[] for _ in range(count)]
        for i in range(len(flat_g[0])):
            qs, scales = [], []
            for p in range(count):
                g32 = torch.add(flat_g[p][i], flat_r[p][i])   # fp32 g + r
                # a tensor divisor: CUDA divides by a Python scalar through
                # its reciprocal, which can round the scale apart from the
                # CPU's (and the reference's) true division
                scale = torch.clamp_min(
                    torch.linalg.vector_norm(g32, float("inf")), 1e-12
                ) / torch.tensor(127.0, device=g32.device)
                q = torch.div(g32, scale).round_().clamp_(-127, 127)
                # int8 sums would overflow: reduce in int32 (a transport
                # would carry int8 bytes; the math is modeled faithfully)
                qs.append(q.to(torch.int32))
                res[p].append(g32.sub_(q.mul_(scale)))   # g + r − dequant
                scales.append(scale)
            # the mean of the positions' scales is exact only for equal
            # scales; error feedback absorbs the mismatch
            nranks = psum([torch.ones((), dtype=torch.float32,
                                      device=s.device) for s in scales])
            out.append(psum(qs).to(torch.float32)
                       * (psum(scales) / nranks))
        return (unflatten_like(grads_pos[0], out),
                [EFState(unflatten_like(st.residual, r))
                 for st, r in zip(states, res)])
