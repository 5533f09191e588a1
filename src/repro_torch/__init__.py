"""PyTorch + CUDA port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``repro`` stays the reference; this package grows beside
it slice by slice, with the same subpackage and module names so each
counterpart is easy to find. It imports ``torch``, numpy and the standard
library only — never ``jax`` and nothing from ``repro``.

Slice 1 is the resident-factor serving path: ``serve`` (state, batcher,
online adaptation, server) over ``core`` (blocked operator, Cholesky
factorization, damping), ``curvature.update`` (rank-k factor algebra)
and ``kernels`` (hand-written CUDA C++ for ``sm_90a`` with plain PyTorch
twins).

The reference computes its fp32 contractions at ``Precision.HIGHEST``;
the plain paths here match it by keeping TF32 off for every matmul.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
