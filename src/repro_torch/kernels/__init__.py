"""Hand-written CUDA kernels of the serve path, for Hopper (``sm_90a``).

Each TPU kernel of ``repro.kernels`` that this slice ports has a CUDA C++
source under ``csrc/``, a launch wrapper, and a plain PyTorch twin in
``ref.py``; ``ops.py`` dispatches between them (CUDA tensors → kernel,
CPU tensors → plain version) and ``_build.py`` compiles the sources with
``nvcc`` on first use.

* ``sv_cross``    — U = S·V, split-m cross pass (``sv_cross_pallas``).
* ``serve_apply`` — X = (V − Sᵀw)/λ (``serve_apply_pallas``).
* ``trisolve``    — w = L⁻ᵀL⁻¹U, the substitution (``_trisolve``).
* ``serve_solve`` — cross → substitution → apply, three launches on one
  stream (``serve_solve_pallas``).
* ``fold_cols``   — (S·rowsᵀ, rows·rowsᵀ) in one pass (``fold_cols_pallas``).

The window may be stored in fp32 or bf16; every kernel and every plain
version accumulates in fp32 and returns fp32.
"""
from repro_torch.kernels.ops import (
    fold_cols,
    launch_counts,
    reset_launch_counts,
    serve_apply,
    serve_solve,
    sv_cross,
    trisolve,
)

__all__ = ["fold_cols", "launch_counts", "reset_launch_counts", "serve_apply",
           "serve_solve", "sv_cross", "trisolve"]
