"""Hand-written CUDA kernels of the port, for Hopper (``sm_90a``).

Each TPU kernel of ``repro.kernels`` that the port has reached has a CUDA
C++ source under ``csrc/``, a launch wrapper, and a plain PyTorch twin in
``ref.py``; ``ops.py`` dispatches between them (CUDA tensors → kernel,
CPU tensors → plain version) and ``_build.py`` compiles the sources with
``nvcc`` on first use.

Algorithm 1 (the trainer path, ``ops.chol_solve_fused``):

* ``gram``        — W = S·Sᵀ, split-m lower tiles (``gram_pallas``):
  ``wgmma`` + TMA (3xTF32 for fp32, bf16 as stored) where
  ``gram.tensor_core_route`` holds, else fp32 FMAs on the CUDA cores.
* ``gram_acc``    — W ← W + S·Sᵀ in place (``gram_acc_pallas``).
* ``gram_sv``     — (S·Sᵀ, S·v) in one pass (``gram_sv_pallas``).
* ``cholesky``    — panel Cholesky, any n (``cholesky_pallas``).
* ``ngd_apply``   — x = (v − Sᵀw)/λ, one right-hand side
  (``ngd_apply_pallas``).

The maintained factor (``CholFactorization.update``/``downdate``):

* ``cholupdate``  — L' with L'L'ᵀ = LLᵀ ± XXᵀ, plane rotations in one
  block (``cholupdate_pallas``).

The serve path (``ops.serve_solve``, ``ops.fold_cols``):

* ``sv_cross``    — U = S·V, split-m cross pass (``sv_cross_pallas``).
* ``serve_apply`` — X = (V − Sᵀw)/λ, a block's warps splitting the rows
  (``serve_apply_pallas``). Both passes read the window 16 bytes a lane
  where ``serve_solve.stream_route`` allows.
* ``trisolve``    — w = L⁻ᵀL⁻¹U, the substitution (``_trisolve``); also
  the triangular solves of ``chol_solve_fused``.
* ``serve_solve`` — cross → substitution → apply, three launches on one
  stream (``serve_solve_pallas``).
* ``fold_cols``   — (S·rowsᵀ, rows·rowsᵀ) in one pass (``fold_cols_pallas``).

The LM's prefill (``models.lm.prefill``):

* ``flash_attention`` — causal / windowed GQA attention forward, online
  softmax over KV tiles (``flash_attention_pallas``).

The window may be stored in fp32 or bf16; every window kernel and plain
version accumulates in fp32 and returns fp32. Flash attention takes fp32
or bf16 q, k, v, keeps its statistics in fp32 and returns q's dtype.
"""
from repro_torch.kernels.ops import (
    chol_solve_fused,
    cholesky,
    cholupdate,
    default_mode,
    flash_attention,
    fold_cols,
    gram,
    gram_acc,
    gram_blocks,
    gram_sv,
    launch_counts,
    ngd_apply,
    reset_launch_counts,
    serve_apply,
    serve_solve,
    sv_cross,
    trisolve,
)

__all__ = ["chol_solve_fused", "cholesky", "cholupdate", "default_mode",
           "flash_attention", "fold_cols", "gram", "gram_acc", "gram_blocks", "gram_sv", "launch_counts", "ngd_apply",
           "reset_launch_counts", "serve_apply", "serve_solve", "sv_cross",
           "trisolve"]
