#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA GPU (written for the H100).

Phases, each printing its own lines:

1. device — name and power limit (``nvidia-smi``); no CUDA → exit 1;
2. build  — compile the hand-written CUDA kernels from ``csrc/``;
3. kernel checks — every kernel against its plain PyTorch version on the
   card over a shape sweep up to (2048, 200_000), fp32 and bf16 windows
   (serve kernels at k ∈ {1, 5, 8, 16}; the Cholesky at n ∈ {1, 15, 16,
   17, 64, 65, 100, 130, 256, 1024, 2048, 4096} on SPD W, its upper
   triangle 0 and, by torch.profiler, one kernel launch a factorization;
   the Gram's route — wgmma + TMA or the CUDA cores — per shape and
   dtype, counted and held to ``gram.tensor_core_route``; the
   substitution also at n ∈ {31, 32, 33, 64, 65, 4096}; the streaming
   passes also on unaligned windows — m ragged in both dtypes and a view
   one element into its storage — the kernels each streaming call
   launched, counted where each kernel is launched, held to
   ``serve_solve.stream_route`` and ``cross_tensor_cores``, and the
   tensor cores' cross pass to the float64 product within TC_TOL);
   a second call must be bit-identical;
4. serving path, dense — ``SolveServer`` at the paper's Table-1 shape
   (n = 1024 samples, m = 100_000 parameters, λ₀ = 1e-3): 64 requests
   with fold rows, one mixed-λ microbatch, age refreshes; the same trace
   through the port on the CPU (plain versions throughout) is the
   reference; every streaming pass on the 16-byte route;
4b. serving path, dense, observed — the same trace with a fold journal,
   a metrics registry, a health monitor (the audit every 4 maintenance
   passes), a tracer and a flight recorder: responses bit-identical to
   the unobserved run's, the journal replayed on the card (in memory and
   through its npz) onto the live state's full fingerprint, a serve-state
   checkpoint restored bit for bit, a forced incident bundle analyzed on
   the card with every fingerprint verified and no bad event;
5. serving path, blocked — the same window in four blocks, same trace;
6. Algorithm 1 — ``chol_solve_fused`` at the Table-1 shapes (256, 1024
   and 2048 samples × 100_000 parameters, λ = 1e-3), dense and (at 1024)
   blocked, with ``chol_solve(gram_fn=ops.gram)`` and ``ops.gram_blocks``,
   each against ``chol_solve`` on the card with plain versions; every
   Gram on the wgmma route;
7. NGD trainer — 5 steps of ``NaturalGradient`` with the fused solver on
   the MLP of ``examples/ngd_mlp_train.py --big`` (m = 296,448, n = 256),
   each step's kernels against their plain versions on its inputs, and
   its update held to the float64 step of its own S and g at the plain
   ``"chol"`` step's distance plus 1e-3 (the same step on the CPU is
   printed beside it); every Gram on the wgmma route;
8. cholupdate checks — the rank-k rotation kernel against its plain
   version (the composed method) at n ∈ {16, 24, 64, 100, 1024, 2048, 4096},
   k ∈ {1, 3, 8, 16, 32}, update and downdate; repeats bit-identical,
   zero and −0.0 columns exact no-ops, the upper triangle exactly 0;
9. maintained factorization — 8 slides of 16 columns of a 1024 × 100_000
   fp32 window (λ = 1e-3), each ``fac.update(X_new).downdate(X_old)`` on
   the kernel, held to the refactorized factor (5e-3 max-abs,
   ``benchmarks/amortized.py``) and its solve to the plain ``chol_solve``;
10. tenant factor view — a rank-8 delta over the same shape:
   ``tenant_factorization`` (kernel) against ``delta_factor`` (composed)
   and 8 solves against the private-window oracle (5e-3,
   ``benchmarks/serve_tenants.py``); an empty delta gives L bit for bit;
10a. tenant serving — the dense trace of 4 with a zipf(1.5) tenant id a
   request among 1,000 (rank 8), through ``SolveServer(tenants=
   TenantManager)`` under a budget of one factor and 8 deltas: every
   tenant microbatch on ``serve_solve`` against its L_t, every response
   within 5e-3 of the private-window oracle for its delta at its solve,
   evictions and activations, the same trace without a budget bit for
   bit, on the CPU within 5e-3 with the same residency, the shared W and
   L unchanged;
10b. the sharded serving tier — the trace of 4 through ``AsyncSolveServer``
   (``repro_torch.dist``): replicated (every response bit for bit the
   eager server's), then over a mesh of 4 positions laid on the card in
   the 1d, 2d (2 × 2) and blocked layouts, a bf16 window (1d) and m =
   100,002 (1d, zero-padded to the mesh): every response within 5e-3 of
   the eager server's on the card and of the CPU's, each kernel launched
   once a piece as the layout implies (m = 100,002 appends zero columns,
   so phase 4's responses with zeros appended are its references); a second 1d run and one whose
   submitting thread sleeps at seeded random points bit for bit the
   first; p50, p99 and req/s beside the eager run's;
10c. sharded Algorithm 1 — ``sharded_chol_solve`` (1d) and
   ``sharded_chol_solve_2d`` at (1024, 100_000) on 4 positions against the
   plain ``chol_solve`` (1e-3); the rank-16 update and downdate with their
   columns sharded, composed and as a ring of rotation sweeps, against the
   replicated ``cholupdate`` (CHOLUP_TOL);
10d. the fleet — two worker processes on the card (``launch_fleet``,
   ``python -m repro_torch.fleet``) behind a ``Dispatcher``, the window
   shipped in the init frame: (a) the trace of 4 round robin with its
   rows gossiped, every response within 5e-3 of a fold-at-admission
   ``SolveServer`` on the card, after ``reconcile()`` and four settling
   probes (each worker's age refresh at the reconciled window) the
   probe bit for bit, the checkpoint's manifest, the gossip journal
   replayed on the card (and refreshed once) equal to every worker's
   checkpointed S, W, L and slot bit for bit, ``serve_solve`` and
   ``fold_cols`` counted in the workers' profile traces; (b) the same with a bf16 window (S0 and the rows
   cross as ``|V2`` records) sharded 1d on async workers, ``gram`` and
   ``cholesky`` counted at its (sharded) refreshes; (c) ``by_adapter`` without gossip, each
   worker bit for bit an eager server fed its partition, then SIGTERM to
   one worker with requests in flight, every request answered; (d)
   ``serve_main --smoke --fleet 2 --route by_adapter`` on the card and
   the CPU (first nine losses 1e-3, equal verdicts) and ``--async``;
11. streaming curvature — ``CurvatureCache`` at 512 × 100_000 over 6
   solves of a drifting window against the card's plain ``chol_solve``
   and the same trace on the CPU; ``StreamingGram`` over the 4 blocks;
12. flash-attention checks — the kernels against their plain version over
   (KH, group) ∈ {(2,1), (2,2), (1,4), (8,3)}, causal / window 64 /
   bidirectional, T ∈ {16, 200, 256, 1000, 1024}, hd ∈ {32, 64, 128},
   fp32 and bf16 (bf16 at hd 64 and 128 is the wgmma + TMA kernel), and
   B = 2 with ragged (Tq, Tk) ∈ {(300, 1000), (1000, 300), (129, 255)};
   the wgmma kernel also at T ∈ {8192, 32768} (24/8 heads) and at scales
   1.5 and −0.3; repeats bit-identical, rows with no live key 0;
13. LM serving — llama3.2-3b at published widths cut to 2 layers, bf16:
   ``build_server`` and ``serve_main``'s loop (``serve_trace``) over 8
   requests (window 8, seq 1024, 2 examples each, burst 3, 8 greedy
   tokens, λ₀ = 1e-2, every fifth request at 4λ₀), then the same trace
   with every kernel at its plain version; losses, x, the first
   prefill's logits and the tokens gated; 2 flash-attention launches a
   prefill; every request's x also held (5e-3) to its v re-solved on the
   plain route against a factorization of the kernel run's own window at
   that request (the same inputs, so every fold's kernel work is covered,
   not only the first burst's);
13a. LM serving CLI — ``serve_main`` (``python -m repro_torch.serve``) at
   llama3.2-3b's published widths, 2 layers, at the reference's defaults
   (12 requests, window 8, seq 16, burst 3, a checkpoint every 8 rounds
   and at exit, the audit every 4 maintenance passes) with the metrics
   endpoint (self-scraped), a snapshot, a trace and a profile: the
   health, scrape and trace lines, a span a request, fold_cols and flash
   attention launched, the exit checkpoint (≈ 20 GB, in a temporary
   directory) restored onto the card bit for bit; then ``--smoke`` on the
   card and on the CPU: the first three bursts' losses within 1e-3, equal
   verdicts, each checkpoint restored into the other run's tree; the
   ``--profile-dir`` trace starts before the server is built (its bytes
   printed);
13c. LM serving CLI with tenants — ``serve_main --full --n-layers 2
   --tenants 16 --tenant-rank 4 --tenant-budget-mb 0.001`` (no
   checkpoint): ``serve_solve`` launched, every x within 5e-3 of the
   plain re-solve with the same tenant factor, the tenants line with
   evictions; then ``--smoke --tenants 4`` on the card and on the CPU:
   the first nine losses within 1e-3, equal tenants lines;
13d. LM serving CLI, sharded — ``serve_main --full --n-layers 2 --mesh 1d
   --async`` (the default ``--mesh-shape 1,1``: the whole 19 GB window one
   slab): its peak memory, ``fold_cols``, ``sv_cross`` and ``serve_apply``
   launched as one slab implies, the exit checkpoint restored onto the
   card and equal to the live slab, W, L, counters and params; then
   ``--smoke --mesh 1d --async`` on the card and on the CPU, the first
   nine losses within 1e-3;
13b. LM NGD trainer — the same 2-layer full-width llama3.2-3b in bf16
   under ``build_trainer`` (batch 8, seq 64, λ = 1e-3, lr 0.05; n = 8,
   m = 595,344,384): (a) 3 exact dense steps through
   ``ops.chol_solve_fused`` (gram_sv, cholesky, the substitution,
   ngd_apply) against the same steps on the plain versions — losses,
   step 0's natural gradient against the float64 solve of its own S and
   v; (b) the same with blocked scores, 2 steps; (c) 6 streaming steps
   (2 refreshes, 4 hits); (d) a checkpoint saved after step 1 of (a),
   restored bit for bit, step 2 rerun; one profiled step on the wgmma
   Gram; then the same trainer over a (2, 2) mesh of the card;
13g. dry run against the card — ``repro_torch.launch.dryrun`` on meta
   tensors held to the card: (a) ``chol_solve_fused`` at each Table-1
   shape with S and v resident: the card's peak within [0.8, 1.25] of
   the trace's resident bytes on a one-position mesh, its launches equal
   to the trace's would-be launches, its time at least 0.95 × the
   roofline's bound; (b) the dry run of phase 13b's configuration beside
   that phase's measured peak, within [0.5, 2.0]; (c) whisper-base
   decode_32k (multi-pod mesh; peak below the card's 80 GB),
   qwen3-moe-235b-a22b train_4k (single) and the (4096, 1,000,000)
   solver (multi), each traced in this process; (d)
   ``examples_torch/quickstart.py`` at (512, 100,000): each residual
   below 1e-2, two cache hits and one refresh;
14. long prefill — all 28 layers of llama3.2-3b, one 32,768-token prompt
   (configs/shapes.py prefill_32k, batch 32 → 1): 28 launches, the
   profile showing the wgmma kernel; layer 0's attention at that shape
   against the plain version;
14a. LM serving, MoE and Mamba2 — (a) mamba2-1.3b at published widths,
   4 of 48 layers, bf16 weights, an fp32 window, and
   (b) qwen3-moe-30b-a3b, 1 of 48 layers (128 experts top-8), a bf16
   window (m = 1,245,976,576), bursts of 1: phase 13's trace and gates
   each, ``fold_cols`` launched, flash attention once an attention layer
   a prefill (0 on mamba2); (c) mamba2-1.3b at 16 of 48 layers, fp32:
   prefill of 1,024 tokens at batch 2 and 16 teacher-forced decode steps
   against the teacher-forced forward (2e-3), then the bf16 model's
   prefill of 4,096 tokens and its decode timed; (d) ``serve_main --arch
   {qwen3-moe-30b-a3b, mamba2-1.3b, jamba-v0.1-52b} --smoke`` on the card
   and on the CPU, the first nine losses within 1e-3;
14b. the encoder-decoder trunk and the patch prefix — (a) whisper-base
   at published widths and all 6 + 6 layers, bf16 weights, an fp32
   window (m = 70,909,952): phase 13's trace and gates with decode off
   (the reference's serving decode passes no frames), ``fold_cols``
   launched, no flash attention; (b) its fp32 decode at batch 2 over
   1,500 frames: prefill of 64 tokens (18 flash-attention launches: 6
   encoder, 6 self, 6 cross) and 16 teacher-forced steps against the
   teacher-forced forward (2e-3), then the bf16 weights timed; (c) its
   NGD trainer at ``train_main``'s defaults (bf16, batch 8, seq 64, λ =
   1e-3): 3 exact dense steps on the kernels against the plain versions
   (phase 13b's gates), gram_sv, the Cholesky, the substitution and
   ngd_apply launched; (d) pixtral-12b at published widths, 4 of 40
   layers, fp32 (2,432,742,400 parameters): prefill of a 256-patch
   prefix and 512 tokens at batch 2 with ``max_len`` counting the prefix
   (4 launches), 16 teacher-forced steps against the forward (2e-3),
   then the same weights in bf16 timed; (e) ``serve_main --smoke``
   (whisper with ``--decode-tokens 0``) and ``train_main --smoke
   --optimizer ngd --steps 3`` of both on the card and on the CPU, the
   first nine serving losses and every training loss within 1e-3; the
   flash-attention checks hold whisper's encoder (2, 1500, 8/8, 64) and
   cross-attention (2, 64) × (2, 1500) in bf16 and pixtral's (2, 768,
   32/8, 128) causal in bf16 and fp32 to the plain version;
15. profiles of one dense flush (fp32 and bf16 window), one (1024,
   100_000) solve, one NGD step
   (the solve's and the step's must show the wgmma Gram kernel and not
   the CUDA-core one; the solve's the cluster substitution kernel), one
   update+downdate slide (two cholupdate_kernel launches, no transpose),
   one LM serving round
   and the long prefill; per-kernel launches, times, plain and library
   times, bounds (the Gram's on the tensor cores' rate for fp32-accurate
   products, its fp32-FMA bound printed beside; the Cholesky also at n =
   256 and 2048, flash attention at T = 1024 and 32,768; gram_sv and
   ngd_apply also at the LM trainer's (8, 595,344,384) bf16).

Any failed check raises, so the script exits non-zero. It prints its
total time before the card's line; the last line is ``{"ok": true,
"device": {...}}``.

    python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import functools
import gc
import importlib.util
import io
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# The LM phase holds a 19 GB window, its fold's 19 GB copy and the score
# pass's large temporaries in turn: growable segments keep the caching
# allocator from fragmenting the card between them.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt_io  # noqa: E402
from repro_torch.core import (BlockedScores, chol_factorize,  # noqa: E402
                              chol_solve, is_blocked)
from repro_torch.core.pytree import leaves, tree_map  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    sharded_chol_solve, sharded_chol_solve_2d)
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.curvature import (CurvatureCache,  # noqa: E402
                                   StreamingCurvature, StreamingGram)
from repro_torch.dist import (AsyncSolveServer, DistSpec,  # noqa: E402
                              init_sharded_serve_state,
                              sharded_chol_downdate, sharded_chol_update)
from repro_torch.fleet import launch_fleet  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.gram import ROUTES as GRAM_ROUTES  # noqa: E402
from repro_torch.kernels.gram import tensor_core_route  # noqa: E402
from repro_torch.kernels.ref import WGMMA_HEAD_DIMS  # noqa: E402
from repro_torch.kernels.serve_solve import ROUTES as STREAM_ROUTES  # noqa: E402
from repro_torch.kernels.serve_solve import (  # noqa: E402
    cross_tensor_cores, kernels_launched, stream_route_of, trisolve_columns)
from repro_torch.configs.shapes import WorkloadShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.hlo_analysis import HW  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.train import (batch_to, make_prefill,  # noqa: E402
                                      make_ngd_train_step, make_serve_step)
from repro_torch.launch.trainer import (build_server,  # noqa: E402
                                        build_trainer, train_main)
from repro_torch.models import encdec, get_api  # noqa: E402
from repro_torch.models import lm as model_lm  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.optim import (AdamW, HybridNGD,  # noqa: E402
                               Int8ErrorFeedback, NaturalGradient,
                               bf16_allreduce, params_from_arrays,
                               partition_params, merge_params,
                               per_sample_score_blocks, per_sample_scores,
                               warmup_cosine)
from repro_torch.optim.scores import grad_and_value  # noqa: E402
from repro_torch.obs import (FlightRecorder, HealthMonitor,  # noqa: E402
                             MetricsRegistry, Tracer, analyze, load_bundle)
from repro_torch.serve import (FoldJournal, OnlineAdaptation,  # noqa: E402
                               SolveServer, TokenBudgetBatcher,
                               init_serve_state, restore_serve_state,
                               save_serve_state)
from repro_torch.serve import main as serve_cli  # noqa: E402
from repro_torch.serve.main import serve_main, serve_trace  # noqa: E402
from repro_torch.serve.state import (serve_mode,  # noqa: E402
                                     serve_state_from_tree, serve_state_tree,
                                     whole_window)
from repro_torch.core.solvers import cholesky as plain_cholesky  # noqa: E402
from repro_torch.core.solvers import real_scalar  # noqa: E402
from repro_torch.tenants import (TenantManager,  # noqa: E402
                                 augmented_window, delta_factor, delta_fold,
                                 init_tenant_delta, project_rows,
                                 tenant_factorization)

N, M, LAM0 = 1024, 100_000, 1e-3          # configs/paper.py Table-1 row
WIDTHS = (40_000, 30_000, 20_000, 10_000)
SWEEP_SHAPES = [(8, 128), (32, 300), (100, 1000), (130, 515), (N, M),
                (2048, 200_000)]
# windows the streaming passes read by scalar loads, beside the ragged
# sweep shapes (300: m % 8 ≠ 0; 515: m % 4 ≠ 0): (n, m, offset) with m
# ragged in both dtypes, and a contiguous view one element into its
# storage, so no row starts 16-byte aligned
UNALIGNED = [(256, 20_001, 0), (128, 4096, 1)]
# the kernels of the streaming passes, and the operands whose offsets the
# route rule reads
STREAMED = {"sv_cross": 1, "serve_apply": 1, "serve_solve": 1, "fold_cols": 2}
SWEEP_K = (1, 5, 8, 16)
REQUESTS, PER_MB, ROWS_PER_REQ, MIXED_MB = 64, 8, 2, 3
# The sharded serving tier (ROADMAP A7, first half): the trace over a mesh
# of 4 positions laid on the one card, and at m = PAD_M, not a multiple of
# 4 (the zero-padded window)
SHARD_POSITIONS, PAD_M = 4, M + 2
SEED = 0
TABLE1 = [(256, M), (1024, M), (2048, M)]   # configs/paper.py Table-1 rows
# the blocked kernel's edges: 1, one ragged tile (15, 17), one tile (16,
# 64), a ragged second tile (65), and the Table-1 sizes beyond
CHOL_N = (1, 15, 16, 17, 64, 65, 100, 130, 256, 1024, 2048, 4096)
# examples/ngd_mlp_train.py --big: d_in 64, width 512, n = 256 samples
MLP_D_IN, MLP_WIDTH, MLP_N, NGD_STEPS = 64, 512, 256, 5

# Reduction order over m ≤ 2·10⁵ differs from cuBLAS's: 1e-4 relative for
# the one-reduction passes; the solve adds two triangular solves whose
# error grows with n, so 1e-3 at n = 2048.
PASS_TOL = 1e-4
# A bf16 window's cross pass on the tensor cores (sv_cross, fold_cols at
# 8 or 16 right-hand sides a block), held to the float64 product of its
# operands: V split exactly into three bf16 terms lands ≈ 3e-7 of the
# largest output away, a lossy two-term split ≈ 3e-6 (tools/stream_ab.py).
TC_TOL = 1e-6
SERVE_GATE = 5e-3                      # benchmarks/serve.py's bound
SOLVE_GATE = 1e-3       # tests/test_kernels.py:103-108 (rtol of the fused solve)
# An NGD update, tests/test_optim.py's 1e-3. At λ = 1e-3 every fp32 route
# of Algorithm 1 on this model is itself up to ~2e-3 from the float64 step
# of its inputs (x = (v − Sᵀw)/λ cancels about four digits; PERF.md §6),
# so no fp32 update can be held within 1e-3 of another. On the step's own
# S and g the kernel path is held to the float64 step at the plain path's
# distance plus 1e-3; the CPU step is printed beside it.
STEP_GATE = 1e-3
# the rank-k update: the sweep of tests/test_kernels.py:52-64 and beyond
CHOLUP_N = (16, 24, 64, 100, 1024, 2048, 4096)
# the substitution beside SWEEP_SHAPES: a panel of 64 rows and its edges
# (31, 32, 33, 64, 65: one block of the cluster, a ragged panel, two
# panels) and 4096 (eight panels a block of the cluster)
TRISOLVE_N = (31, 32, 33, 64, 65, 4096)
CHOLUP_K = (1, 3, 8, 16, 32)
CHOLUP_TOL = 1e-5                       # tests/test_kernels.py:64
SLIDES, SLIDE_K = 8, 16                 # benchmarks/amortized.py's slides
FACTOR_GATE = 5e-3      # benchmarks/amortized.py:83, max-abs vs refactorized
TENANT_RANK, TENANT_ROWS, TENANT_SOLVES = 8, 4, 8
TENANT_GATE = 5e-3      # benchmarks/serve_tenants.py:99, vs private window
# Tenant serving: the dense trace, a zipf(1.5) tenant id a request among
# 1,000 tenants, rank 8 (benchmarks/serve_tenants.py:43). Every request's
# rows fold into its tenant's delta, which drops that tenant's cached
# factor, so at most one 4 MiB L_t is resident at a time and the trace's
# 30 tenants hold ~1 MB of deltas: a budget of 32 MiB would never evict.
# The budget holds one materialized factor and 8 deltas, so the LRU
# spills and activates the trace's returning tenants.
TENANTS, TENANT_ZIPF = 1000, 1.5
TENANT_BUDGET = N * N * 4 + 8 * (N * TENANT_RANK * 4 + TENANT_RANK * 4 + 8)
STREAM_N, STREAM_STEPS, STREAM_EPS = 512, 6, 1e-4
# flash attention: the sweep of tests/test_kernels.py:116-146 and beyond
FLASH_GQA = ((2, 1), (2, 2), (1, 4), (8, 3))          # (KH, group)
FLASH_MASKS = ((True, None), (True, 64), (False, None))  # (causal, window)
FLASH_T = (16, 200, 256, 1000, 1024)
FLASH_HD = (32, 64, 128)
FLASH_RAGGED = ((300, 1000), (1000, 300), (129, 255))   # (Tq, Tk), B = 2
# the wgmma kernel (bf16, hd 64 and 128) at the prefills' lengths, llama's
# 24/8 heads, B = 1; and at scales other than 1/sqrt(hd) (a large one
# would overflow a softmax that scaled after the row max; a negative one
# reverses the row max)
FLASH_LONG_T = (8192, 32768)
FLASH_SCALES = (1.5, -0.3)
# fp32: tests/test_kernels.py:129's 2e-4. bf16 outputs are rounded to bf16
# after fp32 sums taken in another order: one bf16 ulp of the largest
# output is at most 2^-7 of it, so 1e-2 of max |o|.
FLASH_TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}
# the encoder-decoder trunk's and the VLM's attention (ROADMAP A6, second
# half): (label, B, Tq, KH, group, hd, Tk, causal, dtypes) — whisper's
# encoder over 1,500 frames, its cross-attention from a 64-token prompt,
# pixtral's 32/8 heads over a 256-patch prefix and 512 tokens
FLASH_A6B = (
    ("whisper encoder", 2, 1500, 8, 1, 64, 1500, False, (torch.bfloat16,)),
    ("whisper cross-attention", 2, 64, 8, 1, 64, 1500, False,
     (torch.bfloat16,)),
    ("pixtral prefix + prompt", 2, 768, 8, 4, 128, 768, True,
     (torch.bfloat16, torch.float32)),
)
# The LM serving front: llama3.2-3b at its published widths, depth cut to
# 2 layers (the n × m score window of all 28 layers, 51 GB in bf16, does
# not fit one card), bf16 as published; the CLI's defaults otherwise
# (python -m repro_torch.serve --full --n-layers 2 --seq 1024
# --decode-tokens 8 --requests 8).
LM_ARCH, LM_LAYERS = "llama3.2-3b", 2
LM_WINDOW, LM_SEQ, LM_ADAPT, LM_REQUESTS, LM_BURST, LM_NEW = 8, 1024, 2, 8, 3, 8
LM_LAM0, LM_LR = 1e-2, 0.05
LM_MAX_TOKENS, LM_MAX_REQUESTS, LM_REFRESH, LM_SCORE_CHUNK = 64, 4, 16, 2
# Kernel route against the plain route of the same trace. Losses: the
# routes' params part only by bf16 roundings flipped by solves that agree
# to ~1e-6, so 1e-3 relative. Solutions x: benchmarks/serve.py's 5e-3,
# for the first burst's requests, whose inputs are the same in both runs
# (scored before any update; their solves differ only by the folds'
# kernel). A later request's v is the bf16 gradient at params that the
# two runs have rounded differently, so its x is printed, not gated.
# Logits (bf16 matmuls through two layers whose attention outputs may
# differ by one bf16 ulp): 2e-2 of the largest |logit|, ≈ 2.5 bf16 ulps.
# A decoded token may flip only where the two runs' top logits are
# closer than twice that tolerance.
LM_LOSS_GATE, LM_X_GATE, LM_LOGIT_GATE = 1e-3, 5e-3, 2e-2
# The serving CLI with tenants at full width: 16 zipf tenants, rank 4, a
# budget of 0.001 MiB (1,048 B: five rank-4 deltas of n = 8, 152 B each,
# beside one cached 256 B factor), so the LRU evicts.
LM_TENANTS, LM_TENANT_RANK, LM_TENANT_BUDGET_MB = 16, 4, 0.001
# configs/shapes.py prefill_32k, batch cut from 32 to 1: the whole model
LONG_T = 32_768
# The NGD trainer on the LM: the same 2-layer full-width llama3.2-3b, bf16,
# under build_trainer at train_main's defaults (batch 8, seq 64, λ 1e-3,
# NGD's lr 0.05): n = 8 score rows of m = 595,344,384 columns, S 9.53 GB.
# Steps: 3 exact dense, 2 exact blocked, 6 streaming (refresh every 3: 2
# refreshes, 4 hits) at tests/test_examples.py:78-84's λ = 0.1, the
# "moderate damping [that] absorbs the staleness between scheduled
# refreshes" (no drift guard: at λ = 1e-3 a stale W sends the smoke
# model's loss past 1e6 on the CPU).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LAM, TRAIN_LR = 8, 64, 1e-3, 0.05
TRAIN_STEPS, TRAIN_BLOCKED_STEPS, TRAIN_STREAM_STEPS = 3, 2, 6
TRAIN_REFRESH, TRAIN_STREAM_LAM, TRAIN_STREAM_EXPECT = 3, 0.1, (2, 4)
# Kernels against the plain versions over the same steps. v is the bf16
# gradient widened to fp32, so gram_sv's rounding of v to the window's
# dtype (kernel route only) is exact here and both routes solve the same
# system. Losses: each step's loss is taken before its update, from params
# the two routes have rounded to bf16 from updates that agree to fp32
# noise, so 1e-3 relative (as the LM serving trace). Step 0's natural
# gradient x, on its own S and v in float64 over column chunks: its
# residual ‖(SᵀS + λI)x − v‖/‖v‖ and its max-abs distance to the float64
# solve, each no worse than the plain route's plus 1e-3 (STEP_GATE's rule).
# x = (v − Sᵀw)/λ cancels about four digits at λ = 1e-3 on any fp32 route,
# and the residual multiplies x's error along the rows of S by ‖SSᵀ‖/λ:
# both routes' residuals are far above 1 on the card while x stays within
# ≈ 1e-3 of the float64 solve (PERF.md §6), so the residual alone cannot
# tell a sound solve from a broken one. Step 0's batch's loss before and
# after the steps is printed, not gated: at λ = 1e-3 a bf16 step is led
# by v's part off the rows of S (the bf16 roundings of the gradient and
# of the scores), which x carries as itself/λ (PERF.md §6).
TRAIN_LOSS_GATE, TRAIN_RES_GATE = 1e-3, 1e-3
# 13f. The same trainer over a (2, 2) ("data", "model") mesh whose four
# positions lie on the one card (ROADMAP A7's training half): each layout
# — 1d, 2d, flat scores (samples over all four positions, then one
# reshard), blocked — takes MESH_STEPS exact steps from the seed through
# ops.chol_solve_fused, with the one-position run's schedule. Gates: step
# 0's natural gradient within the one-position kernel step's natgrad64
# distance to the float64 solve (max-abs, ``err``) plus TRAIN_RES_GATE (its
# residual is printed: rounding leads it, as above); both losses within
# TRAIN_LOSS_GATE of the one-position run's; per step one gram_sv and one
# ngd_apply a column slab (a block and slab when blocked), one cholesky
# and one substitution; a rerun bit for bit. Then one HybridNGD step with
# the embedding table as NGD's subset (128,256 × 3,072, S 8 × 394M bf16),
# bit for bit its NaturalGradient and AdamW halves alone; bf16_allreduce
# and Int8ErrorFeedback over the LM's gradient in MESH_DP pieces, bf16
# within COMPRESS_GATE of the fp32 sum relative to its max
# (tests/test_distributed.py:234), the card within COMPRESS_CPU_GATE of
# the CPU; and train_main --smoke --mesh-shape 2,2 on the card and the CPU
# (ngd and adamw, MESH_CLI_STEPS steps, losses within TRAIN_LOSS_GATE).
# The streaming policy over the mesh (1d) runs the one-position streaming
# run's TRAIN_STREAM_STEPS steps: its losses within TRAIN_LOSS_GATE, the
# same refreshes and hits, per slab a gram_sv a refresh, an sv_cross a
# hit.
# The positions share the card: the times are agreement and launch
# checks, not multi-card speed.
MESH_SHAPE, MESH_STEPS, MESH_DP = (2, 2), 2, 4
MESH_LAYOUTS = {"1d": {}, "2d": {"score_sharding": "2d"},
                "flat": {"flat_scores": True}, "blocked": {"blocked": True}}
COMPRESS_GATE, COMPRESS_CPU_GATE, MESH_CLI_STEPS = 2e-2, 1e-6, 3
# 14a. LM serving, MoE and Mamba2 (the families of ROADMAP A6's first
# half) at published widths, cut in depth so that the serving window of
# n = 8 score rows and a fold's copy of it fit the card; bf16 weights.
# (arch, layers, window dtype, burst):
# - mamba2-1.3b, 4 of 48 layers, an fp32 window (16 layers, m =
#   516,805,632, a 16.54 GB window, until the sharded phases needed the
#   script's time, then 8 until the fleet phase did; all 48: 43.0 GB, 86
#   with the copy);
# - qwen3-moe-30b-a3b, 1 of 48 layers (128 experts of 2048 × 768): m =
#   1,245,976,576, a bf16 window (storage only) of 19.94 GB. Bursts of 1:
#   each pending request holds its fp32 v (4.98 GB) and its rows (4.98 GB),
#   and a microbatch's V, Sᵀw and x are 4.98 GB a request each, so a
#   burst of 3 beside the window and its copy would not fit.
# Phase 13's trace and gates otherwise (LM_* above).
ZOO_SERVED = (("mamba2-1.3b", 4, None, LM_BURST),
              ("qwen3-moe-30b-a3b", 1, "bfloat16", 1))
# mamba2-1.3b at MAMBA_LAYERS of 48 layers (all 48 until the fleet phase
# needed the script's time), fp32: prefill of a 1,024-token
# prompt at batch 2, then 16 teacher-forced decode steps against the
# teacher-forced forward's logits, |a − b| ≤ 2e-3 + 2e-3·|b|
# (tests/test_archs.py test_decode_matches_forward at full size); then
# the bf16 model's prefill of a 4,096-token prompt and its decode, timed
# and printed.
MAMBA_ARCH, MAMBA_B, MAMBA_PROMPT, MAMBA_STEPS = "mamba2-1.3b", 2, 1024, 16
MAMBA_LAYERS = 16
MAMBA_TIMED_PROMPT, MAMBA_TIMED_TOKENS = 4096, 32
DECODE_GATE = 2e-3
# serve_main --smoke per family, on the card and on the CPU
ZOO_CLI = ("qwen3-moe-30b-a3b", "mamba2-1.3b", "jamba-v0.1-52b")
# 14b. The encoder-decoder trunk and the patch prefix (ROADMAP A6's second
# half). whisper-base at published widths and full depth (6 encoder + 6
# decoder layers, m = 70,909,952: an fp32 window of 2.27 GB at n = 8),
# bf16 weights: phase 13's trace with decode off (the reference's serving
# decode passes no frames), then train_main's defaults under the trainer
# (TRAIN_*). Its decode in fp32 at batch 2: 1,500 random frames, a
# 64-token prompt and 16 teacher-forced steps (the learned positions stop
# at 448); then the same weights in bf16, 32 greedy steps timed.
WHISPER_ARCH, PIXTRAL_ARCH = "whisper-base", "pixtral-12b"
WHISPER_B, WHISPER_PROMPT, WHISPER_STEPS, WHISPER_TIMED_TOKENS = 2, 64, 16, 32
# pixtral-12b at published widths, 4 of 40 layers, one fp32 draw of
# 2,432,742,400 parameters (9.73 GB; its untied 131,072 × 5,120 embedding
# and head are 1.34 B of them): a 256-patch prefix and a 512-token prompt
# at batch 2, 16 teacher-forced steps; then the same weights in bf16.
# Its serving window does not fit the card at any depth: a bf16 window of
# 25.8 GB at 1 layer, a peak of ≈ 90 GB scaled from qwen3-moe's 69.85 GB
# beside its 19.94 GB window.
PIXTRAL_LAYERS, PIXTRAL_B, PIXTRAL_PROMPT, PIXTRAL_STEPS = 4, 2, 512, 16
PIXTRAL_TIMED_TOKENS = 32
# serve_main --smoke (whisper with decode off, as the reference serves it)
# and train_main --smoke --optimizer ngd --steps 3, card and CPU
A6B_CLI = ((WHISPER_ARCH, ("--decode-tokens", "0")), (PIXTRAL_ARCH, ()))
A6B_TRAIN_STEPS = 3

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "serve_solve": ("src/repro_torch/kernels/csrc/serve_solve.cu",
                    "src/repro/kernels/serve_solve.py:107"),
    "sv_cross": ("src/repro_torch/kernels/csrc/serve_solve.cu",
                 "src/repro/kernels/serve_solve.py:153"),
    "serve_apply": ("src/repro_torch/kernels/csrc/serve_solve.cu",
                    "src/repro/kernels/serve_solve.py:187"),
    "trisolve": ("src/repro_torch/kernels/csrc/trisolve.cuh",
                 "src/repro/kernels/serve_solve.py:46"),
    "fold_cols": ("src/repro_torch/kernels/csrc/fold.cu",
                  "src/repro/kernels/fold.py:54"),
    "gram": ("src/repro_torch/kernels/csrc/gram.cu",
             "src/repro/kernels/gram.py:48"),
    "gram_acc": ("src/repro_torch/kernels/csrc/gram.cu",
                 "src/repro/kernels/gram.py:93"),
    "gram_sv": ("src/repro_torch/kernels/csrc/gram.cu",
                "src/repro/kernels/gram_sv.py:56"),
    "cholesky": ("src/repro_torch/kernels/csrc/cholesky.cu",
                 "src/repro/kernels/cholesky.py:76"),
    "ngd_apply": ("src/repro_torch/kernels/csrc/ngd_apply.cu",
                  "src/repro/kernels/ngd_apply.py:41"),
    "cholupdate": ("src/repro_torch/kernels/csrc/cholupdate.cu",
                   "src/repro/kernels/cholupdate.py:68"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_wgmma.cuh",
                        "src/repro/kernels/flash_attention.py:101"),
}


def pieces(a, b, size: int = 1 << 26):
    """(a, b) in float64 on a's device, whole, or a flat chunk at a time
    where both hold more than ``size`` elements (a solution of 1.2e9
    parameters is 10 GB in float64)."""
    if a.numel() <= size or a.shape != b.shape:
        yield a.double(), b.to(a.device).double()
        return
    a, b = a.reshape(-1), b.reshape(-1)
    for j in range(0, a.numel(), size):
        yield a[j:j + size].double(), b[j:j + size].to(a.device).double()


def rel(a, b) -> float:
    diff, ref = [], []
    for x, y in pieces(a, b):
        diff.append((x - y).abs().max())
        ref.append(y.abs().max())
    return float(torch.stack(diff).max()
                 / torch.stack(ref).max().clamp_min(1e-30))


def rel2(a, b) -> float:
    """‖a − b‖₂ / ‖b‖₂ in float64."""
    diff, ref = [], []
    for x, y in pieces(a, b):
        diff.append((x - y).square().sum())
        ref.append(y.square().sum())
    return float(torch.stack(diff).sum().sqrt()
                 / torch.stack(ref).sum().sqrt().clamp_min(1e-300))


def phase(title: str) -> None:
    print(f"== {title}", flush=True)


# ---------------------------------------------------------------------------
# 1-2. device and build
# ---------------------------------------------------------------------------

def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def peaks(name: str) -> tuple[float, float, float, float]:
    """(bytes/s, fp32 FLOP/s, dense TF32 and dense bf16 tensor FLOP/s) from
    NVIDIA's data sheets: the H100 SXM's from the dry run's roofline
    (``launch/hlo_analysis.HW``: 3.35 TB/s, 67, 494.7 and 989 TFLOP/s);
    the PCIe part 2.0 TB/s, 51, 378 and 756 TFLOP/s."""
    if "PCIe" in name:
        return (2.0e12, 51e12, 378e12, 756e12)
    return (HW["hbm_bw"], HW["fp32_flops"], HW["tf32_flops"],
            HW["peak_flops"])


def build() -> None:
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
          f"({_build.build_dir()})")
    for name in libs:
        log = (_build.build_dir() / f"lib{name}.log")
        if log.exists():
            for line in ptxas_summary(log.read_text()):
                print(f"  ptxas {name}: {line}")


def ptxas_summary(log: str) -> list:
    """One line an entry of a ptxas report: its name (demangled where
    c++filt is at hand), registers and bytes spilled."""
    entries, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line and name:
            parts = line.split(",")
            spill = f"{parts[1].split()[0]}/{parts[2].split()[0]} bytes spilled"
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used")[1].split(",")[0].strip()
            entries.append((name, f"{regs}, {spill}"))
            name, spill = None, ""
    filt = shutil.which("c++filt")
    names = [n for n, _ in entries]
    if filt and names:
        out = subprocess.run([filt], input="\n".join(names), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
        if len(out) == len(names):
            names = out
    return [f"{n.split('(')[0]}: {info}" for n, (_, info) in zip(names, entries)]


# ---------------------------------------------------------------------------
# 3. kernel checks
# ---------------------------------------------------------------------------

def kernel_cases(S, L, V, w, rows, lam):
    """name → fn(mode) computing that kernel's function on these inputs."""
    return {
        "sv_cross": lambda mode: ops.sv_cross(S, V, mode=mode),
        "serve_apply": lambda mode: ops.serve_apply(S, w, V, lam, mode=mode),
        "trisolve": lambda mode: ops.trisolve(L, w, mode=mode),
        "serve_solve": lambda mode: ops.serve_solve(S, L, V, lam, mode=mode),
        "fold_cols": lambda mode: torch.cat(ops.fold_cols(S, rows, mode=mode)),
    }


def window(n, m, dtype, gen, offset: int = 0):
    """(S, L): a window, as a view ``offset`` elements into its storage
    where that is given, and the factor of its Gram + λ₀I."""
    if offset:
        flat = torch.randn((n * m + offset,), generator=gen, device="cuda")
        S = (flat / m ** 0.5).to(dtype)[offset:].view(n, m)
    else:
        S = (torch.randn((n, m), generator=gen, device="cuda")
             / m ** 0.5).to(dtype)
    S32 = S.float()
    L = torch.linalg.cholesky(S32 @ S32.T
                              + LAM0 * torch.eye(n, device="cuda"))
    return S, L.contiguous()


def expected_stream_kernels(name: str, dtype, k: int, route: str) -> dict:
    """{kernel of ``STREAM_KERNELS``: launches} of one call of ``name`` as
    the rules (``stream_route``, ``cross_tensor_cores``) say it runs."""
    vec = "vector" if route == "vector" else "scalar"
    cross = {"cross_tensor_cores" if cross_tensor_cores(dtype, k, route)
             else f"cross_{vec}": 1}
    apply = {f"apply_{vec}": 1}
    return {"sv_cross": cross, "fold_cols": cross, "serve_apply": apply,
            "serve_solve": {**cross, **apply}}[name]


def stream_kernels_of(fn):
    """(the streaming kernels one call of ``fn`` launched, {kernel:
    launches} as the libraries count them where each kernel is launched
    (``kernels_launched``); its result)."""
    before = kernels_launched()
    out = fn()
    after = kernels_launched()
    return {key: after[key] - before[key] for key in after
            if after[key] != before[key]}, out


def kernel_checks() -> dict:
    """Sweep; returns {kernel: abs error at the main shape, fp32, k=8}.
    The kernels every call of a streaming pass launched (counted where each
    kernel is launched, ``kernels_launched``) are held to the rules
    (``stream_route``, ``cross_tensor_cores``), and a cross pass on the
    tensor cores to the float64 product (TC_TOL)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    main_err, tc_far = {}, {}
    for n, m, offset in [(n, m, 0) for n, m in SWEEP_SHAPES] + UNALIGNED:
        for dtype in (torch.float32, torch.bfloat16):
            S, L = window(n, m, dtype, gen, offset)
            worst = {}
            for k in SWEEP_K:
                V = torch.randn((m, k), generator=gen, device="cuda")
                w = torch.randn((n, k), generator=gen, device="cuda")
                rows = (torch.randn((k, m), generator=gen, device="cuda")
                        / m ** 0.5).to(dtype)
                for name, fn in kernel_cases(S, L, V, w, rows, LAM0).items():
                    if name in STREAMED:
                        seen, got = stream_kernels_of(lambda: fn("kernel"))
                    else:
                        got = fn("kernel")
                    again = fn("kernel")
                    plain = fn("ref")
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise AssertionError(f"{name} {n}x{m} {dtype} k={k}: "
                                             "repeat call not bit-identical")
                    if name in STREAMED:
                        route = stream_route_of(*(S, rows)[:STREAMED[name]])
                        want = expected_stream_kernels(name, dtype, k, route)
                        if seen != want:
                            raise AssertionError(
                                f"{name} {n}x{m}+{offset} {dtype} k={k}: "
                                f"launched {seen}, the rules say {want}")
                        if name in ("sv_cross", "fold_cols") and \
                                cross_tensor_cores(dtype, k, route):
                            Sd = S.double()
                            exact = Sd @ V.double() if name == "sv_cross" \
                                else torch.cat([Sd, rows.double()]) @ \
                                rows.double().T
                            del Sd
                            far = rel(got, exact)
                            tc_far[name] = max(tc_far.get(name, 0.0), far)
                            if not far < TC_TOL:
                                raise AssertionError(
                                    f"{name} {n}x{m} {dtype} k={k}: the "
                                    f"tensor cores' cross pass {far:.3e} "
                                    f"from the float64 product, gate "
                                    f"{TC_TOL:g}")
                    err = rel(got, plain)
                    tol = PASS_TOL if name not in ("serve_solve", "trisolve") \
                        or n <= N else 10 * PASS_TOL
                    if not err < tol:
                        raise AssertionError(f"{name} {n}x{m} {dtype} k={k}: "
                                             f"rel err {err:.3e} >= {tol:g}")
                    worst[name] = max(worst.get(name, 0.0), err)
                    if (n, m, dtype, k) == (N, M, torch.float32, 8):
                        main_err[name] = float((got.double() - plain.double())
                                               .abs().max())
            route = stream_route_of(S)
            tc = [k for k in SWEEP_K if cross_tensor_cores(dtype, k, route)]
            print(f"  {n}x{m}{f' at +{offset}' if offset else ''} "
                  f"{str(dtype)[6:]} ({route} loads; cross pass on the tensor "
                  f"cores at k = {tc}): worst rel err "
                  + " ".join(f"{k}={v:.2e}" for k, v in worst.items()),
                  flush=True)
    print("  every streaming call launched the kernels its rules name "
          "(counted at the launch sites); the tensor cores' cross pass at most "
          + ", ".join(f"{k} {v:.2e}" for k, v in tc_far.items())
          + f" from the float64 product (gate {TC_TOL:g})", flush=True)
    return main_err


def trisolve_checks() -> None:
    """The substitution alone at TRISOLVE_N × SWEEP_K, against its plain
    version (PASS_TOL, 10× beyond n = N, as in the sweep), repeats
    bit-identical; the cluster's column tile printed with each n."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    for n in TRISOLVE_N:
        _, L = window(n, 2 * n, torch.float32, gen)
        tol = PASS_TOL if n <= N else 10 * PASS_TOL
        worst = 0.0
        for k in SWEEP_K:
            U = torch.randn((n, k), generator=gen, device="cuda")
            got, again = (ops.trisolve(L, U, mode="kernel") for _ in range(2))
            plain = ops.trisolve(L, U, mode="ref")
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"trisolve n={n} k={k}: repeat call not "
                                     "bit-identical")
            err = rel(got, plain)
            if not err < tol:
                raise AssertionError(f"trisolve n={n} k={k}: rel err "
                                     f"{err:.3e} >= {tol:g}")
            worst = max(worst, err)
        print(f"  trisolve n={n}: worst rel err {worst:.2e} over k = {SWEEP_K} "
              f"(gate {tol:g}); column tiles "
              + ", ".join(str(trisolve_columns(n, k)) for k in SWEEP_K),
              flush=True)


# ---------------------------------------------------------------------------
# 4-5. the serving path
# ---------------------------------------------------------------------------

def make_trace():
    gen = torch.Generator().manual_seed(SEED)
    S = torch.randn((N, M), generator=gen) / M ** 0.5
    vs = [torch.randn((M,), generator=gen) for _ in range(REQUESTS)]
    rows = [torch.randn((ROWS_PER_REQ, M), generator=gen) / M ** 0.5
            for _ in range(REQUESTS)]
    lams = [None] * REQUESTS
    for j in range(PER_MB):
        lams[MIXED_MB * PER_MB + j] = 3e-3 if j % 2 else 1e-2
    return S, vs, rows, lams


def split(t, blocked):
    if not blocked:
        return t
    return tuple(p.contiguous() for p in torch.split(t, WIDTHS, dim=-1))


def drive(S, vs, rows, lams, device, blocked, hooks=None,
          window_dtype=None):
    """Serve the trace on ``device``; returns (responses, final state,
    metrics summary, initial state). ``hooks``: ``{"adaptation": kwargs,
    "server": kwargs}`` of the measured server (the journal, audit and
    observability attachments; the warm-up server has none)."""
    dev = torch.device(device)
    Sd = S.to(dev)
    Sd = BlockedScores.from_dense(Sd, WIDTHS) if blocked else Sd
    state = init_serve_state(Sd, LAM0, device=device,
                             window_dtype=window_dtype)
    vs = [split(v.to(dev), blocked) for v in vs]
    rows = [split(r.to(dev), blocked) for r in rows]

    def server(st, hooks=None):
        hooks = hooks or {}
        return SolveServer(st, batcher=TokenBudgetBatcher(max_requests=PER_MB),
                           adaptation=OnlineAdaptation(
                               refresh_every=4, **hooks.get("adaptation", {})),
                           monitor_drift=False, fused=True,
                           **hooks.get("server", {}))

    # warm-up on a throwaway server: folds return new states, so the
    # measured server starts from the same initial state
    warm = server(state)
    for i in range(PER_MB):                  # one uniform, one mixed-λ batch
        warm.submit(vs[i], rows=rows[i])
    warm.flush()
    for i in range(PER_MB):
        warm.submit(vs[i], damping=lams[MIXED_MB * PER_MB + i], rows=rows[i])
    warm.flush()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ops.reset_launch_counts()       # count the measured trace only

    srv = server(state, hooks)
    out = {}
    for b in range(0, REQUESTS, PER_MB):
        uids = {srv.submit(vs[i], damping=lams[i], rows=rows[i]): i
                for i in range(b, b + PER_MB)}
        for res in srv.flush():
            x = torch.cat(res.x) if blocked else res.x
            out[uids[res.uid]] = x.float().cpu()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, srv.state, srv.metrics.summary(), state


def main_path(trace, blocked: bool) -> dict:
    kind = "blocked" if blocked else "dense"
    t0 = time.perf_counter()
    seen, (gx, gstate, summary, _) = stream_kernels_of(
        lambda: drive(*trace, "cuda", blocked))
    counts = ops.launch_counts()
    routes = dict(STREAM_ROUTES)
    t_gpu = time.perf_counter() - t0
    print(f"  {kind} GPU: p50 {summary['p50_ms']:.3f} ms  p99 "
          f"{summary['p99_ms']:.3f} ms  {summary['rps']:.1f} req/s  "
          f"(phase {t_gpu:.1f} s)  launches {counts}; streaming passes by "
          f"route {routes}", flush=True)
    t0 = time.perf_counter()
    cx, cstate, csummary, _ = drive(*trace, "cpu", blocked)
    print(f"  {kind} CPU reference: p50 {csummary['p50_ms']:.1f} ms "
          f"(phase {time.perf_counter() - t0:.1f} s)", flush=True)
    worst = max(rel(gx[i], cx[i]) for i in range(REQUESTS))
    w_err = rel(gstate.W.cpu(), cstate.W)
    l_err = rel(gstate.L.cpu(), cstate.L)
    for x in gx.values():
        if x.shape != (M,) or not torch.isfinite(x).all():
            raise AssertionError(f"{kind}: response not finite (m,)")
    print(f"  {kind} parity vs CPU: worst response {worst:.3e}, W {w_err:.3e},"
          f" L {l_err:.3e} (gate {SERVE_GATE:g}); adapted "
          f"{gstate.stats.adapted} rows, {gstate.stats.refreshes} refreshes",
          flush=True)
    if not max(worst, w_err, l_err) < SERVE_GATE:
        raise AssertionError(f"{kind}: GPU trace disagrees with the CPU trace")
    if (gstate.slot, gstate.stats) != (cstate.slot, cstate.stats):
        raise AssertionError(f"{kind}: state counters differ from the CPU run")
    expect = ("fold_cols",) + (("sv_cross", "serve_apply", "trisolve")
                               if blocked else ("serve_solve",))
    missing = [k for k in expect if counts[k] == 0]
    if missing:
        raise AssertionError(f"{kind}: kernels never launched: {missing}")
    # the rule's choice for the serving window, and the kernels launched
    if routes["scalar"] or not routes["vector"]:
        raise AssertionError(f"{kind}: the rule did not send every streaming "
                             f"pass of the aligned window to 16-byte loads: "
                             f"{routes}")
    require_vector_streaming(f"{kind} serving", seen)
    return {"counts": counts, "worst": worst, "W": w_err, "L": l_err,
            "summary": summary, "responses": gx, "cpu": cx}


def observed_path(trace, dense: dict) -> dict:
    """The dense trace again, with a fold journal, a metrics registry, a
    health monitor (the audit every 4 maintenance passes), a tracer and a
    flight recorder attached. Its responses must be bit-identical to the
    unobserved run's; the journal replayed from the initial state on the
    card, in memory and through its npz, must land on the live state's
    full fingerprint; a serve-state checkpoint must restore bit for bit;
    and a forced incident bundle must replay on the card with every
    fingerprint verified and no bad event. Files go to a temporary
    directory, removed at the end."""
    tmp = tempfile.mkdtemp(prefix="observed_")
    try:
        reg = MetricsRegistry()
        mon = HealthMonitor(reg)
        tracer = Tracer()
        journal = FoldJournal()
        rec = FlightRecorder(os.path.join(tmp, "incidents"))
        hooks = {"adaptation": {"journal": journal, "audit_every": 4},
                 "server": {"registry": reg, "health": mon, "tracer": tracer,
                            "recorder": rec}}
        t0 = time.perf_counter()
        gx, live, summary, init = drive(*trace, "cuda", False, hooks=hooks)
        counts = ops.launch_counts()
        t_run = time.perf_counter() - t0
        snap = reg.snapshot()
        same = all(torch.equal(gx[i], dense["responses"][i])
                   for i in range(REQUESTS))
        worst = max(rel(gx[i], dense["responses"][i])
                    for i in range(REQUESTS))
        g = snap["gauges"]
        ds = dense["summary"]
        print(f"  observed GPU: p50 {summary['p50_ms']:.3f} ms  p99 "
              f"{summary['p99_ms']:.3f} ms  {summary['rps']:.1f} req/s "
              f"(unobserved: p50 {ds['p50_ms']:.3f} ms, p99 "
              f"{ds['p99_ms']:.3f} ms, {ds['rps']:.1f} req/s; phase "
              f"{t_run:.1f} s); responses bit-identical to the unobserved "
              f"run's: {same} (worst {worst:.3e}); verdict {mon.verdict()}; "
              f"{len(journal)} journal events; {live.stats.refreshes} "
              f"refreshes; audits: condest {g.get('curvature.condest')}, "
              f"residual {g.get('curvature.factor_residual')}; downdate "
              f"margin {g.get('curvature.downdate_margin')}; "
              f"{len(tracer.events())} spans; launches "
              + ", ".join(f"{k}={v}" for k, v in counts.items() if v),
              flush=True)
        if not same:
            raise AssertionError("observed serving: responses differ from "
                                 "the unobserved run's")
        if "curvature.condest" not in g or \
                snap["counters"]["serve.requests"] != REQUESTS:
            raise AssertionError(f"observed serving: the audit or the "
                                 f"request counters are missing: {snap}")
        if len(journal) != snap["counters"]["curvature.folds"] \
                + live.stats.refreshes:
            raise AssertionError("observed serving: the journal missed "
                                 "a fold or a refresh")
        t0 = time.perf_counter()
        live_fp = live.fingerprint()
        t_fp = time.perf_counter() - t0
        t0 = time.perf_counter()
        replayed = journal.replay(init, OnlineAdaptation())
        torch.cuda.synchronize()
        t_replay = time.perf_counter() - t0
        path = os.path.join(tmp, "journal.npz")
        journal.save(path)
        again = FoldJournal.load(path).replay(init, OnlineAdaptation())
        ok_mem, ok_npz = replayed.fingerprint() == live_fp, \
            again.fingerprint() == live_fp
        print(f"  journal replay of {len(journal)} events from the initial "
              f"state on the card: {t_replay:.3f} s; fingerprint(full=True) "
              f"equal to the live one: {ok_mem}, through the npz "
              f"({os.path.getsize(path)} B): {ok_npz} (one full "
              f"fingerprint {t_fp:.2f} s)", flush=True)
        if not (ok_mem and ok_npz):
            raise AssertionError("observed serving: the journal's replay "
                                 "is not bit-identical to the live state")
        del replayed, again
        t0 = time.perf_counter()
        save_serve_state(os.path.join(tmp, "ckpt"), 1, live)
        t_save = time.perf_counter() - t0
        back, meta = restore_serve_state(os.path.join(tmp, "ckpt"), 1, init)
        ok_ckpt = back.fingerprint() == live_fp and \
            (back.lam0, back.slot, back.age, back.stats) == \
            (live.lam0, live.slot, live.age, live.stats)
        print(f"  save_serve_state {t_save:.3f} s, restore_serve_state "
              f"bit for bit: {ok_ckpt} ({meta})", flush=True)
        if not ok_ckpt:
            raise AssertionError("observed serving: the checkpoint did not "
                                 "restore bit for bit")
        del back
        t0 = time.perf_counter()
        bundle = rec.capture("chip_smoke", force=True)
        t_cap = time.perf_counter() - t0
        t0 = time.perf_counter()
        pm = analyze(load_bundle(bundle, device="cuda"))
        t_an = time.perf_counter() - t0
        print(f"  incident bundle {os.path.getsize(bundle)} B in "
              f"{t_cap:.2f} s; analyzed on the card in {t_an:.2f} s: "
              f"{pm['events_replayed']} events (seq {pm['snap_seq']} -> "
              f"{pm['head_seq']}), fingerprints {pm['fingerprints_ok']}/"
              f"{pm['fingerprints_checked']} ok, bit-identical to the live "
              f"fingerprint: {pm['bit_identical']}, first bad event "
              f"{pm['first_bad']}", flush=True)
        if not (pm["bit_identical"] and pm["first_bad"] is None and
                pm["fingerprints_ok"] == pm["fingerprints_checked"]):
            raise AssertionError("observed serving: the incident bundle's "
                                 "replay diverged")
        return {"counts": counts, "summary": summary}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def profile(label: str, fn, prepare=None, calls=None) -> dict:
    """Run ``fn`` twice (after ``prepare``, outside the window): a warm-up,
    then once under torch.profiler. Prints the wall time, the device-busy
    share and the device time by kernel, and returns the latter; ``calls``,
    a dict, receives the launches by kernel name."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    for _ in range(2):
        if prepare is not None:
            prepare()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=act) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy = {e.key: e.self_device_time_total / 1e3 for e in events}
    if calls is not None:
        calls.update({e.key: e.count for e in events})
    if not busy:
        print(f"  {label}: {wall:.3f} ms wall; device time not measured "
              "(the profiler returned no device events)")
        return busy
    total = sum(busy.values())
    print(f"  {label}: {wall:.3f} ms wall, device busy {total:.3f} ms "
          f"({100 * total / wall:.1f} %)")
    for key, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:14]:
        print(f"    {ms:8.3f} ms  {key[:90]}")
    return busy


def profile_retaken(label: str, fn, seen, calls=None, tries: int = 3) -> dict:
    """``profile``, taken again (up to ``tries`` captures in all) while the
    capture shows device kernels but not what ``seen(busy, calls)`` looks
    for. Late in a full run the profiler has kept only the last kernel of a
    solve (0.13 of 4.2 ms), and a full run once failed its Gram check on
    path B, while the same calls profiled alone show every kernel: it can
    lose records, never invent them, so a capture is retaken only for what
    a lossy one would lack."""
    for i in range(tries):
        if calls is not None:
            calls.clear()
        busy = profile(label, fn, calls=calls)
        if not busy or seen(busy, calls):
            break
        if i + 1 < tries:
            print(f"  {label}: the profile lost kernels it looks for; "
                  "taking it again", flush=True)
    return busy


def profile_gram_path(label: str, fn, seen=None) -> dict:
    """``profile`` of path A or B (retaken while ``seen`` fails, where it is
    given), and the Gram ran on the wgmma kernel, never on the CUDA-core
    one. The gate is the Gram's route counts over the profiled calls
    (``gram.ROUTES``, counted where the wrapper launches the kernel of that
    route; the library launches the route it is given or fails), which
    hold every launch; the profiler's view must agree where it shows a
    Gram kernel."""
    before = dict(GRAM_ROUTES)
    busy = profile_retaken(
        label, fn, lambda b, c: "gram_tc_kernel" in " ".join(b)
        and (seen is None or seen(b, c)))
    ran = {k: GRAM_ROUTES[k] - before[k] for k in GRAM_ROUTES}
    if not ran["wgmma"] or ran["cuda_cores"]:
        raise AssertionError(f"{label}: the Gram did not run on the wgmma "
                             f"kernel alone: launches by route {ran}")
    names = " ".join(busy)
    if "gram_partial_kernel" in names:
        raise AssertionError(f"{label}: the profile shows the CUDA-core "
                             f"Gram kernel, the route counts {ran}")
    shown = ("the profile shows gram_tc_kernel" if "gram_tc_kernel" in names
             else "the profile kept no Gram kernel")
    print(f"  {label}: the Gram on gram_tc_kernel only (launches by route "
          f"{ran}; {shown})", flush=True)
    return busy


def require_wgmma_attention(label: str, busy: dict) -> None:
    """Where the profiler saw device kernels: attention ran on the wgmma
    kernel, never on the mma.sync one."""
    if not busy:
        return
    names = " ".join(busy)
    if "flash_wgmma_kernel" not in names or "flash_mma_kernel" in names:
        raise AssertionError(f"{label}: attention did not run on the wgmma "
                             "kernel alone")
    print(f"  {label}: attention on flash_wgmma_kernel only", flush=True)


def require_cluster_trisolve(label: str, busy: dict) -> None:
    """Where the profiler saw device kernels: the substitution ran on the
    cluster kernel (trisolve.cuh), not the previous one-block kernel."""
    if not busy:
        return
    if not any("tri::trisolve_kernel" in key for key in busy):
        raise AssertionError(f"{label}: no cluster substitution kernel in "
                             "the profile")
    print(f"  {label}: the substitution on tri::trisolve_kernel", flush=True)


def require_one_launch_a_sweep(label: str, busy: dict, calls: dict,
                               sweeps: int) -> None:
    """Where the profiler saw device kernels: one cholupdate_kernel launch
    a sweep (its scratch is one memset), and no transpose around it."""
    if not busy:
        return
    kernels = sum(n for key, n in calls.items() if "cholupdate_kernel" in key)
    if kernels != sweeps or any("transpose" in key for key in calls):
        raise AssertionError(f"{label}: {kernels} cholupdate_kernel launches "
                             f"for {sweeps} sweeps, or a transpose: {calls}")
    print(f"  {label}: {kernels} cholupdate_kernel launches for {sweeps} "
          "sweeps, no transpose", flush=True)


def require_vector_streaming(label: str, seen: dict) -> None:
    """``seen`` ({kernel: launches}, ``stream_kernels_of``) holds a
    streaming kernel, and only 16-byte-load ones (the window is
    aligned)."""
    if not seen or any(key.endswith("_scalar") for key in seen):
        raise AssertionError(f"{label}: streaming kernels launched {seen}, "
                             "not all on 16-byte loads")
    print(f"  {label}: streaming kernels launched {seen}", flush=True)


def profile_flush(trace, window_dtype=None) -> None:
    """One dense microbatch (8 requests with fold rows); the window stored
    in ``window_dtype`` where that is given. The flush must launch the
    streaming passes on their 16-byte-load kernels only."""
    S, vs, rows, lams = trace
    Sd = S.cuda()
    vs = [v.cuda() for v in vs[:PER_MB]]
    rows = [r.cuda() for r in rows[:PER_MB]]
    srv = SolveServer(init_serve_state(Sd, LAM0, window_dtype=window_dtype),
                      batcher=TokenBudgetBatcher(max_requests=PER_MB),
                      adaptation=OnlineAdaptation(refresh_every=10 ** 6),
                      monitor_drift=False)

    def submit():
        for v, r in zip(vs, rows):
            srv.submit(v, rows=r)

    kind = "" if window_dtype is None else f", {str(window_dtype)[6:]} window"
    label = f"flush of {PER_MB} requests + {PER_MB} folds{kind}"
    seen, _ = stream_kernels_of(lambda: profile(label, srv.flush, submit))
    require_vector_streaming(label, seen)


# ---------------------------------------------------------------------------
# 3b. Algorithm-1 kernel checks
# ---------------------------------------------------------------------------

def algorithm1_cases(S, v, w, B):
    """name → fn(mode) for the Algorithm-1 kernels on a window S, a v and a
    w; ``B`` is S in two blocks, so ``gram_acc`` runs after ``gram``."""
    def gram_sv(mode):
        # the kernel rounds v to the window's dtype: give the plain version
        # that rounded v (the CPU route of the reference does not round)
        W, u = ops.gram_sv(S, v if mode == "kernel" else v.to(S.dtype),
                           mode=mode)
        return torch.cat([W.reshape(-1), u])
    return {
        "gram": lambda mode: ops.gram(S, mode=mode),
        "gram_acc": lambda mode: ops.gram_blocks(B, mode=mode),
        "gram_sv": gram_sv,
        "ngd_apply": lambda mode: ops.ngd_apply(S, w, v.to(S.dtype), LAM0,
                                                mode=mode),
    }


def check_case(label, fn, tol) -> tuple[float, float]:
    """Kernel twice (bit-identical), plain once; returns the relative and
    the absolute error."""
    got, again = fn("kernel"), fn("kernel")
    plain = fn("ref")
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: repeat call not bit-identical")
    err = rel(got, plain)
    if not err < tol:
        raise AssertionError(f"{label}: rel err {err:.3e} >= {tol:g}")
    return err, float((got.double() - plain.double()).abs().max())


def gram_route(S) -> str:
    """The route ``tensor_core_route`` gives the Gram of window S."""
    n, m = S.shape
    tc = tensor_core_route(n, m, S.dtype,
                           S.storage_offset() * S.element_size())
    return "wgmma" if tc else "cuda_cores"


def check_gram_routes(label, windows, calls: int = 2) -> str:
    """The Gram's route counts since the last reset are those the rule
    gives: ``calls`` kernel launches on each window of ``windows`` (gram
    and gram_sv on S, gram_blocks on its two blocks). Returns the routes,
    named."""
    expect = dict.fromkeys(GRAM_ROUTES, 0)
    for S in windows:
        expect[gram_route(S)] += calls
    if GRAM_ROUTES != expect:
        raise AssertionError(f"{label}: Gram routes {GRAM_ROUTES}, the rule "
                             f"gives {expect}")
    kinds = [gram_route(S) for S in windows]
    return f"S {kinds[0]}, blocks {'/'.join(kinds[2:])}"


def require_tensor_core_gram(label: str, routes: dict) -> None:
    """Paths A and B run every Gram on the wgmma kernel."""
    if routes["wgmma"] == 0 or routes["cuda_cores"]:
        raise AssertionError(f"{label}: Gram launches by route {routes}; "
                             "the path must take the wgmma kernel only")
    print(f"  {label}: Gram launches by route {routes}", flush=True)


def spd(n, gen):
    A = torch.randn((n, n), generator=gen, device="cuda")
    return A @ A.T / n + torch.eye(n, device="cuda")


def algorithm1_checks() -> dict:
    """Sweep; returns {kernel: abs error at the main shape, fp32}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    main_err = {}
    for n, m in SWEEP_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            S = (torch.randn((n, m), generator=gen, device="cuda")
                 / m ** 0.5).to(dtype)
            v = torch.randn((m,), generator=gen, device="cuda")
            w = torch.randn((n,), generator=gen, device="cuda")
            B = BlockedScores.from_dense(S, (m // 2, m - m // 2))
            worst = {}
            ops.reset_launch_counts()
            for name, fn in algorithm1_cases(S, v, w, B).items():
                err, abs_err = check_case(f"{name} {n}x{m} {dtype}", fn,
                                          PASS_TOL)
                worst[name] = err
                if (n, m, dtype) == (N, M, torch.float32):
                    main_err[name] = abs_err
            routes = check_gram_routes(f"{n}x{m} {dtype}", [S, S, *B.blocks])
            print(f"  {n}x{m} {str(dtype)[6:]}: Gram routes {routes}; rel err "
                  + " ".join(f"{k}={e:.2e}" for k, e in worst.items()),
                  flush=True)
    errs = []
    for n in CHOL_N:
        W = spd(n, gen)
        fn = lambda mode: ops.cholesky(W, mode=mode)  # noqa: E731
        err, abs_err = check_case(f"cholesky n={n}", fn, PASS_TOL)
        if not torch.triu(fn("kernel"), 1).eq(0).all():
            raise AssertionError(f"cholesky n={n}: upper triangle not 0")
        errs.append(f"{n}: {err:.2e}")
        if n == N:
            main_err["cholesky"] = abs_err
    print("  cholesky (SPD W) rel err " + ", ".join(errs) + f" (gate "
          f"{PASS_TOL:g}); repeats bit-identical, upper triangle 0",
          flush=True)
    cholesky_launch_count(gen)
    return main_err


def cholesky_launch_count(gen, calls: int = 3) -> None:
    """torch.profiler over ``calls`` factorizations at each n of the sweep:
    one kernel launch per factorization (the memset that zeroes the grid
    barrier's counters aside), whatever n."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    seen = []
    for n in CHOL_N:
        W = spd(n, gen)
        ops.cholesky(W, mode="kernel")           # warm-up (the build, the load)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=act) as prof:
            for _ in range(calls):
                ops.cholesky(W, mode="kernel")
            torch.cuda.synchronize()
        kernels = {e.key: e.count for e in prof.key_averages()
                   if getattr(e, "device_type", None)
                   == torch.autograd.DeviceType.CUDA
                   and "memset" not in e.key.lower()}
        if sum(kernels.values()) != calls or not all(
                "cholesky_kernel" in key for key in kernels):
            raise AssertionError(f"cholesky n={n}: {calls} factorizations "
                                 f"launched {kernels}")
        seen.append(n)
    print(f"  cholesky: torch.profiler counts one kernel launch "
          f"(cholesky_kernel) per factorization at n = {seen}", flush=True)


def cholesky_timings(bw: float, flops: float) -> None:
    """Row 5 at path A's sizes: kernel, plain and torch.linalg.cholesky
    (cuSOLVER; the port never calls it as the kernel's route) on SPD W."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    for n in (256, N, 2048):
        W = spd(n, gen)
        time_cases({"cholesky": lambda mode: ops.cholesky(W, mode=mode)},
                   {"cholesky": lambda: torch.linalg.cholesky(W)},
                   lambda name: bound(name, n, 0, 1, 4, bw, flops, flops),
                   f"n={n}")


# ---------------------------------------------------------------------------
# 6. Algorithm 1 at the Table-1 shapes
# ---------------------------------------------------------------------------

def wall_ms(fn, reps: int = 3) -> float:
    """Best host wall time of ``fn`` over ``reps`` runs, each ended by a
    device sync."""
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def residual64(S, v, x, lam) -> float:
    """‖(SᵀS + λI)x − v‖ / ‖v‖ in float64, on the card."""
    S64, x64, v64 = S.double(), x.double(), v.double()
    r = S64.T @ (S64 @ x64) + lam * x64 - v64
    return float(r.norm() / v64.norm())


def solve_inputs(n, m, gen):
    S = torch.randn((n, m), generator=gen, device="cuda") / m ** 0.5
    return S, torch.randn((m,), generator=gen, device="cuda")


def algorithm1_path() -> dict:
    """``chol_solve_fused`` (and the gram / gram_acc routes) at every
    Table-1 shape, each against the plain ``chol_solve`` on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    inputs = [(n, m, *solve_inputs(n, m, gen)) for n, m in TABLE1]
    ops.reset_launch_counts()
    for n, m, S, v in inputs:
        cases = {"fused": lambda: ops.chol_solve_fused(S, v, LAM0),
                 "gram_fn": lambda: chol_solve(S, v, LAM0, gram_fn=ops.gram)}
        if n == N:
            B = BlockedScores.from_dense(S, WIDTHS)
            cases["fused blocked"] = lambda: ops.chol_solve_fused(B, v, LAM0)
            cases["gram_blocks"] = lambda: chol_factorize(
                B, LAM0, W=ops.gram_blocks(B)).solve(v)
        oracle = chol_solve(S, v, LAM0)
        plain_ms = wall_ms(lambda: chol_solve(S, v, LAM0))
        for kind, fn in cases.items():
            x = fn()
            ms = wall_ms(fn)
            if x.shape != (m,) or not torch.isfinite(x).all():
                raise AssertionError(f"{kind} {n}x{m}: not a finite (m,)")
            err = rel(x, oracle)
            print(f"  {n}x{m} {kind}: {ms:.3f} ms per solve (plain "
                  f"chol_solve {plain_ms:.3f} ms), rel err vs plain "
                  f"{err:.2e} (gate {SOLVE_GATE:g}), float64 residual "
                  f"{residual64(S, v, x, LAM0):.2e}", flush=True)
            if not err < SOLVE_GATE:
                raise AssertionError(f"{kind} {n}x{m}: {err:.3e} from the "
                                     "plain chol_solve")
    torch.cuda.synchronize()
    require_tensor_core_gram("Algorithm 1", GRAM_ROUTES)
    return ops.launch_counts()


# ---------------------------------------------------------------------------
# 7. the NGD trainer: examples/ngd_mlp_train.py --big
# ---------------------------------------------------------------------------

def mlp_problem():
    """Weights and data of ``examples/ngd_mlp_train.py --big``, drawn from
    numpy ``default_rng(0)`` in the same order."""
    rng = np.random.default_rng(0)
    d, h, n = MLP_D_IN, MLP_WIDTH, MLP_N
    arrays = {
        "w1": (rng.normal(size=(d, h)) / d ** 0.5).astype(np.float32),
        "b1": np.zeros((h,), np.float32),
        "w2": (rng.normal(size=(h, h)) / h ** 0.5).astype(np.float32),
        "b2": np.zeros((h,), np.float32),
        "w3": (rng.normal(size=(h, 1)) / h ** 0.5).astype(np.float32),
    }
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(3 * X[:, :1]).sum(-1) + 0.5 * np.cos(X[:, 1])).astype(np.float32)
    return arrays, X, y


def predict(p, x):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    h = torch.tanh(h @ p["w2"] + p["b2"])
    return (h @ p["w3"])[..., 0]


def sample_residual(p, ex):
    """Per-sample residual r_i: its Jacobian rows are the score rows, so
    the solve is the damped Gauss-Newton (Levenberg-Marquardt) step."""
    x, y = ex
    return predict(p, x[None])[0] - y


def mse(p, X, y):
    return torch.mean((predict(p, X) - y) ** 2)


def ngd_step(opt, state, p, X, y):
    S = per_sample_score_blocks(sample_residual, p, (X, y))
    g = torch.func.grad(lambda q: 0.5 * mse(q, X, y))(p)   # Jᵀr/n
    upd, state = opt.update(g, state, p, scores=S)
    return upd, state, S, g


def flat(tree) -> torch.Tensor:
    return torch.cat([tree[k].reshape(-1) for k in sorted(tree)])


def exact_update(S, g, lam) -> torch.Tensor:
    """−x of the step's system in float64 on the card (lr 1, no momentum):
    x = (v − Sᵀ(SSᵀ + λI)⁻¹Sv)/λ."""
    S64 = S.to_dense().cuda().double()
    v64 = flat(g).cuda().double()
    W = S64 @ S64.T + lam * torch.eye(S64.shape[0], dtype=torch.float64,
                                      device="cuda")
    return -(v64 - S64.T @ torch.linalg.solve(W, S64 @ v64)) / lam


def new_ngd(solver=ops.chol_solve_fused):
    return NaturalGradient(1.0, damping=LAM0, momentum=0.0, solver=solver)


def step_kernel_checks(S, g) -> None:
    """The step's kernels against their plain versions on its own inputs,
    where the composition's fp32 sensitivity does not enter: ``gram_sv``
    per score block, and the Cholesky of the damped Gram by its residual
    ‖LLᵀ − W‖/‖W‖ (its factor is as ill-conditioned as W)."""
    v_blocks = [g[k].reshape(-1) for k in sorted(g)]
    errs = []
    for b, vb in zip(S.blocks, v_blocks):
        errs.append(check_case(f"gram_sv {tuple(b.shape)}", lambda mode: torch.cat(
            [t.reshape(-1) for t in ops.gram_sv(b, vb, mode=mode)]), PASS_TOL)[0])
    W = ops.gram_blocks(S, mode="ref")
    W.diagonal().add_(LAM0)
    L = ops.cholesky(W, mode="kernel")
    chol_res = rel(L @ L.T, W)
    print(f"  step inputs: gram_sv vs plain per block "
          + " ".join(f"{e:.2e}" for e in errs) + f"; cholesky ‖LLᵀ − W‖ "
          f"{chol_res:.2e}, L vs plain {rel(L, ops.cholesky(W, mode='ref')):.2e}",
          flush=True)
    if not chol_res < PASS_TOL:
        raise AssertionError(f"cholesky on the step's Gram: {chol_res:.3e}")


def trainer_path() -> tuple[dict, tuple]:
    """NGD_STEPS steps on the card. Each step is held, on its own S and g,
    against the float64 step at the plain path's distance plus STEP_GATE;
    the same step from the same parameters on the CPU (plain versions) is
    printed beside it. Returns (launch counts, profiling inputs)."""
    arrays, X, y = mlp_problem()
    p = params_from_arrays(arrays)
    m = sum(t.numel() for t in p.values())
    Xd, yd = torch.from_numpy(X).cuda(), torch.from_numpy(y).cuda()
    Xc, yc = torch.from_numpy(X), torch.from_numpy(y)
    opt, plain_opt = new_ngd(), new_ngd("chol")
    st = opt.init(p)
    print(f"  MLP d_in {MLP_D_IN}, width {MLP_WIDTH}: m = {m:,} parameters, "
          f"n = {MLP_N} samples, λ = {LAM0:g}", flush=True)
    ngd_step(opt, st, p, Xd, yd)                  # warm-up, not applied
    counts = dict.fromkeys(ops.launch_counts(), 0)
    routes = dict.fromkeys(GRAM_ROUTES, 0)
    gpu_loss, cpu_loss = [float(mse(p, Xd, yd))], [float(mse(p, Xd, yd))]
    for k in range(NGD_STEPS):
        torch.cuda.synchronize()
        ops.reset_launch_counts()     # the step's launches, not the checks'
        t0 = time.perf_counter()
        upd, st_next, S, g = ngd_step(opt, st, p, Xd, yd)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        for key, n_launch in ops.launch_counts().items():
            counts[key] += n_launch
        for key, n_launch in GRAM_ROUTES.items():
            routes[key] += n_launch
        u_g = flat(upd)
        if u_g.shape != (m,) or not torch.isfinite(u_g).all():
            raise AssertionError(f"step {k}: update not a finite ({m},)")
        if k == 0:
            step_kernel_checks(S, g)
        u_p = flat(plain_opt.update(g, plain_opt.init(p), p, scores=S)[0])
        u64 = exact_update(S, g, LAM0)
        e_gp, e_g, e_p = rel(u_g, u_p), rel(u_g, u64), rel(u_p, u64)
        pc = {key: t.cpu() for key, t in p.items()}
        cpu_opt = new_ngd()
        upd_c, _, Sc, gc = ngd_step(cpu_opt, cpu_opt.init(pc), pc, Xc, yc)
        u_c = flat(upd_c)
        e_gc = rel(u_g.cpu(), u_c)
        e_c = rel(u_c, exact_update(Sc, gc, LAM0).cpu())
        p = {key: p[key] + upd[key] for key in p}
        st = st_next
        gpu_loss.append(float(mse(p, Xd, yd)))
        cpu_loss.append(float(mse({key: pc[key] + upd_c[key] for key in pc},
                                  Xc, yc)))
        print(f"  step {k}: {step_ms:.2f} ms on the card; update (max-abs "
              f"rel) vs the float64 step of its S and g: kernels {e_g:.2e}, "
              f"plain {e_p:.2e} (gate: kernels ≤ plain + {STEP_GATE:g}); "
              f"kernels vs plain {e_gp:.2e}; vs the CPU step {e_gc:.2e} "
              f"(the CPU's own distance to its float64 step {e_c:.2e})",
              flush=True)
        if not e_g <= e_p + STEP_GATE:
            raise AssertionError(f"step {k}: the kernel path is {e_g:.3e} "
                                 f"from the float64 step, the plain path "
                                 f"{e_p:.3e}")
    print("  loss, card: " + " ".join(f"{x:.4e}" for x in gpu_loss))
    print("  loss, CPU (each step from the card's parameters): "
          + " ".join(f"{x:.4e}" for x in cpu_loss))
    if not gpu_loss[-1] < 1e-2 * gpu_loss[0]:
        raise AssertionError("the NGD steps did not reduce the loss")
    require_tensor_core_gram("NGD trainer", routes)
    return counts, (opt, st, p, Xd, yd)


# ---------------------------------------------------------------------------
# 8. the rank-k update kernel
# ---------------------------------------------------------------------------

def cholupdate_inputs(n, k, sign, gen):
    """(L, X) with L = chol(W), W = A·Aᵀ + n·I (+ X·Xᵀ for a downdate, so
    that W − X·Xᵀ stays positive definite), as tests/test_kernels.py:52-60
    builds them."""
    A = torch.randn((n, n), generator=gen, device="cuda")
    X = torch.randn((n, k), generator=gen, device="cuda")
    W = A @ A.T + n * torch.eye(n, device="cuda")
    if sign < 0:
        W = W + X @ X.T
    return torch.linalg.cholesky(W).contiguous(), X


def recon_err(Lp, L, X, sign) -> float:
    """‖L′L′ᵀ − (LLᵀ ± XXᵀ)‖_F / ‖LLᵀ ± XXᵀ‖_F in float64."""
    L64, X64, P64 = L.double(), X.double(), Lp.double()
    return rel2(P64 @ P64.T, L64 @ L64.T + sign * (X64 @ X64.T))


def cholupdate_checks() -> dict:
    """The sweep; returns {"cholupdate": abs error at (N, k = 16), update}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    main_err = {}
    for n in CHOLUP_N:
        parts = []
        for k in CHOLUP_K:
            for sign in (1, -1):
                L, X = cholupdate_inputs(n, k, sign, gen)
                label = f"cholupdate n={n} k={k} sign={sign:+d}"

                def fn(mode, X=X):
                    return ops.cholupdate(L, X, sign=sign, mode=mode)
                err, abs_err = check_case(label, fn, CHOLUP_TOL)
                got = fn("kernel")
                zero = ops.cholupdate(L, torch.zeros_like(X), sign=sign)
                neg0 = fn("kernel", torch.cat([X, -torch.zeros_like(X[:, :1])],
                                              dim=1))
                torch.cuda.synchronize()
                if not torch.equal(torch.triu(got, 1).view(torch.int32),
                                   torch.zeros_like(got).view(torch.int32)):
                    raise AssertionError(f"{label}: upper triangle not 0")
                if not torch.equal(zero.view(torch.int32),
                                   torch.tril(L).view(torch.int32)):
                    raise AssertionError(f"{label}: zero X changed L")
                if not torch.equal(neg0.view(torch.int32),
                                   got.view(torch.int32)):
                    raise AssertionError(f"{label}: a -0.0 column changed L'")
                parts.append(f"k={k}{'+' if sign > 0 else '-'} {err:.1e}/"
                             f"{recon_err(got, L, X, sign):.1e}/"
                             f"{recon_err(fn('ref'), L, X, sign):.1e}")
                if (n, k, sign) == (N, 16, 1):
                    main_err["cholupdate"] = abs_err
        print(f"  n={n}: rel err vs plain / ‖L′L′ᵀ − (LLᵀ ± XXᵀ)‖ kernel / "
              "plain: " + ", ".join(parts), flush=True)
    print("  repeats bit-identical; zero X returns L bit for bit; a -0.0 "
          "column changes nothing; upper triangle exactly 0", flush=True)
    return main_err


# ---------------------------------------------------------------------------
# 9. the maintained factorization: sliding the Table-1 window
# ---------------------------------------------------------------------------

def slide(S_t, t, gen):
    """Replace SLIDE_K columns of the window S_t in place (the block
    ``benchmarks/amortized.py`` retires at step t); returns the columns
    (X_new, X_old) for one update + downdate."""
    lo = (t * SLIDE_K) % (S_t.shape[1] - SLIDE_K)
    X_old = S_t[:, lo:lo + SLIDE_K].clone()
    X_new = torch.randn((S_t.shape[0], SLIDE_K), generator=gen,
                        device="cuda") / S_t.shape[1] ** 0.5
    S_t[:, lo:lo + SLIDE_K] = X_new
    return X_new, X_old


def maintained_path() -> dict:
    """SLIDES slides of the window on the kernel, each held to the factor
    and the solve of the refactorized window; returns the launch counts
    of the slides."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    S_t, v = solve_inputs(N, M, gen)
    fac = chol_factorize(S_t, LAM0)
    counts = dict.fromkeys(ops.launch_counts(), 0)
    for t in range(SLIDES):
        X_new, X_old = slide(S_t, t, gen)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fac = fac.update(X_new, S_new=S_t).downdate(X_old, S_new=S_t)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for key, n_launch in ops.launch_counts().items():
            counts[key] += n_launch
        ref = chol_factorize(S_t, LAM0)
        l_err = float((fac.L.double() - ref.L.double()).abs().max())
        x, x_ref = fac.solve(v), ref.solve(v)
        if x.shape != (M,) or not torch.isfinite(x).all():
            raise AssertionError(f"slide {t}: solve not a finite (m,)")
        s_err = rel(x, x_ref)
        print(f"  slide {t}: {ms:.3f} ms (update + downdate, k = {SLIDE_K}); "
              f"L vs refactorized {l_err:.2e} max-abs (gate {FACTOR_GATE:g}),"
              f" solve vs plain chol_solve {s_err:.2e} (gate {SOLVE_GATE:g}),"
              f" float64 residual {residual64(S_t, v, x, LAM0):.2e} (plain "
              f"{residual64(S_t, v, x_ref, LAM0):.2e})", flush=True)
        if not l_err < FACTOR_GATE:
            raise AssertionError(f"slide {t}: factor drifted {l_err:.3e}")
        if not s_err < SOLVE_GATE:
            raise AssertionError(f"slide {t}: solve {s_err:.3e} from plain")
    return counts


# ---------------------------------------------------------------------------
# 10. the tenant factor view
# ---------------------------------------------------------------------------

def tenant_path() -> dict:
    """A rank-8 all-(+1) delta from two folds of 4 projected rows over the
    Table-1 window; ``tenant_factorization`` (kernel) and its solves are
    the path. Returns their launch counts."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    S, _ = solve_inputs(N, M, gen)
    state = init_serve_state(S, LAM0)
    delta = init_tenant_delta(N, TENANT_RANK, device="cuda")
    for _ in range(TENANT_RANK // TENANT_ROWS):
        rows = torch.randn((TENANT_ROWS, M), generator=gen,
                           device="cuda") / M ** 0.5
        delta, _ = delta_fold(delta, project_rows(state, rows))
    vs = [torch.randn((M,), generator=gen, device="cuda")
          for _ in range(TENANT_SOLVES)]
    tenant_factorization(state, delta)   # warm-up: the host eigh's first call
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fac = tenant_factorization(state, delta)
    torch.cuda.synchronize()
    view_ms = (time.perf_counter() - t0) * 1e3
    xs = [fac.solve(v) for v in vs]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    composed = delta_factor(delta, state.L, state.lam0)
    lt_err = rel(fac.L, composed)
    oracle = chol_factorize(augmented_window(state, delta), LAM0)
    worst = max(rel2(x, oracle.solve(v)) for x, v in zip(xs, vs))
    for x in xs:
        if x.shape != (M,) or not torch.isfinite(x).all():
            raise AssertionError("tenant solve not a finite (m,)")
    empty = tenant_factorization(
        state, init_tenant_delta(N, TENANT_RANK, device="cuda"))
    torch.cuda.synchronize()
    bitwise = torch.equal(empty.L.view(torch.int32),
                          state.L.view(torch.int32))
    print(f"  tenant view: {view_ms:.3f} ms (correction + update + "
          f"downdate); L_t vs delta_factor (composed) {lt_err:.2e} (gate "
          f"{CHOLUP_TOL:g}); {TENANT_SOLVES} solves vs the private-window "
          f"oracle worst {worst:.2e} (gate {TENANT_GATE:g}); empty delta "
          f"gives L bit for bit: {bitwise}", flush=True)
    if not lt_err < CHOLUP_TOL:
        raise AssertionError(f"tenant L_t {lt_err:.3e} from delta_factor")
    if not worst < TENANT_GATE:
        raise AssertionError(f"tenant solves {worst:.3e} from the oracle")
    if not bitwise:
        raise AssertionError("an empty delta changed the base factor")
    return counts


# ---------------------------------------------------------------------------
# 10a. tenant serving: SolveServer(tenants=) over the dense trace
# ---------------------------------------------------------------------------

def tenant_ids() -> list:
    """A zipf(1.5) tenant id a request of the trace, modulo TENANTS
    (``benchmarks/serve_tenants.py``'s traffic: a few hot tenants, a long
    cold tail)."""
    rng = np.random.default_rng(SEED)
    return [f"t{(int(rng.zipf(TENANT_ZIPF)) - 1) % TENANTS}"
            for _ in range(REQUESTS)]


def tenant_drive(S, vs, rows, lams, tids, device, budget, spill_dir,
                 registry=None):
    """Serve the dense trace with a tenant a request; returns (responses,
    the delta each request was solved against, the server, the initial
    state, the tenants activated from a spill in order). Each request's
    rows fold into its tenant's delta; a warm-up on a throwaway manager
    first (the host eigh's first call)."""
    dev = torch.device(device)
    state = init_serve_state(S.to(dev), LAM0, device=device)
    vs = [v.to(dev) for v in vs]
    rows = [r.to(dev) for r in rows]

    def server(mgr, registry=None):
        return SolveServer(state,
                           batcher=TokenBudgetBatcher(max_requests=PER_MB),
                           adaptation=OnlineAdaptation(refresh_every=4),
                           monitor_drift=False, fused=True, tenants=mgr,
                           registry=registry)

    warm = server(TenantManager(TENANT_RANK, spill_dir=os.path.join(
        spill_dir, "warm")))
    for i in range(2):
        warm.submit(vs[i], tenant="warm", rows=rows[i])
        warm.flush()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ops.reset_launch_counts()       # count the measured trace only

    mgr = TenantManager(TENANT_RANK, budget_bytes=budget,
                        spill_dir=os.path.join(spill_dir, str(budget)))
    srv = server(mgr, registry)
    deltas, serve = {}, srv._serve
    activated, activate = [], mgr._activate

    def spied(t, dev):
        if not t.resident:
            activated.append(t.tid)
        return activate(t, dev)
    mgr._activate = spied

    def kept(mb):
        out = serve(mb)
        d = mgr._tenants[mb.tenant].delta    # resident: it just solved
        for res in out:
            deltas[res.uid] = d._replace(cols=d.cols.clone(),
                                         signs=d.signs.clone())
        return out
    srv._serve = kept
    out, index = {}, {}
    for b in range(0, REQUESTS, PER_MB):
        for i in range(b, b + PER_MB):
            index[srv.submit(vs[i], damping=lams[i], rows=rows[i],
                             tenant=tids[i])] = i
        for res in srv.flush():
            out[index[res.uid]] = res.x.float().cpu()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    srv._serve, mgr._activate = serve, activate
    return out, {index[u]: d for u, d in deltas.items()}, srv, state, \
        activated


def tenant_serving_path(trace) -> dict:
    """The dense trace with zipf tenant ids through ``SolveServer(
    tenants=TenantManager(rank 8))`` on the card under a byte budget that
    evicts. Gates: every response within TENANT_GATE of the private-window
    oracle (``augmented_window`` + ``chol_factorize``) for the delta as it
    stood at that solve, the hottest tenants and those spilled and
    activated again among them; the same trace without a budget bit for
    bit; the same trace on the CPU within TENANT_GATE; the shared W and L
    unchanged bit for bit; ``serve_solve`` launched, evictions and
    activations > 0. Spills go to a temporary directory, removed after."""
    S, vs, rows, lams = trace
    tids = tenant_ids()
    tmp = tempfile.mkdtemp(prefix="tenant_spill_")
    try:
        reg = MetricsRegistry()
        t0 = time.perf_counter()
        gx, gdeltas, srv, init, activated = tenant_drive(
            S, vs, rows, lams, tids, "cuda", TENANT_BUDGET, tmp, reg)
        counts = ops.launch_counts()
        t_gpu = time.perf_counter() - t0
        summary, mgr = srv.metrics.summary(), srv.tenants
        p = mgr.packing_stats()
        hist = reg.snapshot()["histograms"]

        def mean_ms(name):
            h = hist.get(name, {"count": 0})
            return h["sum"] / h["count"] * 1e3 if h["count"] else float("nan")
        activated = sorted(set(activated))
        print(f"  tenant GPU: p50 {summary['p50_ms']:.3f} ms  p99 "
              f"{summary['p99_ms']:.3f} ms  {summary['rps']:.1f} req/s "
              f"(phase {t_gpu:.1f} s); {p['tenants']} tenants, "
              f"{srv.state.stats.microbatches} microbatches; evictions "
              f"{p['evictions']} ({mean_ms('tenants.evict_latency_s'):.3f} ms"
              f" mean), activations {p['activations']} "
              f"({mean_ms('tenants.activate_latency_s'):.3f} ms mean), "
              f"factor builds {p['materializations']}, hits "
              f"{p['factor_hits']}; resident {p['resident']} "
              f"({p['resident_bytes']} B of a {TENANT_BUDGET} B budget); "
              f"hot {p['hot']}; spilled and activated again: {activated}; "
              f"launches " + ", ".join(f"{k}={v}" for k, v in counts.items()
                                      if v), flush=True)
        if not (srv.state.W is init.W or torch.equal(srv.state.W, init.W)) \
                or not torch.equal(srv.state.L, init.L) or \
                srv.state.stats.adapted != 0:
            raise AssertionError("tenant serving: the shared window changed")
        require_launches("tenant serving", counts, "serve_solve")
        if not (p["evictions"] > 0 and p["activations"] > 0
                and len(activated) >= 2):
            raise AssertionError(f"tenant serving: the budget evicted or "
                                 f"activated too little: {p}")
        # the private-window oracle, per request, for its delta at its solve
        worst, by_tenant = 0.0, {}
        for i in range(REQUESTS):
            d = gdeltas[i]
            lam = LAM0 if lams[i] is None else lams[i]
            oracle = chol_factorize(augmented_window(init, d), lam).solve(
                vs[i].cuda()).float().cpu()
            err = rel2(gx[i], oracle)
            by_tenant[tids[i]] = max(by_tenant.get(tids[i], 0.0), err)
            worst = max(worst, err)
            if gx[i].shape != (M,) or not torch.isfinite(gx[i]).all():
                raise AssertionError("tenant serving: response not a finite "
                                     "(m,)")
        hot = sorted(p["hot"], key=lambda t: -p["hot"][t])[:2]
        t0 = time.perf_counter()
        ux, _, usrv, _, _ = tenant_drive(S, vs, rows, lams, tids, "cuda", None,
                                      tmp)
        same = all(torch.equal(gx[i], ux[i]) for i in range(REQUESTS))
        t_unb = time.perf_counter() - t0
        t0 = time.perf_counter()
        cx, _, csrv, _, _ = tenant_drive(S, vs, rows, lams, tids, "cpu",
                                      TENANT_BUDGET, tmp)
        cpu_worst = max(rel(gx[i], cx[i]) for i in range(REQUESTS))
        t_cpu = time.perf_counter() - t0
        print(f"  vs the private-window oracle: worst {worst:.2e} (gate "
              f"{TENANT_GATE:g}); hottest "
              + ", ".join(f"{t} {by_tenant[t]:.2e}" for t in hot)
              + "; spilled and activated again "
              + ", ".join(f"{t} {by_tenant[t]:.2e}" for t in activated)
              + f"; without a budget ({usrv.tenants.stats.evictions} "
              f"evictions, {t_unb:.1f} s) bit for bit: {same}; the CPU "
              f"({csrv.tenants.stats.evictions} evictions, {t_cpu:.1f} s) "
              f"worst {cpu_worst:.2e} (gate {TENANT_GATE:g})", flush=True)
        if not worst < TENANT_GATE or not same or \
                not cpu_worst < TENANT_GATE:
            raise AssertionError("tenant serving: responses disagree with "
                                 "the oracle, the unbudgeted run or the CPU")
        if csrv.tenants.packing_stats() != p:
            raise AssertionError("tenant serving: the CPU's residency "
                                 "differs from the card's")
        return {"counts": counts, "summary": summary, "packing": p}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# 10b. the sharded serving tier: AsyncSolveServer on a 4-position mesh
# ---------------------------------------------------------------------------

def shard_mesh(layout: str, device="cuda"):
    """The trace's mesh: 4 positions laid on one device, (4,) ("model",)
    or, for 2d, (2, 2) ("data", "model")."""
    if layout == "2d":
        return make_mesh((2, 2), ("data", "model"),
                         devices=[device] * SHARD_POSITIONS)
    return make_mesh((SHARD_POSITIONS,), ("model",),
                     devices=[device] * SHARD_POSITIONS)


def pad_trace(trace):
    """The dense trace at m = PAD_M: PAD_M − M more columns of zeros in the
    window, v and rows. m is not a multiple of the mesh, so the window is
    zero-padded and every slab boundary moves off the even split of M;
    the system is the dense trace's with those columns' x = 0, so its
    eager and CPU responses are phase 4's with PAD_M − M zeros."""
    S, vs, rows, lams = trace
    extra = PAD_M - M
    S = torch.cat([S, S.new_zeros((N, extra))], 1)
    vs = [torch.cat([v, v.new_zeros((extra,))]) for v in vs]
    rows = [torch.cat([r, r.new_zeros((ROWS_PER_REQ, extra))], 1)
            for r in rows]
    return S, vs, rows, lams


def drive_async(S, vs, rows, lams, device, layout=None, window_dtype=None,
                sleep_seed=None):
    """The trace through ``AsyncSolveServer``: replicated (``layout``
    None) or sharded over ``shard_mesh(layout)``; a warm-up on a throwaway
    server first, as ``drive``. ``sleep_seed``: the submitting thread
    sleeps 0, 0.5 or 2 ms at random before each call. Returns (responses,
    the final sharded or plain state, the metrics summary, launches)."""
    dev = torch.device(device)
    Sd = S.to(dev)
    blocked = layout == "blocked"
    Sd = BlockedScores.from_dense(Sd, WIDTHS) if blocked else Sd
    if layout is None:
        state = init_serve_state(Sd, LAM0, device=device,
                                 window_dtype=window_dtype)
    else:
        state = init_sharded_serve_state(
            Sd, LAM0, spec=DistSpec(shard_mesh(layout, device), layout),
            device=device, window_dtype=window_dtype)
    del Sd
    vs = [split(v.to(dev), blocked) for v in vs]
    rows = [split(r.to(dev), blocked) for r in rows]
    rng = random.Random(sleep_seed)

    def pause():
        if sleep_seed is not None:
            time.sleep(rng.choice((0.0, 0.0, 0.0005, 0.002)))

    def server(st):
        return AsyncSolveServer(
            st, batcher=TokenBudgetBatcher(max_requests=PER_MB),
            adaptation=OnlineAdaptation(refresh_every=4),
            monitor_drift=False, fused=True)

    with server(state) as warm:
        for i in range(PER_MB):
            warm.submit(vs[i], rows=rows[i])
        warm.flush(timeout=600)
        for i in range(PER_MB):
            warm.submit(vs[i], damping=lams[MIXED_MB * PER_MB + i],
                        rows=rows[i])
        warm.flush(timeout=600)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ops.reset_launch_counts()       # count the measured trace only
    out = {}
    with server(state) as srv:
        for b in range(0, REQUESTS, PER_MB):
            uids = {}
            for i in range(b, b + PER_MB):
                pause()
                uids[srv.submit(vs[i], damping=lams[i], rows=rows[i])] = i
            pause()
            for res in srv.flush(timeout=600):
                x = torch.cat(res.x) if blocked else res.x
                out[uids[res.uid]] = x.float().cpu()
        final = srv.sharded_state() if layout is not None else srv.state
        summary = srv.metrics.summary()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, final, summary, ops.launch_counts()


def expected_shard_launches(final) -> dict:
    """The launches a sharded trace implies: each microbatch one
    ``sv_cross`` and one ``serve_apply`` a piece (a piece: one block's
    slab at one data row), each uniform microbatch one substitution, each
    fold one ``fold_cols`` a piece, each refresh a Gram a column slab of
    each block (``gram`` on a slab's first block, ``gram_acc`` on the
    others) and one Cholesky."""
    S = final.state.S
    pieces = sum(1 for _ in S.slab_pieces())
    slabs, blocks = SHARD_POSITIONS // S.spec.n_mult, len(S.pieces)
    st = final.stats
    mbs, refreshes = st.microbatches, st.refreshes
    folds = st.adapted // ROWS_PER_REQ
    return {"sv_cross": mbs * pieces, "serve_apply": mbs * pieces,
            "trisolve": mbs - 1, "fold_cols": folds * pieces,
            "gram": refreshes * slabs, "gram_acc": refreshes * slabs *
            (blocks - 1), "cholesky": refreshes, "serve_solve": 0}


def sharded_serving_path(trace, dense: dict) -> dict:
    """The dense trace through ``AsyncSolveServer``: replicated, then on a
    4-position mesh on the card in the 1d, 2d and blocked layouts, with a
    bf16 window (1d) and at m = PAD_M (1d, zero-padded). Gates: the
    replicated responses bit for bit the eager server's (phase 4); every
    sharded layout within SERVE_GATE of the eager server's responses on
    the card and of the same trace on the CPU (phase 4's runs, at PAD_M
    with zeros appended; for bf16 eager runs of its own); a second 1d run
    and one whose submitting thread sleeps at seeded random points bit
    for bit the first; each kernel launched as often as the pieces
    imply."""
    counts_all = {}

    def padded(xs):
        return {i: torch.cat([x, x.new_zeros(PAD_M - M)])
                for i, x in xs.items()}
    eager = {"fp32": (dense["responses"], dense["cpu"], dense["summary"]),
             "pad": (padded(dense["responses"]), padded(dense["cpu"]),
                     dense["summary"])}
    t0 = time.perf_counter()
    ptrace = pad_trace(trace)
    gx, _, summary, _ = drive(*trace, "cuda", False,
                              window_dtype=torch.bfloat16)
    cx, _, _, _ = drive(*trace, "cpu", False, window_dtype=torch.bfloat16)
    eager["bf16"] = (gx, cx, summary)
    print(f"  eager references, bf16 window, on the card and the CPU: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cases = (("replicated", None, "fp32", trace, None),
             ("1d", "1d", "fp32", trace, None),
             ("2d", "2d", "fp32", trace, None),
             ("blocked", "blocked", "fp32", trace, None),
             ("1d, bf16 window", "1d", "bf16", trace, torch.bfloat16),
             (f"1d, m = {PAD_M:,}", "1d", "pad", ptrace, None))
    first_1d = None
    for label, layout, ref_key, tr, wd in cases:
        t0 = time.perf_counter()
        gx, final, summary, counts = drive_async(*tr, "cuda", layout, wd)
        wall = time.perf_counter() - t0
        ex, cx, esum = eager[ref_key]
        m = tr[0].shape[1]
        for x in gx.values():
            if x.shape != (m,) or not torch.isfinite(x).all():
                raise AssertionError(f"sharded {label}: response not a "
                                     f"finite ({m},)")
        if len(gx) != REQUESTS:
            raise AssertionError(f"sharded {label}: {len(gx)} responses")
        vs_eager = max(rel(gx[i], ex[i]) for i in range(REQUESTS))
        vs_cpu = max(rel(gx[i], cx[i]) for i in range(REQUESTS))
        line = (f"  {label}: p50 {summary['p50_ms']:.3f} ms, p99 "
                f"{summary['p99_ms']:.3f} ms, {summary['rps']:.1f} req/s "
                f"(eager: p50 {esum['p50_ms']:.3f} ms, p99 "
                f"{esum['p99_ms']:.3f} ms, {esum['rps']:.1f} req/s); "
                f"vs eager {vs_eager:.2e}, vs the CPU {vs_cpu:.2e} (gate "
                f"{SERVE_GATE:g}); {wall:.1f} s; launches "
                + ", ".join(f"{k}={v}" for k, v in counts.items() if v))
        if layout is None:
            same = all(torch.equal(gx[i], ex[i]) for i in range(REQUESTS))
            print(line + f"; bit for bit the eager server's: {same}",
                  flush=True)
            if not same:
                raise AssertionError("replicated async responses differ "
                                     "from the eager server's")
            if not vs_cpu < SERVE_GATE:
                raise AssertionError("replicated async: CPU disagrees")
            counts_all[label] = counts
            continue
        want = expected_shard_launches(final)
        got = {k: counts[k] for k in want}
        print(line + f"; per-piece launches {got} (expected {want})",
              flush=True)
        if got != want:
            raise AssertionError(f"sharded {label}: launches {got}, the "
                                 f"pieces imply {want}")
        if not max(vs_eager, vs_cpu) < SERVE_GATE:
            raise AssertionError(f"sharded {label}: {vs_eager:.3e} from "
                                 f"eager, {vs_cpu:.3e} from the CPU")
        if final.state.stats.served != REQUESTS:
            raise AssertionError(f"sharded {label}: served "
                                 f"{final.state.stats.served}")
        counts_all[label] = counts
        if label == "1d":
            first_1d = (gx, final.fingerprint())
    for label, seed in (("1d, again", None),
                        ("1d, seeded sleeps before each call", SEED + 12)):
        t0 = time.perf_counter()
        gx, final, summary, counts = drive_async(*trace, "cuda", "1d",
                                                 sleep_seed=seed)
        same = all(torch.equal(gx[i], first_1d[0][i])
                   for i in range(REQUESTS))
        fp_same = final.fingerprint() == first_1d[1]
        print(f"  {label}: p50 {summary['p50_ms']:.3f} ms, p99 "
              f"{summary['p99_ms']:.3f} ms, {summary['rps']:.1f} req/s; "
              f"{time.perf_counter() - t0:.1f} s; responses bit for bit the "
              f"first run's: {same}; final window, W and L: {fp_same}",
              flush=True)
        if not (same and fp_same):
            raise AssertionError(f"sharded {label}: not bit-identical")
        counts_all[label] = counts
    return counts_all


def sharded_algorithm1_path() -> dict:
    """``sharded_chol_solve`` (1d) and ``sharded_chol_solve_2d`` at (N, M)
    over 4 positions on the card against the plain ``chol_solve``; the
    rank-k update with its columns sharded, both methods, at n = N, k =
    16, against the replicated ``ops.cholupdate``. Each call's launches
    are held to what its slabs imply."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    S, v = solve_inputs(N, M, gen)
    oracle = chol_solve(S, v, LAM0)
    plain_ms = wall_ms(lambda: chol_solve(S, v, LAM0))
    total = {}

    def counted(label, fn, want):
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"{label}: launches {got}, its slabs imply "
                                 f"{want}")
        add_counts(total, counts)
        return out, got

    for label, fn, slabs in (
            ("1d", lambda: sharded_chol_solve(S, v, LAM0,
                                              mesh=shard_mesh("1d")), 4),
            ("2d", lambda: sharded_chol_solve_2d(S, v, LAM0,
                                                 mesh=shard_mesh("2d")), 2)):
        x, got = counted(f"sharded solve {label}", fn,
                         {"gram_sv": slabs, "ngd_apply": slabs,
                          "cholesky": 1, "trisolve": 1})
        ms = wall_ms(fn)
        if x.shape != (M,) or not torch.isfinite(x).all():
            raise AssertionError(f"sharded solve {label}: not a finite (m,)")
        err = rel(x, oracle)
        print(f"  sharded chol_solve {label} at {N}x{M}, 4 positions: "
              f"{ms:.3f} ms per solve (plain chol_solve {plain_ms:.3f} ms); "
              f"rel err vs plain {err:.2e} (gate {SOLVE_GATE:g}); launches a "
              f"solve {got}", flush=True)
        if not err < SOLVE_GATE:
            raise AssertionError(f"sharded solve {label}: {err:.3e}")
    for sign in (1, -1):
        L, X = cholupdate_inputs(N, SLIDE_K, sign, gen)
        want = ops.cholupdate(L, X, sign=sign)
        fn = sharded_chol_update if sign > 0 else sharded_chol_downdate
        what = "update" if sign > 0 else "downdate"
        for method, expect in (("composed", {"cholesky": 1,
                                             "cholupdate": 0}),
                               ("rotations", {"cholesky": 0,
                                              "cholupdate": SHARD_POSITIONS})):
            got, counts = counted(
                f"sharded rank-k {method}",
                lambda: fn(L, X, mesh=shard_mesh("1d"), method=method),
                expect)
            again = fn(L, X, mesh=shard_mesh("1d"), method=method)
            err = rel(got, want)
            print(f"  sharded rank-{SLIDE_K} {what} at n = {N}, "
                  f"{method}: rel err vs the replicated cholupdate "
                  f"{err:.2e} (gate {CHOLUP_TOL:g}), ‖L′L′ᵀ − (LLᵀ ± XXᵀ)‖ "
                  f"{recon_err(got, L, X, sign):.1e}, repeat bit-identical "
                  f"{torch.equal(got, again)}; launches {counts}",
                  flush=True)
            if not err < CHOLUP_TOL or not torch.equal(got, again):
                raise AssertionError(f"sharded rank-k {method} {sign:+d}: "
                                     f"{err:.3e}")
    return total


# ---------------------------------------------------------------------------
# 10d. the fleet: two worker processes on the card behind a Dispatcher
# ---------------------------------------------------------------------------

# Fleet workers count their launches in their own processes, out of reach of
# this process's counters: each worker's torch.profiler trace (the init
# frame's ``profile_dir``) is read instead, one kernel name a wrapper. On
# each run's path each named kernel is launched by exactly one wrapper,
# once a call. (a), replicated eager workers: the substitution only inside
# ``serve_solve`` (the mixed-λ solves run ``solve_batch``, plain PyTorch),
# the fixed-order partial sum only by ``fold_cols`` (``serve_solve``'s
# substitution reads the partials itself). (b), workers whose window is
# sharded 1d over their own mesh: the age refreshes are the sharded
# refresh, one Gram kernel a ``gram`` (its route's) and one
# ``cholesky_kernel`` a factorization (the replicated refresh and the
# seeding factorization are plain PyTorch, as the reference's), and the
# solves run ``trisolve`` and a ``serve_apply`` a piece apart.
FLEET_KERNELS = {
    "a": {"serve_solve": ("trisolve_kernel",),
          "fold_cols": ("reduce_partials_kernel",)},
    "b": {"gram": ("gram_tc_kernel", "gram_partial_kernel"),
          "cholesky": ("cholesky_kernel",), "trisolve": ("trisolve_kernel",),
          "serve_apply": ("serve_apply_kernel",)}}
FLEET_WORKERS = 2
# probes after reconcile: the workers' age refreshes are local decisions
# (refreshes are not gossiped), so they refreshed at different windows; a
# probe is a microbatch, and after REFRESH_EVERY of them each has refreshed
# at the one reconciled window
FLEET_SETTLE = 4
FLEET_REFRESH = 4                  # phase 4's refresh_every


def fleet_meta(**extra) -> dict:
    """The init frame's meta of phase 4's server: microbatches of PER_MB,
    a refresh every 4, drift monitoring off (the fused ``serve_solve``)."""
    return {"mode": "inline", "damping": LAM0, "max_requests": PER_MB,
            "refresh_every": FLEET_REFRESH, "drift_frac": 0.25,
            "monitor_drift": False, **extra}


def fold_at_admission(S, vs, rows, lams, window_dtype=None,
                      device="cuda") -> dict:
    """Phase 4's server on ``device`` fed the trace with each request's
    rows folded before its solve: the order the fleet's gossip gives."""
    srv = SolveServer(init_serve_state(S.to(device), LAM0, device=device,
                                       window_dtype=window_dtype),
                      batcher=TokenBudgetBatcher(max_requests=PER_MB),
                      adaptation=OnlineAdaptation(
                          refresh_every=FLEET_REFRESH),
                      monitor_drift=False, fused=True)
    out, sub = {}, {}
    for i in range(len(vs)):
        for r in srv.flush():
            out[sub[r.uid]] = r.x.float().cpu()
        srv.apply_fold(rows[i].to(device))
        sub[srv.submit(vs[i].to(device), damping=lams[i])] = i
    for r in srv.flush():
        out[sub[r.uid]] = r.x.float().cpu()
    return out


def trace_kernels(profile_dir: str, names: dict) -> tuple:
    """Launches by wrapper (``names``: wrapper → kernel names) in every
    worker's trace, and per worker (device busy ms in kernels, in copies,
    the trace's span ms)."""
    counts = dict.fromkeys(KERNELS, 0)
    files = sorted(Path(profile_dir).glob("worker*/trace_*.json"))
    if len(files) != FLEET_WORKERS:
        raise AssertionError(f"fleet: {len(files)} worker profile traces in "
                             f"{profile_dir}, expected {FLEET_WORKERS}")
    busy = []
    for f in files:
        events = json.loads(f.read_text())["traceEvents"]
        kern = copy = 0.0
        stamps = [ev["ts"] for ev in events if "ts" in ev and "dur" in ev]
        for ev in events:
            if ev.get("cat") == "gpu_memcpy":
                copy += ev.get("dur", 0.0)
            if ev.get("cat") != "kernel":
                continue
            kern += ev.get("dur", 0.0)
            for kname, kernels in names.items():
                if any(k in ev.get("name", "") for k in kernels):
                    counts[kname] += 1
        span = max(float(ev["ts"]) + float(ev["dur"]) for ev in events
                   if "ts" in ev and "dur" in ev) - float(min(stamps))
        busy.append((kern / 1e3, copy / 1e3, span / 1e3))
    return counts, busy


def settled_probe(disp, v, label: str) -> float:
    """Reconcile, probe, drive every worker past its age bound at the
    reconciled window, and gate the last probe bit for bit. Returns the
    first probe's relative spread (before the settling refreshes)."""
    disp.reconcile(timeout=300)
    first = list(disp.probe(v, timeout=300).values())
    for _ in range(FLEET_SETTLE - 1):
        disp.probe(v, timeout=300)
    xs = list(disp.probe(v, timeout=300).values())
    if len(xs) != FLEET_WORKERS or not all(
            np.array_equal(xs[0], x) for x in xs[1:]):
        raise AssertionError(f"fleet {label}: reconciled probes differ")
    return max(float(np.linalg.norm(a - first[0])
                     / np.linalg.norm(first[0])) for a in first[1:])


def fleet_gossip_run(disp, trace, window_dtype=None, layout=None) -> dict:
    """(a)/(b): phase 4's trace through ``disp``'s two CUDA workers, round
    robin, gossip on (``fleet_specs``). Every response against the eager fold-at-admission server
    on the card; the settled probe bit for bit; the checkpoint's manifest;
    the gossip journal replayed on the card onto the workers' initial
    state (``init_serve_state(S0)``, or with ``layout`` the async server's
    sharded state over the worker's mesh and the sharded adaptation) and
    refreshed once (each worker's last maintenance was a refresh at the
    reconciled window) equal to every worker's checkpointed S, W, L and
    slot bit for bit. A bf16 window crosses the wire as ``|V2`` records
    (S0 and the rows are sent as bf16 tensors)."""
    S, vs, rows, lams = trace
    label = ("bf16" if window_dtype is not None else "fp32") \
        + (f", {layout} async workers" if layout else "")
    if window_dtype is not None:
        S = S.to(window_dtype)
        rows = [r.to(window_dtype) for r in rows]
    ref = fold_at_admission(S, vs, rows, lams, window_dtype)
    tmp = tempfile.mkdtemp(prefix="fleet_")
    try:
        t0 = time.perf_counter()
        with disp:
            got = {}
            for b in range(0, REQUESTS, PER_MB):     # phase 4's flushes
                sub = {disp.submit(vs[i], damping=lams[i], rows=rows[i]): i
                       for i in range(b, b + PER_MB)}
                got.update({sub[r.uid]: torch.from_numpy(r.x)
                            for r in disp.flush(timeout=300)})
            summary = disp.metrics.summary()
            spread = settled_probe(disp, vs[0], label)
            manifest_path = disp.checkpoint(tmp, 1, timeout=300)
            head = disp.log.head
        t_all = time.perf_counter() - t0
        manifest = json.loads(Path(manifest_path).read_text())
        if sorted(got) != list(range(REQUESTS)) or any(
                x.shape != (M,) or not torch.isfinite(x).all()
                for x in got.values()):
            raise AssertionError(f"fleet {label}: responses missing or not "
                                 f"finite (m,)")
        worst = max(rel(got[i], ref[i]) for i in range(REQUESTS))
        if not worst < SERVE_GATE:
            raise AssertionError(f"fleet {label}: responses {worst:.3e} from "
                                 f"the fold-at-admission server")
        if (manifest["gossip_head"], sorted(manifest["workers"])) != \
                (head, ["0", "1"]) or head != REQUESTS:
            raise AssertionError(f"fleet {label}: manifest {manifest}")
        journal = FoldJournal.load(Path(tmp) / manifest["gossip_journal"])
        init = init_serve_state(S.cuda(), LAM0, window_dtype=window_dtype)
        if layout is None:
            start, spec = init, None
        else:
            spec = DistSpec(make_mesh((torch.cuda.device_count(),),
                                      ("model",)), layout)
            start = init_sharded_serve_state(
                S.cuda(), LAM0, spec=spec, window_dtype=window_dtype).state
        adaptation = OnlineAdaptation(refresh_every=FLEET_REFRESH, dist=spec)
        replayed, _ = adaptation.maybe_refresh(
            journal.replay(start, adaptation), force=True)
        replayed = replayed._replace(S=whole_window(replayed.S))
        for wid in range(FLEET_WORKERS):
            wstate, wmeta = restore_serve_state(
                Path(tmp) / f"worker_{wid}", 1, init)
            same = [torch.equal(getattr(wstate, k), getattr(replayed, k))
                    for k in ("S", "W", "L")]
            if not all(same) or wstate.slot != replayed.slot or \
                    wmeta["worker_id"] != wid:
                raise AssertionError(f"fleet {label}: worker {wid}'s "
                                     f"checkpoint differs from the replayed "
                                     f"gossip journal (S, W, L: {same})")
        print(f"  ({'b' if layout else 'a'}) round robin, "
              f"gossip, {label}: p50 {summary['p50_ms']:.3f} ms  p99 "
              f"{summary['p99_ms']:.3f} ms  {summary['rps']:.1f} req/s; "
              f"responses {worst:.2e} from the fold-at-admission server "
              f"(gate {SERVE_GATE:g}); {head} fold events; the first "
              f"reconciled probe {spread:.1e} apart, after {FLEET_SETTLE} "
              f"settling probes bit for bit; the gossip journal replayed "
              f"on the card (+ one refresh) = each worker's checkpoint bit "
              f"for bit ({t_all:.1f} s)", flush=True)
        return {"summary": summary, "worst": worst}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def fleet_partition_run(disp, trace) -> dict:
    """(c): by_adapter with gossip off, width-1 microbatches: each worker's
    responses bit for bit an eager server's on the card fed only its
    requests. Then one worker takes SIGTERM with a burst in flight (its
    draining exit answers what it read), and a burst submitted after it
    has exited is answered by the survivor alone, the survivor's keys
    placed as before."""
    S, vs, rows, lams = trace
    adapters = [f"user{i % 5}" for i in range(REQUESTS)]
    t0 = time.perf_counter()
    with disp:
        sub, got = {}, {}
        for b in range(0, REQUESTS, PER_MB):
            batch = {disp.submit(vs[i], damping=lams[i], rows=rows[i],
                                 adapter=adapters[i]): i
                     for i in range(b, b + PER_MB)}
            sub.update(batch)
            got.update({batch[r.uid]: r.x for r in disp.flush(timeout=300)})
        part = {}
        for uid, i in sub.items():
            part.setdefault(disp.assignments[uid], []).append(i)
        if len(part) != FLEET_WORKERS:
            raise AssertionError(f"fleet (c): adapters on {sorted(part)}")
        for wid, idxs in sorted(part.items()):
            srv = SolveServer(init_serve_state(S.cuda(), LAM0),
                              batcher=TokenBudgetBatcher(max_requests=1),
                              adaptation=OnlineAdaptation(
                                  refresh_every=FLEET_REFRESH),
                              monitor_drift=False, fused=True)
            ssub = {srv.submit(vs[i].cuda(), damping=lams[i],
                               rows=rows[i].cuda()): i for i in idxs}
            for r in srv.flush():
                if not np.array_equal(got[ssub[r.uid]], r.x.cpu().numpy()):
                    raise AssertionError(f"fleet (c): worker {wid}'s "
                                         f"response to request {ssub[r.uid]} "
                                         f"differs from its partition's")
        place = {a: disp.assignments[u] for u, a in
                 ((u, adapters[i]) for u, i in sub.items())}
        victim = disp.workers[1]
        survivor = 1 - victim.worker_id
        burst = 16
        before = {disp.submit(vs[i], adapter=adapters[i]): i
                  for i in range(burst)}
        victim.proc.send_signal(signal.SIGTERM)
        victim.proc.wait(timeout=120)
        after = {disp.submit(vs[i], adapter=adapters[i]): i
                 for i in range(burst)}
        results = disp.flush(timeout=300)
        answered = {r.uid for r in results}
        if answered != set(before) | set(after) or any(
                not np.isfinite(r.x).all() for r in results):
            raise AssertionError("fleet (c): a request went unanswered")
        if any(disp.assignments[u] != survivor for u in after):
            raise AssertionError("fleet (c): a request after the SIGTERM was "
                                 "not answered by the survivor")
        moved = [a for a, w in place.items()
                 if w == survivor and any(
                     disp.assignments[u] != survivor
                     for u, i in after.items() if adapters[i] == a)]
        if moved or victim.alive or victim.proc.returncode != 0:
            raise AssertionError(f"fleet (c): survivor keys moved {moved}, "
                                 f"victim exit {victim.proc.returncode}")
        drained = sum(disp.assignments[u] == victim.worker_id
                      for u in before)
        summary = disp.metrics.summary()
    print(f"  (c) by_adapter, gossip off: {len(part[0])} / {len(part[1])} "
          f"requests, each worker bit for bit its partition's eager server; "
          f"SIGTERM to worker {victim.worker_id} with {burst} requests in "
          f"flight: it answered {drained} draining (exit 0), the survivor "
          f"the rest and all {burst} sent after it exited, placement of the "
          f"survivor's keys unchanged; p50 {summary['p50_ms']:.3f} ms "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return {"summary": summary}


def fleet_cli_path() -> None:
    """(d): ``serve_main --smoke --fleet 2 --route by_adapter`` with CUDA
    workers and with ``--device cpu``: the first nine losses within
    LM_LOSS_GATE, equal fleet verdicts, the reconciled probe's agreement
    0; then ``--fleet 2 --async --smoke`` on the card against the first.
    (Run at once, as three processes, they took longer than in turn.)"""
    tmp = tempfile.mkdtemp(prefix="fleet_cli_")
    try:
        runs = {}
        for key, extra in (("cuda", ()), ("cpu", ("--device", "cpu")),
                           ("async", ("--async",))):
            _, losses, _, out, wall, _ = run_cli(
                ["--arch", LM_ARCH, "--smoke", "--fleet", "2", "--route",
                 "by_adapter", "--ckpt-dir", os.path.join(tmp, key), *extra])
            runs[key] = {
                "losses": losses, "wall": wall,
                "agree": float(cli_line(out, "reconciled probe agreement")
                               .split()[-1]),
                "verdict": cli_line(out, "fleet health: ").split()[2]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gated = 3 * 3
    errs = {key: [abs(a - b) / abs(b) for a, b in
                  zip(runs[key]["losses"], runs[ref]["losses"])]
            for key, ref in (("cuda", "cpu"), ("async", "cuda"))}
    print(f"  (d) serve_main --smoke --fleet 2 --route by_adapter: card "
          f"{runs['cuda']['wall']:.1f} s, CPU {runs['cpu']['wall']:.1f} s, "
          f"--async on the card {runs['async']['wall']:.1f} s; card losses "
          + " ".join(f"{v:.6g}" for v in runs["cuda"]["losses"])
          + "; vs the CPU " + " ".join(f"{v:.1e}" for v in errs["cuda"])
          + "; --async vs eager " + " ".join(
              f"{v:.1e}" for v in errs["async"])
          + f" (gate {LM_LOSS_GATE:g} on the first {gated}); verdicts "
          + " / ".join(runs[k]["verdict"] for k in runs)
          + "; probe agreement " + " / ".join(
              f"{runs[k]['agree']:.2e}" for k in runs), flush=True)
    for key in ("cuda", "async"):
        if len(runs[key]["losses"]) != 12 or \
                not max(errs[key][:gated]) < LM_LOSS_GATE:
            raise AssertionError(f"fleet CLI {key}: losses "
                                 f"{max(errs[key][:gated]):.3e} apart")
    if len({r["verdict"] for r in runs.values()}) != 1 or \
            any(r["agree"] != 0.0 for r in runs.values()):
        raise AssertionError("fleet CLI: verdicts differ or the "
                             "reconciled probes disagree")


def fleet_specs(trace, profiles: dict) -> dict:
    """The launch of each fleet: (init meta, init arrays, route, gossip).
    (a) fp32 eager workers, (b) bf16 async workers sharded 1d, both
    profiled into ``profiles``; (c) width-1 eager workers."""
    S = trace[0]
    return {
        "a": (fleet_meta(profile_dir=profiles["a"]), {"S0": S},
              "round_robin", True),
        "b": (fleet_meta(profile_dir=profiles["b"], layout="1d",
                         window_dtype="bfloat16", **{"async": True}),
              {"S0": S.to(torch.bfloat16)}, "round_robin", True),
        "c": (fleet_meta(max_requests=1), {"S0": S}, "by_adapter", False)}


def fleet_path(trace) -> dict:
    """The fleet phase: (a) an fp32 window on replicated eager workers and
    (b) a bf16 window sharded 1d on async workers, both with gossip and
    profiled; (c) by_adapter without gossip; (d) the CLI. Returns the
    launches in the workers of (a) and (b), counted from their profile
    traces: ``serve_solve`` and ``fold_cols`` in (a); ``gram`` and
    ``cholesky`` at (b)'s age refreshes, ``trisolve`` and ``serve_apply``
    on its solves."""
    counts, out, fleets = dict.fromkeys(KERNELS, 0), {}, {}
    profiles = {run: tempfile.mkdtemp(prefix="fleet_profile_")
                for run in FLEET_KERNELS}
    try:
        # the three fleets start at once: a worker's start (a Python,
        # ``import torch``, a CUDA context) dwarfs its trace; each fleet
        # then serves alone, the others' workers waiting on their sockets
        t0 = time.perf_counter()
        with ThreadPoolExecutor(3) as pool:
            launched = {run: pool.submit(
                launch_fleet, FLEET_WORKERS, init_meta=meta,
                init_arrays=arrays, route=route, gossip=gossip)
                for run, (meta, arrays, route, gossip)
                in fleet_specs(trace, profiles).items()}
        for run, future in launched.items():
            if future.exception() is None:
                fleets[run] = future.result()
        for future in launched.values():
            if future.exception() is not None:
                raise future.exception()
        print(f"  three fleets of {FLEET_WORKERS} workers up at once in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for run, kw in (("a", {}), ("b", {"window_dtype": torch.bfloat16,
                                          "layout": "1d"})):
            out[run] = fleet_gossip_run(fleets[run], trace, **kw)
            got, busy = trace_kernels(profiles[run], FLEET_KERNELS[run])
            print(f"  ({run}) launches in the workers (their profile "
                  f"traces): " + ", ".join(
                      f"{k}={v}" for k, v in got.items() if v)
                  + "; device busy a worker (kernels + copies of its "
                  "traced span, init to exit): " + ", ".join(
                      f"{k:.1f} + {c:.1f} of {w:.0f} ms"
                      for k, c, w in busy), flush=True)
            for kname in FLEET_KERNELS[run]:
                require_launches(f"fleet ({run}), in the workers", got,
                                 kname)
            add_counts(counts, got)
        fleet_partition_run(fleets["c"], trace)
    finally:
        for disp in fleets.values():
            disp.shutdown(drain=False, timeout=60)   # no-op once drained
        for prof in profiles.values():
            shutil.rmtree(prof, ignore_errors=True)
    fleet_cli_path()
    return {"counts": counts, "a": out["a"]["summary"],
            "b": out["b"]["summary"]}


# ---------------------------------------------------------------------------
# 11. the streaming curvature cache
# ---------------------------------------------------------------------------

def stream_data():
    """Host data of the drifting window: S_t = S0 + eps·t·E for t < 4,
    then an unrelated window S1 + eps·(t − 4)·E; one v per step."""
    gen = torch.Generator().manual_seed(SEED + 9)
    n, m = STREAM_N, M
    S0, E, S1 = (torch.randn((n, m), generator=gen) / m ** 0.5
                 for _ in range(3))
    vs = [torch.randn((m,), generator=gen) for _ in range(STREAM_STEPS)]
    return S0, E, S1, vs


def stream_run(data, device) -> list:
    """The trace through ``CurvatureCache(StreamingCurvature(512,
    refresh_every=3, drift_tol=0.5))`` on ``device``; per step (x, hits,
    refreshes, age, last residual, window)."""
    S0, E, S1, vs = (t.to(device) if isinstance(t, torch.Tensor)
                     else [v.to(device) for v in t] for t in data)
    cache = CurvatureCache(StreamingCurvature(STREAM_N, refresh_every=3,
                                              drift_tol=0.5, device=device))
    out = []
    for t in range(STREAM_STEPS):
        S_t = S0 + (STREAM_EPS * t) * E if t < 4 \
            else S1 + (STREAM_EPS * (t - 4)) * E
        x = cache.solve(S_t, vs[t], LAM0)
        st = cache.state
        out.append((x, st.stats.hits, st.stats.refreshes, st.age,
                    st.stats.last_residual, S_t))
    return out


def streaming_path() -> None:
    data = stream_data()
    t0 = time.perf_counter()
    gpu = stream_run(data, "cuda")
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = stream_run(data, "cpu")
    t_cpu = time.perf_counter() - t0
    refreshes = 0
    for t, (g, c) in enumerate(zip(gpu, cpu)):
        x, hits, refr, age, r, S_t = g
        if x.shape != (M,) or not torch.isfinite(x).all():
            raise AssertionError(f"stream step {t}: x not a finite (m,)")
        line = (f"  stream step {t}: hits {hits}, refreshes {refr}, age "
                f"{age}, drift residual {r:.3e} (CPU {c[4]:.3e}); x vs CPU "
                f"{rel(x.cpu(), c[0]):.2e}")
        if refr > refreshes:        # a refresh step: the exact solve
            err = rel(x, chol_solve(S_t, data[3][t].cuda(), LAM0))
            line += f", vs plain chol_solve {err:.2e} (gate {SOLVE_GATE:g})"
            if not err < SOLVE_GATE:
                raise AssertionError(f"stream step {t}: {err:.3e} from "
                                     "the plain solve")
        refreshes = refr
        print(line, flush=True)
        if (hits, refr, age) != c[1:4]:
            raise AssertionError(f"stream step {t}: counters {hits, refr, age}"
                                 f" differ from the CPU run's {c[1:4]}")
    print(f"  streaming trace {t_gpu:.1f} s on the card, {t_cpu:.1f} s on "
          "the CPU", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    S, _ = solve_inputs(N, M, gen)
    sg = StreamingGram(N, device="cuda")
    for b in BlockedScores.from_dense(S, WIDTHS).blocks:
        sg = sg.update(b)
    err = rel(sg.gram(), ops.gram(S, mode="ref"))
    print(f"  StreamingGram over {WIDTHS}: vs plain gram {err:.2e} (gate "
          f"{PASS_TOL:g}), {sg.m} columns folded", flush=True)
    if not err < PASS_TOL or sg.m != M:
        raise AssertionError(f"StreamingGram {err:.3e} from the plain gram")


# ---------------------------------------------------------------------------
# 12. flash attention: kernel checks
# ---------------------------------------------------------------------------

def attention_inputs(B, T, KH, g, hd, dtype, gen, Tk=None):
    """q (B, T, KH·g, hd), k and v (B, Tk or T, KH, hd), N(0, 1), on the
    card."""
    def draw(rows, heads):
        return torch.randn((B, rows, heads, hd), generator=gen,
                           device="cuda").to(dtype)
    Tk = T if Tk is None else Tk
    return draw(T, KH * g), draw(Tk, KH), draw(Tk, KH)


def flash_case(q, k, v, causal, window, label,
               scale=None) -> tuple[float, float]:
    """One sweep case: kernel twice (bit-identical) against the plain
    version; the output a finite tensor of q's shape and dtype."""
    def fn(mode):
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, mode=mode)
    err, abs_err = check_case(label, fn, FLASH_TOL[q.dtype])
    out = fn("kernel")
    if out.shape != q.shape or out.dtype != q.dtype \
            or not torch.isfinite(out).all():
        raise AssertionError(f"{label}: not a finite {tuple(q.shape)} "
                             f"{q.dtype}")
    return err, abs_err


def flash_checks() -> dict:
    """The sweep: kernel twice (bit-identical) against the plain version,
    fp32 and bf16; returns {"flash_attention": abs error at the serving
    trace's layer shape (T = 1024, 24/8 heads, hd 128, bf16, causal)}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    main_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        for hd in FLASH_HD:
            worst = 0.0
            for KH, g in FLASH_GQA:
                for T in FLASH_T:
                    q, k, v = attention_inputs(2, T, KH, g, hd, dtype, gen)
                    for causal, window in FLASH_MASKS:
                        err, abs_err = flash_case(
                            q, k, v, causal, window,
                            f"flash_attention {str(dtype)[6:]} hd={hd} KH={KH} "
                            f"g={g} T={T} causal={causal} window={window}")
                        worst = max(worst, err)
                        if (dtype, hd, KH, g, T, causal, window) == (
                                torch.bfloat16, 128, 8, 3, 1024, True, None):
                            main_err["flash_attention"] = abs_err
                for Tq, Tk in FLASH_RAGGED:
                    q, k, v = attention_inputs(2, Tq, KH, g, hd, dtype, gen,
                                               Tk=Tk)
                    for causal, window in FLASH_MASKS:
                        err, _ = flash_case(
                            q, k, v, causal, window,
                            f"flash_attention {str(dtype)[6:]} hd={hd} KH={KH} "
                            f"g={g} Tq={Tq} Tk={Tk} causal={causal} "
                            f"window={window}")
                        worst = max(worst, err)
            print(f"  {str(dtype)[6:]} hd={hd}: worst rel err {worst:.2e} over "
                  f"(KH, group) {FLASH_GQA}, T {FLASH_T}, (Tq, Tk) "
                  f"{FLASH_RAGGED}, masks {FLASH_MASKS} (gate "
                  f"{FLASH_TOL[dtype]:g})", flush=True)
    for hd in WGMMA_HEAD_DIMS:
        worst = 0.0
        for T in FLASH_LONG_T:
            q, k, v = attention_inputs(1, T, 8, 3, hd, torch.bfloat16, gen)
            for causal, window in FLASH_MASKS:
                err, _ = flash_case(q, k, v, causal, window,
                                    f"flash_attention bf16 hd={hd} 24/8 T={T} "
                                    f"causal={causal} window={window}")
                worst = max(worst, err)
            del q, k, v
        q, k, v = attention_inputs(2, 300, 2, 2, hd, torch.bfloat16, gen)
        for scale in FLASH_SCALES:
            for causal, window in ((True, 16), (False, None)):
                err, _ = flash_case(q, k, v, causal, window,
                                    f"flash_attention bf16 hd={hd} T=300 "
                                    f"scale={scale} causal={causal} "
                                    f"window={window}", scale=scale)
                worst = max(worst, err)
        print(f"  bfloat16 hd={hd} (wgmma): worst rel err {worst:.2e} at T "
              f"{FLASH_LONG_T} (24/8 heads, masks {FLASH_MASKS}) and at "
              f"scales {FLASH_SCALES} (gate {FLASH_TOL[torch.bfloat16]:g})",
              flush=True)
    for label, B, Tq, KH, g, hd, Tk, causal, dtypes in FLASH_A6B:
        for dtype in dtypes:
            q, k, v = attention_inputs(B, Tq, KH, g, hd, dtype, gen, Tk=Tk)
            err, _ = flash_case(q, k, v, causal, None,
                                f"flash_attention {label} {str(dtype)[6:]}")
            print(f"  {label}: q ({B}, {Tq}, {KH * g}, {hd}), k ({B}, {Tk}, "
                  f"{KH}, {hd}), {str(dtype)[6:]}, causal={causal}: rel err "
                  f"{err:.2e} (gate {FLASH_TOL[dtype]:g}), repeat "
                  "bit-identical", flush=True)
    # a fully masked row (q beyond every key of its window) gives 0, not
    # NaN: within 64-row and 128-row q tiles, and past a 128-key tile
    for Tq, Tk, window, hd in ((300, 40, 16, 128), (600, 200, 32, 128),
                               (600, 200, 32, 64), (300, 40, 16, 32)):
        q, k, v = attention_inputs(1, Tq, 2, 2, hd, torch.bfloat16, gen, Tk=Tk)
        short = ops.flash_attention(q, k, v, causal=True, window=window,
                                    mode="kernel")
        torch.cuda.synchronize()
        dead = Tk + window - 1          # rows from here on see no key
        if not (torch.isfinite(short).all() and short[:, dead:].eq(0).all()
                and short[:, :dead].abs().sum() > 0):
            raise AssertionError(f"flash_attention Tq={Tq} Tk={Tk} window="
                                 f"{window} hd={hd}: rows with no live key "
                                 "not 0")
    print("  repeats bit-identical; rows with no live key give 0", flush=True)
    return main_err


# ---------------------------------------------------------------------------
# 13. the LM serving front
# ---------------------------------------------------------------------------

def require_launches(label: str, counts: dict, name: str,
                     expect=None) -> None:
    """Raise unless ``name`` launched ``expect`` times (None: at least once)."""
    if (counts[name] == 0) if expect is None else (counts[name] != expect):
        raise AssertionError(f"{label}: {name} launched {counts[name]} "
                             f"times, expected "
                             f"{'some' if expect is None else expect}")


def gram64(S, chunk: int = 1 << 26) -> torch.Tensor:
    """S·Sᵀ in float64, summed over column chunks of S (4 GB at a time)."""
    W = torch.zeros((S.shape[0],) * 2, dtype=torch.float64, device=S.device)
    for j in range(0, S.shape[1], chunk):
        b = S[:, j:j + chunk].double()
        W += b @ b.T
    return W


def chunked_resolve_err(S, v, lam: float, jitter: float, x,
                        chunk: int = 1 << 26) -> float:
    """``plain_resolve_err`` of a low-precision window, whose fp32 copy
    would not fit beside it: Algorithm 1 in plain PyTorch over column
    chunks widened to fp32 (W = S·Sᵀ and u = S·v summed, L = chol(W +
    (λ + jitter)I) on the plain route, w = L⁻ᵀL⁻¹u, x_plain = (v − Sᵀw)/λ
    chunk by chunk)."""
    n, m = S.shape
    W = torch.zeros((n, n), dtype=torch.float32, device=S.device)
    u = torch.zeros((n,), dtype=torch.float32, device=S.device)
    for j in range(0, m, chunk):
        b = S[:, j:j + chunk].float()
        W += b @ b.T
        u += b @ v[j:j + chunk].float()
    eye = torch.eye(n, dtype=torch.float32, device=S.device)
    with ops.default_mode("ref"):
        L = plain_cholesky(W + (real_scalar(lam, torch.float32)
                                + real_scalar(jitter, torch.float32)) * eye)
    w = torch.linalg.solve_triangular(
        L.T, torch.linalg.solve_triangular(L, u[:, None], upper=False),
        upper=True)[:, 0]
    diff = ref = torch.zeros((), dtype=torch.float32, device=S.device)
    for j in range(0, m, chunk):
        xp = (v[j:j + chunk].float() - S[:, j:j + chunk].float().T @ w) / lam
        diff = torch.maximum(diff, (x[j:j + chunk].float() - xp).abs().max())
        ref = torch.maximum(ref, xp.abs().max())
    return float(diff / ref.clamp_min(1e-30))


def plain_resolve_err(state, v, lam: float, jitter: float, x) -> float:
    """max |x − x_plain| / max |x_plain|, x_plain being v solved on the
    plain route (``ops.default_mode("ref")``) against a factorization of
    the kernel run's own window at this request, at λ: the same inputs,
    and neither a kernel nor the folds' maintained W and L in it. A bf16
    window takes ``chunked_resolve_err``."""
    if state.S.element_size() < 4:
        return chunked_resolve_err(state.S, v, lam, jitter, x)
    with ops.default_mode("ref"):
        fac = chol_factorize(state.S, lam, mode=serve_mode(state),
                             jitter=jitter)
        x_plain = fac.solve(v.to(state.S.device))
    return float((x - x_plain).abs().max() / x_plain.abs().max()
                 .clamp_min(1e-30))


def same_inputs_check(server, errs: dict, sync):
    """Wrap the server's microbatch solve: after each one, hold every
    request's x to ``plain_resolve_err`` of the state and v it was solved
    with (errs[uid]). The check's time is taken off the server's clock,
    so the latency metrics leave it out (a flush's wall time keeps it).
    Returns the undo."""
    serve, clock = server._serve, server.clock
    paused = [0.0]

    def checked(mb):
        st = server.state
        out = serve(mb)
        t0 = time.perf_counter()
        for j, res in enumerate(out):
            errs[res.uid] = plain_resolve_err(st, mb.V[:, j],
                                              float(mb.dampings[j]),
                                              server.jitter, res.x)
        sync()
        paused[0] += time.perf_counter() - t0
        return out

    def undo():
        server._serve, server.clock = serve, clock
        return paused[0]
    server._serve = checked
    server.clock = lambda: clock() - paused[0]
    return undo


def attention_layers(cfg) -> int:
    """Layers with self-attention."""
    return sum(slot.kind == "attn" for slot in cfg.slots) * cfg.repeats


def prefill_launches(cfg) -> int:
    """The flash-attention launches of a prefill whose every attention
    takes the kernel route: a self-attention layer one, a cross-attention
    layer one more, and an encoder's bidirectional layers one each."""
    cross = sum(slot.cross_attn for slot in cfg.slots) * cfg.repeats
    enc = cfg.enc_layers if cfg.family in ("encdec", "audio") else 0
    return attention_layers(cfg) + cross + enc


def lm_trace(cfg, mode, *, device="cuda", against=None, profile_round=False,
             window_dtype=None, burst=LM_BURST, decode_tokens=LM_NEW):
    """Build the server and serve the trace with every kernel wrapper at
    ``mode`` (None: kernels on the card; "ref": the plain versions).
    ``against``: the kernel run's result; each solution x is then held
    to it as it comes. Without ``against`` each x is also held to its v
    re-solved on the plain route against the run's own window
    (``same_inputs_check``).
    ``window_dtype``: the window's storage dtype (None: fp32); ``burst``:
    requests a flush; ``decode_tokens``: greedy tokens a request (0: no
    decode, whisper's serving trace). Returns the records, x of each
    request (on the host, kernel run only), those errors, the launch
    counts and the server summary."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    xs, x_err, same_err = {}, {}, {}
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def on_result(rec, res):
        if against is None:
            xs[rec["request"]] = res.x.float().cpu()
        else:
            # on the card, the kernel run's x brought over a chunk at a time
            x = res.x.float()
            x_err[rec["request"]] = (rel(x, against["xs"][rec["request"]]),
                                     rel2(x, against["xs"][rec["request"]]))
        if res.x.shape != (m,) or not torch.isfinite(res.x).all():
            raise AssertionError(f"request {rec['request']}: x not a finite "
                                 f"({m},)")

    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with ops.default_mode(mode):
        server, h = build_server(
            cfg, window=LM_WINDOW, seq=LM_SEQ, damping=LM_LAM0,
            max_tokens=LM_MAX_TOKENS, max_requests=LM_MAX_REQUESTS,
            refresh_every=LM_REFRESH, score_chunk=LM_SCORE_CHUNK, seed=SEED,
            window_dtype=window_dtype, device=device)
        sync()
        build_s = time.perf_counter() - t0
        m = server.state.S.shape[1]
        undo = same_inputs_check(server, same_err, sync) \
            if against is None else None
        t0 = time.perf_counter()
        out = serve_trace(server, h, requests=LM_REQUESTS, window=LM_WINDOW,
                          adapt_examples=LM_ADAPT, seq=LM_SEQ,
                          decode_tokens=decode_tokens, damping=LM_LAM0,
                          lr=LM_LR, burst=burst, seed=SEED, keep_logits=True,
                          on_result=on_result,
                          log=lambda line: print("    " + line, flush=True))
        sync()
        trace_s = time.perf_counter() - t0
        check_s = undo() if undo is not None else 0.0
    counts = ops.launch_counts()
    summary = server.metrics.summary()
    stats = server.stats
    print(f"  [{mode or 'kernels'}] m = {m:,} parameters, window "
          f"{LM_WINDOW}x{m} {str(server.state.S.dtype)[6:]} "
          f"({server.state.S.numel() * server.state.S.element_size() / 1e9:.2f}"
          f" GB); build {build_s:.1f} s, trace {trace_s:.1f} s (of it "
          f"{check_s:.1f} s of same-inputs checks, inside the flushes and off "
          f"the server's clock); solve p50 "
          f"{summary['p50_ms']:.1f} ms, p99 {summary['p99_ms']:.1f} ms, "
          f"{summary['rps']:.2f} req/s; adapted {stats.adapted} rows, "
          f"{stats.refreshes} refreshes over {stats.microbatches} "
          f"microbatches; "
          + (f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
             if device == "cuda" else "")
          + "launches "
          + ", ".join(f"{k}={v}" for k, v in counts.items() if v), flush=True)
    recs = out["records"]
    for key in ("score_ms", "flush_ms", "apply_ms", "decode_ms"):
        vals = [rec[key] for rec in recs if key in rec]
        if not vals:
            continue
        print(f"    per request {key}: mean {np.mean(vals):.1f}, min "
              f"{min(vals):.1f}, max {max(vals):.1f}", flush=True)
    if against is None:
        # the folds (fold_cols on the card) kept W = S·Sᵀ of the window: held
        # to a float64 Gram summed over column chunks, since one fp32 sum
        # over m = 6e8 columns (the plain Gram's) is itself ~1e-4 off
        st = server.state
        W64 = gram64(st.S)
        w_err = rel(st.W, W64)
        with ops.default_mode("ref"):
            plain_err = rel(ops.gram(st.S), W64)
        print(f"    folded W vs the float64 S·Sᵀ of the final window "
              f"{w_err:.2e} (gate {PASS_TOL:g}; the plain fp32 Gram "
              f"{plain_err:.2e})", flush=True)
        if not w_err < PASS_TOL:
            raise AssertionError(f"LM serving: folded W {w_err:.3e} from "
                                 "the window's Gram")
        del st, W64
    if profile_round:
        gc.collect()
        torch.cuda.empty_cache()
        # one request a round: a burst's three pending requests and their
        # solutions leave too little of the card for the fold's copy
        # beside the profiler
        label = ("one serving round (score pass, solve + fold, update"
                 + (f", prefill + {decode_tokens - 1} decode steps)"
                    if decode_tokens else ", no decode)"))
        wants_attention = bool(attention_layers(cfg) and decode_tokens)
        busy = profile_retaken(label, lambda: serve_trace(
            server, h, requests=1, window=LM_WINDOW,
            adapt_examples=LM_ADAPT, seq=LM_SEQ, decode_tokens=decode_tokens,
            damping=LM_LAM0, lr=LM_LR, burst=1, seed=SEED,
            log=lambda line: None), lambda b, _: not wants_attention
            or any("flash_" in k for k in b))
        if wants_attention:
            require_wgmma_attention(label, busy)
    del server, h
    same = {rec["request"]: same_err[rec["uid"]] for rec in recs} \
        if against is None else {}
    return {"records": recs, "xs": xs, "x_err": x_err, "same_err": same,
            "counts": counts, "summary": summary, "m": m}


def token_agreement(k_rec, p_rec, vocab: int) -> str:
    """'equal', or the step of the first flip and the two runs' top-2
    margins there; raises if a margin is wider than twice the logit gate
    (relative to the largest |logit| of the real vocabulary: the padded
    slots hold NEG_INF)."""
    if k_rec["tokens"] == p_rec["tokens"]:
        return "equal"
    step = next(i for i, (a, b) in enumerate(zip(k_rec["tokens"],
                                                  p_rec["tokens"])) if a != b)
    tol = LM_LOGIT_GATE * float(p_rec["logits"][step][:vocab].abs().max())
    a, b = k_rec["tokens"][step], p_rec["tokens"][step]
    margins = (float(k_rec["logits"][step][a] - k_rec["logits"][step][b]),
               float(p_rec["logits"][step][b] - p_rec["logits"][step][a]))
    if max(margins) > 2 * tol:
        raise AssertionError(f"request {k_rec['request']}: token {step} "
                             f"flipped with margins {margins} > 2 x {tol:.3g}")
    return f"flip at step {step}, margins {margins[0]:.3g}/{margins[1]:.3g}"


def lm_serving_path(cfg, device="cuda", window_dtype=None,
                    burst=LM_BURST, decode_tokens=LM_NEW) -> dict:
    """The trace on the kernels, then on the plain versions; gates losses,
    each x, and with decode the first prefill's last-position logits and
    the tokens. The prefills launch flash attention once an attention
    layer (``decode_tokens`` = 0: no prefill, no launch)."""
    kern = lm_trace(cfg, None, device=device, profile_round=device == "cuda",
                    window_dtype=window_dtype, burst=burst,
                    decode_tokens=decode_tokens)
    require_launches("LM serving", kern["counts"], "flash_attention",
                     attention_layers(cfg) * LM_REQUESTS if decode_tokens
                     else 0)
    require_launches("LM serving", kern["counts"], "fold_cols")
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    plain = lm_trace(cfg, "ref", device=device, against=kern,
                     window_dtype=window_dtype, burst=burst,
                     decode_tokens=decode_tokens)
    require_launches("LM serving, plain route", plain["counts"],
                     "flash_attention", 0)
    by_req = {rec["request"]: rec for rec in plain["records"]}
    worst_loss = 0.0
    for rec in kern["records"]:
        p_rec = by_req[rec["request"]]
        loss_err = abs(rec["loss"] - p_rec["loss"]) / abs(p_rec["loss"])
        worst_loss = max(worst_loss, loss_err)
        x_max, x_l2 = plain["x_err"][rec["request"]]
        same = kern["same_err"][rec["request"]]
        print(f"  request {rec['request']}: loss {rec['loss']:.5f} (plain "
              f"{p_rec['loss']:.5f}), x vs plain {x_max:.2e} max-abs, "
              f"{x_l2:.2e} in 2-norm"
              f"{'' if rec['request'] < burst else ' (inputs differ)'}, "
              f"x vs its v re-solved on the plain route against the kernel "
              f"run's window {same:.2e} (gate {LM_X_GATE:g})"
              + (f", tokens {token_agreement(rec, p_rec, cfg.vocab)}"
                 if decode_tokens else ""), flush=True)
        if not np.isfinite(rec["loss"]) or not loss_err < LM_LOSS_GATE:
            raise AssertionError(f"request {rec['request']}: loss "
                                 f"{rec['loss']} vs plain {p_rec['loss']}")
        if not same < LM_X_GATE:
            raise AssertionError(f"request {rec['request']}: x {same:.3e} "
                                 "from the plain route on the same inputs")
    worst_x = max(plain["x_err"][r][0] for r in range(burst))
    logit_line = ""
    if decode_tokens:
        # over the real vocabulary: the padded slots hold NEG_INF
        first_k, first_p = kern["records"][0]["logits"][0][:cfg.vocab], \
            plain["records"][0]["logits"][0][:cfg.vocab]
        logit_err = rel(first_k, first_p)
        logit_line = (f"first prefill's last-position logits {logit_err:.2e} "
                      f"(gate {LM_LOGIT_GATE:g}); ")
    print(f"  kernels vs plain route: worst loss {worst_loss:.2e} (gate "
          f"{LM_LOSS_GATE:g}), worst x of the first burst {worst_x:.2e} "
          f"(gate {LM_X_GATE:g}), {logit_line}plain-route solve p50 "
          f"{plain['summary']['p50_ms']:.1f} ms", flush=True)
    if not worst_x < LM_X_GATE:
        raise AssertionError(f"LM serving: x {worst_x:.3e} from plain")
    if decode_tokens and not (torch.isfinite(first_k).all()
                              and logit_err < LM_LOGIT_GATE):
        raise AssertionError(f"LM serving: logits {logit_err:.3e} from plain")
    return kern


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy (the CLI's lines)."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, text):
        self.buf.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def run_cli(argv, on_build=None) -> tuple:
    """``serve_main(argv)`` with its output shown and kept; returns
    (server, losses, the handles it built, its output, wall s, the wall s
    of each checkpoint it wrote). ``on_build(server, handles)`` runs
    before the first request. A ``--fleet`` run returns its dispatcher as
    the server and builds no handles here (None)."""
    built, saves = [], []
    build, save = serve_cli.build_server, ckpt_io.save

    def spy_build(*args, **kw):
        server, h = build(*args, **kw)
        built.append(h)
        if on_build is not None:
            on_build(server, h)
        return server, h

    def spy_save(*args, **kw):
        t0 = time.perf_counter()
        out = save(*args, **kw)
        saves.append(time.perf_counter() - t0)
        return out

    tee = _Tee(sys.stdout)
    serve_cli.build_server, ckpt_io.save = spy_build, spy_save
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            server, losses = serve_main(argv)
    finally:
        serve_cli.build_server, ckpt_io.save = build, save
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return server, losses, built[0] if built else None, \
        tee.buf.getvalue(), time.perf_counter() - t0, saves


def cli_line(out: str, head: str) -> str:
    lines = [ln for ln in out.splitlines() if ln.startswith(head)]
    if not lines:
        raise AssertionError(f"LM serving CLI: no {head!r} line")
    return lines[-1]


def cli_tree(server, h) -> dict:
    return {"serve": serve_state_tree(server.state), "params": h.params}


def lm_cli_path() -> dict:
    """``python -m repro_torch.serve --full --n-layers 2`` on the card at
    the reference's defaults (12 requests, window 8, seq 16, burst 3, a
    checkpoint every 8 rounds and at exit, the audit every 4 maintenance
    passes) with the metrics endpoint, a snapshot, a trace and a profile;
    the exit checkpoint restored bit for bit. Then the same CLI at
    ``--smoke`` on the card and on the CPU (``cli_smoke``). Files go to a
    temporary directory, removed at the end."""
    tmp = tempfile.mkdtemp(prefix="serve_cli_")
    try:
        cfg = configs.get_config(LM_ARCH).scaled(n_layers=LM_LAYERS)
        du = shutil.disk_usage(tmp)
        print(f"  {tmp}: {du.free} B free of {du.total} B before the "
              f"exit checkpoint (the window alone is 8 x m x 4 B)",
              flush=True)
        ck, snap_path = os.path.join(tmp, "ck"), os.path.join(tmp, "m.json")
        trace_path, prof = os.path.join(tmp, "t.json"), \
            os.path.join(tmp, "prof")
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        server, losses, h, out, wall, saves = run_cli(
            ["--arch", LM_ARCH, "--full", "--n-layers", str(LM_LAYERS),
             "--device", "cuda", "--ckpt-dir", ck, "--metrics-port", "0",
             "--metrics-snapshot", snap_path, "--trace-out", trace_path,
             "--profile-dir", prof])
        counts = ops.launch_counts()
        for head in ("health: ", "metrics scrape: ", "health scrape: "):
            cli_line(out, head)
        verdict = cli_line(out, "health: ").split()[1]
        with open(trace_path) as f:
            spans = json.load(f)["traceEvents"]
        with open(snap_path) as f:
            snap = json.load(f)
        requests = [e for e in spans if e["name"] == "request"]
        rounds = ckpt_io.latest_step(ck)
        ck_bytes = sum(p.stat().st_size for p in
                       Path(ck, f"step_{rounds:09d}").iterdir())
        st = server.state
        m = st.S.shape[1]
        window_b = st.S.numel() * st.S.element_size()
        param_b = sum(t.numel() * t.element_size() for t in leaves(h.params))
        print(f"  serve_main (kernels): {wall:.1f} s; m = {m:,}; peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; verdict "
              f"{verdict}; {len(requests)} request spans of {len(spans)}; "
              f"snapshot: {snap['counters'].get('serve.requests')} requests; "
              f"{server.adaptation._audit_step} audits; exit checkpoint at "
              f"round {rounds}, {ck_bytes} B (window {window_b} B, params "
              f"{param_b} B) written in "
              + "/".join(f"{t:.1f}" for t in saves) + f" s; "
              f"{cli_line(out, 'profile: ')} "
              f"({sum(f.stat().st_size for f in Path(prof).iterdir())} B, "
              f"started before the server was built); "
              f"launches " + ", ".join(f"{k}={v}" for k, v in counts.items()
                                      if v), flush=True)
        if len(requests) < len(losses) or len(losses) != 12:
            raise AssertionError("LM serving CLI: fewer request spans "
                                 "than requests")
        if snap["counters"].get("serve.requests") != 12 or \
                server.adaptation._audit_step < 1:
            raise AssertionError("LM serving CLI: snapshot or audit missing")
        for name in ("fold_cols", "flash_attention"):
            require_launches("LM serving CLI", counts, name)
        t0 = time.perf_counter()
        like = cli_tree(server, h)
        back, meta = ckpt_io.restore(ck, rounds, like)
        t_restore = time.perf_counter() - t0
        same = all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
                   for a, b in zip(leaves(back), leaves(like)))
        t0 = time.perf_counter()
        fp_same = serve_state_from_tree(back["serve"], st).fingerprint() \
            == st.fingerprint()
        t_fp = time.perf_counter() - t0
        print(f"  exit checkpoint restored onto the card in {t_restore:.1f} s"
              f" ({meta}): every leaf equal to the live state's and params': "
              f"{same}; ServeState fingerprint(full=True) equal: {fp_same} "
              f"(both fingerprints {t_fp:.1f} s)", flush=True)
        if not (same and fp_same):
            raise AssertionError("LM serving CLI: the exit checkpoint did "
                                 "not restore bit for bit")
        del back, like, server, h, st
        gc.collect()
        torch.cuda.empty_cache()

        cli_smoke(tmp)
        return {"counts": counts}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def cli_smoke(tmp: str, device: str = "cuda") -> None:
    """The CLI at ``--smoke`` on ``device`` and on the CPU (twice: at all
    threads and at one), checkpoints under ``tmp``. Gates, each request
    relative:
    - end to end, the first nine requests' losses within LM_LOSS_GATE of
      the CPU's. From the tenth on the CLI's updates have blown the loss
      up to ≈ 5e4 (both packages), and rounding alone moves it by more
      than the gate (the two CPU runs), so the last burst's end-to-end
      difference is printed;
    - on the same inputs, every request (the last burst's too): its loss
      within LM_LOSS_GATE of the CPU's loss of the same examples under a
      copy of the run's own params, and its x within LM_X_GATE of v
      re-solved on the plain route against the run's own window
      (``same_inputs_check``), after up to nine folds;
    - equal verdicts, and each run's checkpoint restored into the other
      run's tree, leaves equal to the run's own."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    same_x, seen = {}, []

    def watch(server, h):
        same_inputs_check(server, same_x, sync)
        score = h.score_grads

        def recorded(params, ex):
            out = score(params, ex)
            seen.append((tree_map(lambda t: t.detach().cpu().clone(),
                                  params), ex, float(out[0])))
            return out
        h.score_grads = recorded

    smoke = {}
    threads = torch.get_num_threads()
    for run, dev, nthreads in (("card", device, threads),
                               ("cpu", "cpu", threads), ("cpu1", "cpu", 1)):
        torch.set_num_threads(nthreads)
        try:
            server, losses, h, out, wall, _ = run_cli(
                ["--arch", LM_ARCH, "--device", dev, "--ckpt-dir",
                 os.path.join(tmp, f"smoke_{run}")],
                on_build=watch if run == "card" else None)
        finally:
            torch.set_num_threads(threads)
        smoke[run] = {"server": server, "h": h, "losses": losses,
                      "verdict": cli_line(out, "health: ").split()[1],
                      "wall": wall}
    card, cpu = smoke["card"], smoke["cpu"]

    def loss_errs(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                    b["losses"])]
    gated = 3 * 3
    errs, spread = loss_errs(card, cpu), loss_errs(smoke["cpu1"], cpu)
    loss_err = max(errs[:gated])
    same_loss = []
    for params, ex, loss in seen:
        ref = float(cpu["h"].score_grads(params, ex)[0])
        same_loss.append(abs(loss - ref) / abs(ref))
    same_x = [same_x[k] for k in sorted(same_x)]
    print(f"  --smoke losses, {device}: "
          + " ".join(f"{v:.6g}" for v in card["losses"])
          + f"; vs the CPU per request: "
          + " ".join(f"{v:.1e}" for v in errs)
          + f"; CPU at 1 thread vs {threads}: "
          + " ".join(f"{v:.1e}" for v in spread)
          + "; same inputs, loss vs the CPU's: "
          + " ".join(f"{v:.1e}" for v in same_loss)
          + "; same inputs, x vs the plain re-solve: "
          + " ".join(f"{v:.1e}" for v in same_x), flush=True)
    cross = {}
    for src, dst in (("card", "cpu"), ("cpu", "card")):
        d = smoke[dst]
        like = cli_tree(d["server"], d["h"])
        back, _ = ckpt_io.restore(os.path.join(tmp, f"smoke_{src}"), 4,
                                  like)
        theirs = leaves(cli_tree(smoke[src]["server"], smoke[src]["h"]))
        cross[src] = max(
            rel(torch.as_tensor(a).cpu().float(),
                torch.as_tensor(b).cpu().float())
            for a, b in zip(leaves(back), theirs)
            if torch.as_tensor(b).is_floating_point())
        if any(torch.as_tensor(a).dtype != torch.as_tensor(b).dtype
               or tuple(np.shape(a)) != tuple(np.shape(b))
               for a, b in zip(leaves(back), leaves(like))):
            raise AssertionError(f"LM serving CLI: the {src} checkpoint "
                                 f"does not restore into the {dst} run")
    print(f"  --smoke on {device} ({card['wall']:.1f} s) and on the CPU "
          f"({cpu['wall']:.1f} s): worst loss of the first {gated} requests"
          f" {loss_err:.2e}, on the same inputs of all {len(same_loss)} "
          f"{max(same_loss):.2e} (gate {LM_LOSS_GATE:g}); worst x on the "
          f"same inputs {max(same_x):.2e} (gate {LM_X_GATE:g}); verdicts "
          f"{card['verdict']} / {cpu['verdict']}; each checkpoint restored"
          f" into the other run's tree, leaves equal to its own run's "
          f"(worst {max(cross.values()):.1e})", flush=True)
    if not loss_err < LM_LOSS_GATE or len(same_loss) != 12 or \
            not max(same_loss) < LM_LOSS_GATE or len(same_x) != 12 or \
            not max(same_x) < LM_X_GATE or \
            card["verdict"] != cpu["verdict"] or \
            max(cross.values()) != 0.0:
        raise AssertionError("LM serving CLI: the card's and the CPU's "
                             "--smoke runs disagree")


def tenant_resolve_check(server, errs: dict, sync):
    """Wrap the server's microbatch solve: after each tenant microbatch,
    hold every request's x to v solved on the plain route
    (``ops.default_mode("ref")``) with the same tenant factor, rebuilt as
    the manager builds it from the delta the request was solved against
    (errs[uid]). The check's time is taken off the server's clock.
    Returns the undo."""
    serve, clock = server._serve, server.clock
    paused = [0.0]

    def checked(mb):
        st = server.state
        out = serve(mb)
        if mb.tenant is None:
            return out
        t0 = time.perf_counter()
        delta = server.tenants._tenants[mb.tenant].delta
        with ops.default_mode("ref"):
            for j, res in enumerate(out):
                lam = res.damping
                base = st.L if lam == st.lam0 else plain_cholesky(
                    st.W + lam * torch.eye(st.W.shape[0], dtype=st.W.dtype,
                                           device=st.W.device))
                L_t = delta_factor(delta, base, lam)
                x_plain = ops.serve_solve(st.S, L_t, mb.V[:, j],
                                          real_scalar(lam, st.W.dtype))
                errs[res.uid] = float(
                    (res.x - x_plain).abs().max()
                    / x_plain.abs().max().clamp_min(1e-30))
        sync()
        paused[0] += time.perf_counter() - t0
        return out

    def undo():
        server._serve, server.clock = serve, clock
        return paused[0]
    server._serve = checked
    server.clock = lambda: clock() - paused[0]
    return undo


def lm_tenant_cli_path() -> dict:
    """``python -m repro_torch.serve --full --n-layers 2 --tenants 16
    --tenant-rank 4 --tenant-budget-mb 0.001`` on the card (the reference's
    defaults otherwise; no checkpoint, which the CLI phase before covers):
    every microbatch is one tenant's, solved by ``serve_solve`` against
    its L_t at the request's λ (0.01, which is not the fp32 λ₀: the base
    is re-damped). Gates: ``serve_solve`` launched, every x within
    LM_X_GATE of the plain re-solve with the same tenant factor
    (``tenant_resolve_check``), the tenants line with evictions. Then
    ``--smoke --tenants 4`` on the card and on the CPU: the first nine
    losses within LM_LOSS_GATE, the tenants lines equal."""
    tmp = tempfile.mkdtemp(prefix="serve_tenants_")
    tempdir = tempfile.tempdir
    tempfile.tempdir = tmp          # the managers' spill directories
    try:
        sync = torch.cuda.synchronize
        errs = {}
        ops.reset_launch_counts()
        server, losses, h, out, wall, _ = run_cli(
            ["--arch", LM_ARCH, "--full", "--n-layers", str(LM_LAYERS),
             "--device", "cuda", "--tenants", str(LM_TENANTS),
             "--tenant-rank", str(LM_TENANT_RANK), "--tenant-budget-mb",
             str(LM_TENANT_BUDGET_MB), "--ckpt-every", "0", "--ckpt-dir",
             os.path.join(tmp, "ck")],
            on_build=lambda srv, _: tenant_resolve_check(srv, errs, sync))
        counts = ops.launch_counts()
        line = cli_line(out, "tenants: ")
        p = server.tenants.packing_stats()
        s = server.metrics.summary()
        print(f"  serve_main --tenants {LM_TENANTS} (kernels): {wall:.1f} s;"
              f" m = {server.state.S.shape[1]:,}; solve p50 "
              f"{s['p50_ms']:.1f} ms, p99 {s['p99_ms']:.1f} ms, "
              f"{s['rps']:.2f} req/s; {line}; x vs the plain re-solve with "
              f"the same tenant factor, worst {max(errs.values()):.2e} over "
              f"{len(errs)} requests (gate {LM_X_GATE:g}); launches "
              + ", ".join(f"{k}={v}" for k, v in counts.items() if v),
              flush=True)
        require_launches("LM serving CLI, tenants", counts, "serve_solve")
        if len(errs) != len(losses) or len(losses) != 12 or \
                not max(errs.values()) < LM_X_GATE:
            raise AssertionError("LM serving CLI, tenants: a response "
                                 "disagrees with its plain re-solve")
        if not p["evictions"] > 0 or server.state.stats.adapted != 0:
            raise AssertionError(f"LM serving CLI, tenants: no eviction, or "
                                 f"the shared window folded: {p}")
        del server, h
        gc.collect()
        torch.cuda.empty_cache()

        smoke = {}
        for run, dev in (("card", "cuda"), ("cpu", "cpu")):
            srv, losses, _, out, wall, _ = run_cli(
                ["--arch", LM_ARCH, "--device", dev, "--tenants", "4",
                 "--ckpt-every", "0", "--ckpt-dir",
                 os.path.join(tmp, f"smoke_{run}")])
            smoke[run] = (losses, cli_line(out, "tenants: "), wall)
        (kl, kline, kwall), (cl, cline, cwall) = smoke["card"], smoke["cpu"]
        errs = [abs(a - b) / abs(b) for a, b in zip(kl, cl)]
        print(f"  --smoke --tenants 4 on the card ({kwall:.1f} s) and on the"
              f" CPU ({cwall:.1f} s): losses vs the CPU per request "
              + " ".join(f"{e:.1e}" for e in errs) + f"; worst of the first "
              f"nine {max(errs[:9]):.2e} (gate {LM_LOSS_GATE:g}); tenants "
              f"lines equal: {kline == cline}", flush=True)
        if len(errs) != 12 or not max(errs[:9]) < LM_LOSS_GATE or \
                kline != cline:
            raise AssertionError("LM serving CLI, tenants: the card's and "
                                 "the CPU's --smoke runs disagree")
        return {"counts": counts}
    finally:
        tempfile.tempdir = tempdir
        shutil.rmtree(tmp, ignore_errors=True)


def sharded_cli_path() -> dict:
    """``python -m repro_torch.serve --full --n-layers 2 --mesh 1d
    --async`` on the card (the default ``--mesh-shape 1,1``: one position,
    the whole window its slab): the ``[async 1d]`` line, its peak memory,
    each kernel's launches against what one slab implies, the exit
    checkpoint (≈ 20 GB, in a temporary directory) restored onto the card
    and held to the live pieces bit for bit; then ``--smoke --mesh 1d
    --async`` on the card and on the CPU, the first nine losses within
    LM_LOSS_GATE."""
    tmp = tempfile.mkdtemp(prefix="sharded_cli_")
    try:
        ck = os.path.join(tmp, "ck")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        server, losses, h, out, wall, saves = run_cli(
            ["--arch", LM_ARCH, "--full", "--n-layers", str(LM_LAYERS),
             "--mesh", "1d", "--async", "--ckpt-dir", ck])
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        st = server.state
        if "[async 1d]" not in cli_line(out, "resident window factorized"):
            raise AssertionError("sharded CLI: not the async 1d server")
        # one fold a request, one cross and one apply pass a microbatch
        mbs, folds = st.stats.microbatches, st.stats.adapted // 2
        want = {"fold_cols": folds, "sv_cross": mbs, "serve_apply": mbs}
        got = {k: counts[k] for k in want}
        print(f"  serve_main --mesh 1d --async: {wall:.1f} s; m = "
              f"{st.S.shape[1]:,}; {cli_line(out, 'served ')}; peak "
              f"{peak / 1e9:.2f} GB; exit checkpoint written in "
              + "/".join(f"{t:.1f}" for t in saves) + " s; launches "
              + ", ".join(f"{k}={v}" for k, v in counts.items() if v)
              + f" (one slab implies {want})", flush=True)
        if got != want or len(losses) != 12:
            raise AssertionError(f"sharded CLI: launches {got}, one slab "
                                 f"implies {want}")
        rounds = ckpt_io.latest_step(ck)
        tmpl = st._replace(S=torch.empty(st.S.shape, dtype=st.S.dtype,
                                         device="meta"))
        t0 = time.perf_counter()
        back, meta = ckpt_io.restore(
            ck, rounds, {"serve": serve_state_tree(tmpl),
                         "params": h.params}, device="cuda")
        t_restore = time.perf_counter() - t0
        whole = back["serve"].S
        same = all(torch.equal(whole[:, a:z], p) for (a, z), p in
                   zip(st.S.col_ranges(), st.S.pieces[0][0]))
        live = serve_state_tree(st._replace(S=whole))
        same = same and all(
            torch.equal(torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu())
            for a, b in zip(leaves(back["serve"])[1:], leaves(live)[1:]))
        same = same and all(torch.equal(a, b) for a, b in
                            zip(leaves(back["params"]), leaves(h.params)))
        print(f"  exit checkpoint at round {rounds} ({meta}) restored onto "
              f"the card in {t_restore:.1f} s: the window equal to the live "
              f"slab, W, L, the counters and the params equal: {same}",
              flush=True)
        if not same:
            raise AssertionError("sharded CLI: the exit checkpoint did not "
                                 "restore bit for bit")
        del back, whole, live, server, h, st
        gc.collect()
        torch.cuda.empty_cache()
        smoke = {}
        for dev in ("cuda", "cpu"):
            _, losses, _, out, wall, _ = run_cli(
                ["--arch", LM_ARCH, "--mesh", "1d", "--async", "--device",
                 dev, "--ckpt-dir", os.path.join(tmp, f"smoke_{dev}")])
            smoke[dev] = (losses, wall)
        errs = [abs(a - b) / abs(b) for a, b in zip(smoke["cuda"][0],
                                                    smoke["cpu"][0])]
        print(f"  --smoke --mesh 1d --async: {smoke['cuda'][1]:.1f} s on the "
              f"card, {smoke['cpu'][1]:.1f} s on the CPU; losses vs the CPU "
              f"per request " + " ".join(f"{e:.1e}" for e in errs)
              + f" (the first nine gated at {LM_LOSS_GATE:g})", flush=True)
        if len(errs) != 12 or not max(errs[:9]) < LM_LOSS_GATE:
            raise AssertionError("sharded CLI: --smoke on the card and on "
                                 "the CPU disagree")
        return {"counts": counts}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def long_prefill(cfg, T, device="cuda") -> dict:
    """The whole model's prefill of one T-token prompt through the serve
    front's prefill step, then one layer's attention at that shape held
    against the plain version."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    api = get_api(cfg)
    gen = torch.Generator().manual_seed(SEED + 13)
    t0 = time.perf_counter()
    params = api.init_params(gen, device)
    tokens = torch.randint(3, cfg.vocab, (1, T), generator=gen).to(device)
    prefill = make_prefill(api)
    sync()
    init_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache, idx = prefill(params, {"tokens": tokens})
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    require_launches("long prefill", counts, "flash_attention", cfg.n_layers)
    if logits.shape != (1, 1, cfg.padded_vocab) or idx != T \
            or not torch.isfinite(logits).all():
        raise AssertionError("long prefill: logits not a finite (1, 1, V)")
    kv = cache[0]["k"]
    print(f"  {cfg.n_layers} layers, T = {T}: prefill {ms:.1f} ms (params "
          f"{sum(t.numel() for t in torch.utils._pytree.tree_leaves(params)) / 1e9:.3f}"
          f" G, drawn in {init_s:.1f} s); cache k {tuple(kv.shape)} "
          f"{str(kv.dtype)[6:]}; launches "
          + ", ".join(f"{k}={v}" for k, v in counts.items() if v), flush=True)
    del cache
    # layer 0's attention at this shape: its own q, k, v (llama: RMSNorm)
    p0 = {key: val[0] for key, val in params["blocks"][0].items()
          if isinstance(val, torch.Tensor)}
    with torch.no_grad():
        x = model_layers.rms_norm(params["embed"][tokens.long()],
                                  params["blocks"][0]["norm"]["g"][0],
                                  eps=cfg.norm_eps)
        pos = torch.arange(T, device=device)[None]
        q, k, v = model_layers.attn_qkv(x, p0, cfg, positions=pos)
        got = ops.flash_attention(q, k, v, causal=True)
        again = ops.flash_attention(q, k, v, causal=True)
        plain = ops.flash_attention(q, k, v, causal=True, mode="ref")
    sync()
    err = rel(got, plain)
    print(f"  layer 0 attention at (1, {T}, {cfg.n_heads}/{cfg.n_kv_heads}, "
          f"{cfg.head_dim}) {str(q.dtype)[6:]}: kernel vs plain {err:.2e} "
          f"(gate {FLASH_TOL[q.dtype]:g}), repeat bit-identical "
          f"{torch.equal(got, again)}", flush=True)
    if not (err < FLASH_TOL[q.dtype] and torch.equal(got, again)):
        raise AssertionError(f"long prefill: layer 0 attention {err:.3e}")
    if device == "cuda":
        label = f"one {cfg.n_layers}-layer prefill of {T} tokens"
        require_wgmma_attention(label, profile_retaken(
            label, lambda: prefill(params, {"tokens": tokens}),
            lambda b, _: any("flash_" in k for k in b)))
    return {"counts": counts, "ms": ms}


# ---------------------------------------------------------------------------
# 14a. LM serving, MoE and Mamba2 (qwen3-moe, mamba2, jamba)
# ---------------------------------------------------------------------------

def zoo_serving_path(device="cuda") -> dict:
    """Phase 13's trace and gates (``lm_serving_path``) on each cell of
    ZOO_SERVED. Returns the kernel run's launches by cell."""
    out = {}
    for arch, layers, wdtype, burst in ZOO_SERVED:
        cfg = configs.get_config(arch).scaled(n_layers=layers)
        t0 = time.perf_counter()
        print(f"  {arch}: {layers} of {configs.get_config(arch).n_layers} "
              f"layers at published widths, {cfg.dtype} weights, "
              f"{wdtype or 'float32'} window, burst {burst}, "
              f"{attention_layers(cfg)} attention layers", flush=True)
        out[arch] = lm_serving_path(cfg, device=device, window_dtype=wdtype,
                                    burst=burst)["counts"]
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        print(f"  {arch}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def forward_logits(cfg, params, tokens, extra: dict):
    """The teacher-forced forward's logits: whisper's decoder on its
    encoder's output (the blockwise attention, as ``loss`` runs it), or
    the LM over the patch prefix and the tokens."""
    if "frames" in extra:
        enc = encdec.encode(params, cfg, extra["frames"])
        return model_lm.forward(params["dec"], cfg, tokens, enc_out=enc)[0]
    return model_lm.forward(params, cfg, tokens,
                            prefix_embeds=extra.get("prefix_embeds"))[0]


def teacher_forced_decode(label, cfg, params, tokens, prompt: int, extra,
                          offset: int = 0, device="cuda") -> dict:
    """The fp32 model's prefill of ``tokens[:, :prompt]`` with ``extra``
    (the frames, or the patch prefix of ``offset`` positions) through the
    serve front's steps, then the rest of ``tokens`` teacher-forced, a
    decode step each; the prefill's last logits and every step's held to
    the teacher-forced forward's at the same position (DECODE_GATE, rtol
    = atol). The prefill must launch flash attention
    ``prefill_launches(cfg)`` times. Returns the launches and times."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    api = get_api(cfg)
    prefill, step = make_prefill(api), make_serve_step(api)
    B, T = tokens.shape
    V = cfg.vocab
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        full = forward_logits(cfg, params, tokens, extra)
        sync()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache, idx = prefill(params, {"tokens": tokens[:, :prompt],
                                              "max_len": offset + T, **extra})
        sync()
        pre_ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        errs = [(logits[:, -1, :V], full[:, offset + prompt - 1, :V])]
        t0 = time.perf_counter()
        for t in range(prompt, T):
            _, cache, last = step(params, cache, offset + t,
                                  tokens[:, t:t + 1])
            errs.append((last[:, :V], full[:, offset + t, :V]))
        sync()
        dec_ms = (time.perf_counter() - t0) * 1e3 / (T - prompt)
    tol = DECODE_GATE
    worst = max(float(((a - b).abs() / (tol + tol * b.abs())).max())
                for a, b in errs)
    max_abs = max(float((a - b).abs().max()) for a, b in errs)
    finite = all(bool(torch.isfinite(a).all()) for a, _ in errs)
    print(f"  {label}: forward of ({B}, {offset} + {T}) {fwd_ms:.1f} ms, "
          f"prefill of ({B}, {offset} + {prompt}) {pre_ms:.1f} ms (next index"
          f" {idx}), decode {dec_ms:.2f} ms a step; the prefill's last "
          f"logits and {T - prompt} decode steps vs the teacher-forced "
          f"forward: max-abs {max_abs:.2e}, worst |a − b| / ({tol:g} + "
          f"{tol:g}|b|) {worst:.3f} (gate 1); prefill launches "
          + (", ".join(f"{k}={v}" for k, v in counts.items() if v) or "none"),
          flush=True)
    if not (finite and worst <= 1.0 and idx == offset + prompt):
        raise AssertionError(f"{label}: decode {worst:.3f} of the gate from "
                             "the teacher-forced forward")
    require_launches(label, counts, "flash_attention", prefill_launches(cfg))
    del full, cache, logits, errs
    return {"counts": counts, "decode_ms": dec_ms, "prefill_ms": pre_ms}


def timed_decode(label, cfg, params, tokens, extra, n_new: int,
                 offset: int = 0, device="cuda") -> dict:
    """A prefill of ``tokens`` (with ``extra``) and ``n_new`` greedy decode
    steps, timed after a warm-up (three prefills, the last two timed; two
    steps, then ``n_new`` timed). Returns the last prefill's launches."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    api = get_api(cfg)
    prefill, step = make_prefill(api), make_serve_step(api)
    T = tokens.shape[1]
    batch = {"tokens": tokens, "max_len": offset + T + n_new + 2, **extra}
    with torch.no_grad():
        pre = []
        for _ in range(3):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            logits, cache, idx = prefill(params, batch)
            sync()
            pre.append((time.perf_counter() - t0) * 1e3)
        counts = ops.launch_counts()
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)
        for t in range(2):
            nxt, cache, _ = step(params, cache, idx + t, nxt[:, None])
        sync()
        t0 = time.perf_counter()
        for t in range(2, 2 + n_new):
            nxt, cache, last = step(params, cache, idx + t, nxt[:, None])
        sync()
        dec = (time.perf_counter() - t0) * 1e3 / n_new
    if not torch.isfinite(last[:, :cfg.vocab]).all():
        raise AssertionError(f"{label}: logits not finite")
    print(f"  {label}: prefill of ({tokens.shape[0]}, {offset} + {T}) "
          f"{pre[1]:.1f} / {pre[2]:.1f} ms (warm-up {pre[0]:.1f}), greedy "
          f"decode {dec:.3f} ms a step over {n_new} steps; prefill launches "
          + (", ".join(f"{k}={v}" for k, v in counts.items() if v) or "none"),
          flush=True)
    require_launches(label, counts, "flash_attention", prefill_launches(cfg))
    del cache
    return {"counts": counts, "decode_ms": dec, "prefill_ms": pre[2]}


def add_counts(total: dict, counts: dict) -> dict:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def n_params(params) -> int:
    return sum(t.numel() for t in leaves(params))


def mamba_decode_path(device="cuda") -> dict:
    """mamba2-1.3b at MAMBA_LAYERS layers: the fp32 model's prefill of a
    MAMBA_PROMPT-token prompt (batch MAMBA_B), then MAMBA_STEPS
    teacher-forced decode steps against the teacher-forced forward
    (``teacher_forced_decode``); then the bf16 model's prefill of
    MAMBA_TIMED_PROMPT tokens and MAMBA_TIMED_TOKENS greedy decode steps,
    timed (``timed_decode``)."""
    cfg = configs.get_config(MAMBA_ARCH).scaled(n_layers=MAMBA_LAYERS,
                                                dtype="float32")
    api = get_api(cfg)
    gen = torch.Generator().manual_seed(SEED + 17)
    t0 = time.perf_counter()
    params = api.init_params(gen, device)
    T = MAMBA_PROMPT + MAMBA_STEPS
    tokens = torch.randint(3, cfg.vocab, (MAMBA_B, T), generator=gen).to(device)
    print(f"  {cfg.n_layers} layers, fp32, {n_params(params) / 1e9:.3f} G "
          f"params drawn in {time.perf_counter() - t0:.1f} s", flush=True)
    out = teacher_forced_decode(f"{MAMBA_ARCH} fp32", cfg, params, tokens,
                                MAMBA_PROMPT, {}, device=device)
    del params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    cfg16 = configs.get_config(MAMBA_ARCH).scaled(n_layers=MAMBA_LAYERS)
    params = get_api(cfg16).init_params(
        torch.Generator().manual_seed(SEED + 17), device)
    prompt = torch.randint(3, cfg.vocab, (1, MAMBA_TIMED_PROMPT),
                           generator=gen).to(device)
    timed_decode(f"{MAMBA_ARCH} bf16", cfg16, params, prompt, {},
                 MAMBA_TIMED_TOKENS, device=device)
    del params
    return {"counts": out["counts"], "decode_ms": out["decode_ms"]}


def zoo_cli_path(cells=tuple((arch, ()) for arch in ZOO_CLI),
                 train_steps: int = 0) -> dict:
    """``serve_main --arch A --smoke`` (with each cell's extra flags) on the
    card and on the CPU at the reference's defaults (12 requests, window
    8, seq 16, burst 3; checkpoints into a temporary directory): the first
    nine requests' losses within LM_LOSS_GATE of the CPU's (from the tenth
    on the CLI's updates have blown the loss up, as in ``cli_smoke``), the
    rest printed. With ``train_steps``, also ``train_main --arch A --smoke
    --optimizer ngd --steps train_steps`` on both, every step's loss
    within LM_LOSS_GATE of the CPU's. Returns the card runs' launches,
    summed."""
    tmp = tempfile.mkdtemp(prefix="zoo_cli_")
    total = {}
    try:
        for arch, extra in cells:
            runs = {}
            for dev in ("cuda", "cpu"):
                ops.reset_launch_counts()
                server, losses, _, out, wall, _ = run_cli(
                    ["--arch", arch, "--smoke", "--device", dev,
                     "--ckpt-dir", os.path.join(tmp, f"{arch}_{dev}"),
                     *extra])
                runs[dev] = {"losses": losses, "wall": wall,
                             "adapted": server.stats.adapted,
                             "verdict": cli_line(out, "health: ").split()[1],
                             "counts": ops.launch_counts()}
            card, cpu = runs["cuda"], runs["cpu"]
            add_counts(total, card["counts"])
            errs = [abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                                        cpu["losses"])]
            gated = 3 * 3
            worst = max(errs[:gated])
            print(f"  {arch} --smoke {' '.join(extra)}: card "
                  f"{card['wall']:.1f} s, CPU "
                  f"{cpu['wall']:.1f} s; losses on the card "
                  + " ".join(f"{v:.6g}" for v in card["losses"])
                  + "; vs the CPU per request "
                  + " ".join(f"{v:.1e}" for v in errs)
                  + f"; worst of the first {gated} {worst:.2e} (gate "
                  f"{LM_LOSS_GATE:g}); adapted {card['adapted']} / "
                  f"{cpu['adapted']} rows; verdicts {card['verdict']} / "
                  f"{cpu['verdict']}; card launches "
                  + ", ".join(f"{k}={v}" for k, v in card["counts"].items()
                              if v), flush=True)
            if len(card["losses"]) != 12 or not worst < LM_LOSS_GATE:
                raise AssertionError(f"{arch} --smoke: the card's losses "
                                     f"{worst:.3e} from the CPU's")
            require_launches(f"{arch} --smoke", card["counts"], "fold_cols")
            if not train_steps:
                continue
            trained = {}
            for dev in ("cuda", "cpu"):
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                losses, report = train_main(
                    ["--arch", arch, "--smoke", "--device", dev,
                     "--optimizer", "ngd", "--steps", str(train_steps),
                     "--ckpt-dir", os.path.join(tmp, f"{arch}_{dev}_train")])
                if dev == "cuda":
                    torch.cuda.synchronize()
                trained[dev] = {"losses": losses, "report": report,
                                "wall": time.perf_counter() - t0,
                                "counts": ops.launch_counts()}
            card, cpu = trained["cuda"], trained["cpu"]
            add_counts(total, card["counts"])
            errs = [abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                                        cpu["losses"])]
            print(f"  {arch} train_main --smoke --optimizer ngd --steps "
                  f"{train_steps}: card {card['wall']:.1f} s, CPU "
                  f"{cpu['wall']:.1f} s; losses on the card "
                  + " ".join(f"{v:.6g}" for v in card["losses"])
                  + "; vs the CPU per step "
                  + " ".join(f"{v:.1e}" for v in errs)
                  + f" (gate {LM_LOSS_GATE:g}); completed "
                  f"{card['report']['completed']} / "
                  f"{cpu['report']['completed']}; card launches "
                  + ", ".join(f"{k}={v}" for k, v in card["counts"].items()
                              if v), flush=True)
            if len(card["losses"]) != train_steps or \
                    not card["report"]["completed"] or \
                    not max(errs) < LM_LOSS_GATE:
                raise AssertionError(f"{arch} train_main --smoke: the card's "
                                     f"losses {max(errs):.3e} from the CPU's")
        return total
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# 14b. the encoder-decoder trunk and the patch prefix (whisper, pixtral)
# ---------------------------------------------------------------------------

def whisper_decode_path(device="cuda") -> dict:
    """whisper-base at published widths and full depth, fp32: a batch of
    WHISPER_B with 1,500 random frames, prefill of a WHISPER_PROMPT-token
    prompt and WHISPER_STEPS teacher-forced decode steps
    (``teacher_forced_decode``; 18 flash launches a prefill: 6 encoder, 6
    self, 6 cross); then the same weights in bf16, timed."""
    cfg = configs.get_config(WHISPER_ARCH).scaled(dtype="float32")
    api = get_api(cfg)
    gen = torch.Generator().manual_seed(SEED + 18)
    t0 = time.perf_counter()
    params = api.init_params(gen, device)
    T = WHISPER_PROMPT + WHISPER_STEPS
    tokens = torch.randint(3, cfg.vocab, (WHISPER_B, T), generator=gen
                           ).to(device)
    frames = torch.randn((WHISPER_B, cfg.enc_seq, cfg.enc_d_model),
                         generator=gen).to(device)
    init_s = time.perf_counter() - t0
    print(f"  {cfg.enc_layers} + {cfg.n_layers} layers, fp32, "
          f"{n_params(params):,} params drawn in {init_s:.1f} s; frames "
          f"{tuple(frames.shape)}", flush=True)
    total = {}
    out = teacher_forced_decode("whisper-base fp32", cfg, params, tokens,
                                WHISPER_PROMPT, {"frames": frames},
                                device=device)
    add_counts(total, out["counts"])
    cfg16 = cfg.scaled(dtype="bfloat16")
    params = tree_map(lambda t: t.to(torch.bfloat16), params)
    timed = timed_decode("whisper-base bf16", cfg16, params,
                         tokens[:, :WHISPER_PROMPT],
                         {"frames": frames.to(torch.bfloat16)},
                         WHISPER_TIMED_TOKENS, device=device)
    add_counts(total, timed["counts"])
    del params
    return {"counts": total, "decode_ms": out["decode_ms"],
            "bf16": timed}


def pixtral_decode_path(device="cuda") -> dict:
    """pixtral-12b at published widths, PIXTRAL_LAYERS of 40 layers, fp32
    (one draw of 2,432,742,400 parameters): a PIXTRAL_B batch of 256
    random patch embeddings and a PIXTRAL_PROMPT-token prompt, prefill
    with ``max_len`` counting the prefix, PIXTRAL_STEPS teacher-forced
    decode steps (``teacher_forced_decode``; a flash launch a layer); then
    the same weights cast to bf16, timed."""
    cfg = configs.get_config(PIXTRAL_ARCH).scaled(n_layers=PIXTRAL_LAYERS,
                                                  dtype="float32")
    api = get_api(cfg)
    gen = torch.Generator().manual_seed(SEED + 19)
    t0 = time.perf_counter()
    params = api.init_params(gen, device)
    P, T = cfg.n_patches, PIXTRAL_PROMPT + PIXTRAL_STEPS
    tokens = torch.randint(3, cfg.vocab, (PIXTRAL_B, T), generator=gen
                           ).to(device)
    prefix = torch.randn((PIXTRAL_B, P, cfg.d_model), generator=gen
                         ).to(device)
    if device == "cuda":
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    m = n_params(params)
    print(f"  {cfg.n_layers} of 40 layers, fp32, {m:,} params "
          f"({m * 4 / 1e9:.2f} GB) drawn in {init_s:.1f} s; prefix "
          f"{tuple(prefix.shape)}", flush=True)
    total = {}
    out = teacher_forced_decode("pixtral-12b fp32", cfg, params, tokens,
                                PIXTRAL_PROMPT, {"prefix_embeds": prefix},
                                offset=P, device=device)
    add_counts(total, out["counts"])
    cfg16 = cfg.scaled(dtype="bfloat16")
    params = tree_map(lambda t: t.to(torch.bfloat16), params)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    timed = timed_decode("pixtral-12b bf16", cfg16, params,
                         tokens[:, :PIXTRAL_PROMPT],
                         {"prefix_embeds": prefix.to(torch.bfloat16)},
                         PIXTRAL_TIMED_TOKENS, offset=P, device=device)
    add_counts(total, timed["counts"])
    if device == "cuda":
        print(f"  peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
              flush=True)
    del params
    return {"counts": total, "decode_ms": out["decode_ms"], "m": m,
            "bf16": timed}


def whisper_trainer_path(device="cuda") -> dict:
    """whisper-base's NGD trainer at published widths and full depth, at
    ``train_main``'s defaults (bf16, batch 8, seq 64, λ 1e-3, lr 0.05; n =
    8): TRAIN_STEPS exact dense steps through ``ops.chol_solve_fused``
    against the same steps on the plain versions
    (``kernel_vs_plain_steps``); gram_sv, the Cholesky, the substitution
    and ngd_apply each launched."""
    cfg = configs.get_config(WHISPER_ARCH)
    counts = dict.fromkeys(ops.launch_counts(), 0)
    routes = dict.fromkeys(GRAM_ROUTES, 0)
    kern = kernel_vs_plain_steps(cfg, "dense", TRAIN_STEPS, device=device,
                                 counts=counts, routes=routes)
    for kname in ("gram_sv", "cholesky", "trisolve", "ngd_apply"):
        require_launches("whisper-base NGD trainer", counts, kname)
    del kern
    SEEDED.clear()
    gc.collect()
    return {"counts": counts}


# ---------------------------------------------------------------------------
# 13b. the NGD trainer on the LM (build_trainer, the Algorithm-1 kernels)
# ---------------------------------------------------------------------------

class FirstSolve:
    """A solver that keeps its first call's operands and result, (S, v,
    x, λ), for the residual check after the step; ``take`` hands them
    over once."""

    takes_sharded = True        # passes a ShardedScores on to its solver

    def __init__(self, solver):
        self.solver, self.first, self.armed = solver, None, True

    def __call__(self, S, v, lam):
        x = self.solver(S, v, lam)
        if self.armed:
            self.first, self.armed = (S, v, x, float(lam)), False
        return x

    def take(self):
        first, self.first = self.first, None
        return first


def natgrad64(S, v, x, lam: float, chunk: int = 1 << 25) -> dict:
    """x against the system it solves, in float64 over column chunks (2 GB
    of float64 at a time at n = 8); S dense or blocked, v and x flat or per
    block. ``residual``: ‖(SᵀS + λI)x − v‖/‖v‖; ``exact``: x64 = (v −
    Sᵀ(SSᵀ + λI)⁻¹Sv)/λ in float64 and ``err``, max |x − x64| / max |x64|;
    ``exact_residual``, x64's own residual; ``off``: ‖v − P v‖/‖v‖, P the
    projector onto the rows of S (v's part that x64 carries as itself/λ);
    ``off_share``: ‖v − P v‖/λ over ‖x64‖."""
    blocks = S.blocks if is_blocked(S) else (S,)
    widths = [b.shape[1] for b in blocks]

    def pieces(t):
        return tuple(t) if isinstance(t, (tuple, list)) \
            else torch.split(t, widths)

    chunks = [(b[:, j:j + chunk], vp[j:j + chunk], xp[j:j + chunk])
              for b, vp, xp in zip(blocks, pieces(v), pieces(x))
              for j in range(0, b.shape[1], chunk)]
    n = blocks[0].shape[0]
    W = torch.zeros((n, n), dtype=torch.float64, device=blocks[0].device)
    u = torch.zeros((n,), dtype=torch.float64, device=W.device)
    Sx = torch.zeros((n,), dtype=torch.float64, device=W.device)
    for b, vp, xp in chunks:
        b64 = b.double()
        W += b64 @ b64.T
        u += b64 @ vp.double()
        Sx += b64 @ xp.double()
    w = torch.linalg.solve(W + lam * torch.eye(n, dtype=W.dtype,
                                               device=W.device), u)
    # S·x64 = (Sv − W·w)/λ, so x64's residual needs no second pass for it
    Sx64 = (u - W @ w) / lam
    acc = dict.fromkeys(("r2", "r2_64", "v2", "x2_64", "d", "big"), 0.0)
    for b, vp, xp in chunks:
        b64, v64, x_ = b.double(), vp.double(), xp.double()
        x64 = (v64 - b64.T @ w) / lam
        acc["r2"] += float((b64.T @ Sx + lam * x_ - v64).square().sum())
        acc["r2_64"] += float((b64.T @ Sx64 + lam * x64 - v64).square().sum())
        acc["v2"] += float(v64.square().sum())
        acc["x2_64"] += float(x64.square().sum())
        acc["d"] = max(acc["d"], float((x_ - x64).abs().max()))
        acc["big"] = max(acc["big"], float(x64.abs().max()))
    off2 = max(acc["v2"] - float(u @ torch.linalg.solve(W, u)), 0.0)
    return {"residual": (acc["r2"] / acc["v2"]) ** 0.5,
            "exact_residual": (acc["r2_64"] / acc["v2"]) ** 0.5,
            "err": acc["d"] / max(acc["big"], 1e-300),
            "off": (off2 / acc["v2"]) ** 0.5,
            "off_share": (off2 / acc["x2_64"]) ** 0.5 / lam}


SEEDED: dict = {}


def seed_params(cfg, device: str):
    """The weights ``build_trainer`` draws from SEED for ``cfg`` (the CPU
    generator, then the device), drawn once and shared by the trainer
    phases: a draw of the 2-layer LM takes ≈ 4 s of the host, and no step
    writes into its parameters. Holds one model; ``SEEDED.clear()`` drops
    it."""
    key = (cfg, device)
    if key not in SEEDED:
        SEEDED.clear()
        SEEDED[key] = get_api(cfg).init_params(
            torch.Generator().manual_seed(SEED), device)
    return SEEDED[key]


def add_launches(counts: dict, routes: dict) -> None:
    """Add the launches since the last reset, by kernel and by Gram route."""
    for key, n in ops.launch_counts().items():
        counts[key] += n
    for key, n in GRAM_ROUTES.items():
        routes[key] += n


def train_run(cfg, label: str, steps: int, *, solver="chol",
              blocked: bool = False, curvature: str = "exact",
              damping: float = TRAIN_LAM,
              device: str = "cuda", counts=None, routes=None,
              ckpt_dir=None, save_at=None) -> dict:
    """``steps`` steps of ``build_trainer``'s NGD step_fn from the seed's
    weights. Times each step (host clock, ended by a sync) and, for the
    exact solve, checks step 0's natural gradient on its own S and v in
    float64 (``natgrad64``); takes step 0's batch's loss at the seed's weights and
    after the last step (``held``), and how many weights moved.
    ``counts``/``routes`` (dicts) receive the steps' kernel launches and
    the Gram's routes; ``save_at``: save the state after that step to
    ``ckpt_dir`` and return it."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    first = FirstSolve(solver) if curvature == "exact" else None
    init_state, step_fn, save_state, restore_state, data = build_trainer(
        cfg, optimizer_name="ngd", lr=TRAIN_LR, damping=damping,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, total_steps=steps,
        solver=first or solver, blocked=blocked, curvature=curvature,
        curvature_refresh=TRAIN_REFRESH, seed=SEED,
        params=seed_params(cfg, device), device=device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = init_state()
    api, batch0 = get_api(cfg), batch_to(data.batch_at(0), device)
    with torch.no_grad():
        p0 = [t.clone() for t in leaves(state["params"])]
        held = [float(api.loss(state["params"], batch0)[0])]
    out = {"losses": [], "ms": [], "natgrad": None, "saved": None,
           "step_fn": step_fn, "restore_state": restore_state}
    for s in range(steps):
        sync()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, s)
        loss = float(metrics["loss"])
        sync()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(loss)
        if counts is not None:
            add_launches(counts, routes)
        if first is not None and first.first is not None:
            out["natgrad"] = natgrad64(*first.take())
        if save_at == s:
            save_state(ckpt_dir, s, state)
            out["saved"] = state
    out["metrics"], out["state"] = metrics, state
    out["peak"] = torch.cuda.max_memory_allocated() if device == "cuda" \
        else None
    with torch.no_grad():
        held.append(float(api.loss(state["params"], batch0)[0]))
        moved = sum(int((a != b).sum()) for a, b in
                    zip(leaves(state["params"]), p0))
        big = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(leaves(state["params"]), p0))
    del p0
    out["held"] = held
    print(f"  {label}: loss " + " ".join(f"{x:.6f}" for x in out["losses"])
          + "; step ms " + " ".join(f"{x:.1f}" for x in out["ms"])
          + ("" if out["natgrad"] is None else
             "; step 0's natural gradient: float64 residual {residual:.3e} "
             "(the float64 solve's {exact_residual:.3e}), {err:.3e} from "
             "the float64 solve; v off the rows of S {off:.3e}, that part "
             "/λ is {off_share:.3f} of the float64 solve's norm"
             .format(**out["natgrad"]))
          + f"; step 0's batch: loss {held[0]:.6f} at the seed's weights, "
          f"{held[1]:.6f} after the last step; {moved:,} weights moved, by "
          f"at most {big:.3e}"
          + (f"; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
             if device == "cuda" else ""), flush=True)
    if not all(np.isfinite(out["losses"])):
        raise AssertionError(f"{label}: losses not finite")
    return out


def kernel_vs_plain_steps(cfg, part: str, steps: int, *, blocked=False,
                          device="cuda", counts=None, routes=None,
                          ckpt_dir=None, save_at=None) -> dict:
    """``steps`` exact NGD steps through ``ops.chol_solve_fused`` (its
    launches into ``counts``/``routes``), then the same steps on the plain
    versions: the losses within TRAIN_LOSS_GATE, step 0's natural gradient
    against the float64 solve of its own S and v no worse than the plain
    route's plus TRAIN_RES_GATE. Returns the kernel run (its state
    dropped) and the parameter count ``m``."""
    plain = functools.partial(ops.chol_solve_fused, mode="ref")
    kern = train_run(cfg, f"({part}) kernels", steps,
                     solver=ops.chol_solve_fused, blocked=blocked,
                     device=device, counts=counts, routes=routes,
                     ckpt_dir=ckpt_dir, save_at=save_at)
    m = sum(t.numel() for t in leaves(kern.pop("state")["params"]))
    print(f"  m = {m:,} parameters, n = {TRAIN_BATCH} samples, S "
          f"{TRAIN_BATCH}x{m} {cfg.dtype} "
          f"({TRAIN_BATCH * m * cfg.param_dtype.itemsize / 1e9:.2f} GB)",
          flush=True)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    ref = train_run(cfg, f"({part}) plain versions", steps, solver=plain,
                    blocked=blocked, device=device)
    ref.pop("state")
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip(kern["losses"], ref["losses"]))
    kn, pn = kern["natgrad"], ref["natgrad"]
    print(f"  ({part}) kernels vs plain: worst loss {loss_err:.2e} (gate "
          f"{TRAIN_LOSS_GATE:g}); step 0's natural gradient: residual "
          f"{kn['residual']:.3e} against {pn['residual']:.3e}, from the "
          f"float64 solve {kn['err']:.3e} against {pn['err']:.3e} (gates: "
          f"≤ plain + {TRAIN_RES_GATE:g}); step 0's batch's loss "
          f"{kern['held'][0]:.6f} → {kern['held'][1]:.6f} (plain → "
          f"{ref['held'][1]:.6f})", flush=True)
    if not loss_err < TRAIN_LOSS_GATE:
        raise AssertionError(f"{cfg.name} trainer ({part}): losses "
                             f"{loss_err:.3e} from the plain route")
    for key in ("residual", "err"):
        if not kn[key] <= pn[key] + TRAIN_RES_GATE:
            raise AssertionError(f"{cfg.name} trainer ({part}): natural "
                                 f"gradient {key} {kn[key]:.3e}, plain "
                                 f"{pn[key]:.3e}")
    del ref
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return {**kern, "m": m}


def lm_trainer_path(cfg, device: str = "cuda") -> dict:
    """The NGD trainer on the LM (ROADMAP A1): (a) exact dense S through
    ``ops.chol_solve_fused`` against the same steps on the plain versions,
    (b) the same blocked, (c) the streaming curvature policy, (d) a
    checkpoint round trip; one profiled step. Returns the kernel launches
    of the kernel-route steps (``counts``), the parameter count m and the
    dense and blocked kernel runs' losses, step ms and step 0's natural
    gradient against float64 (``one``, the mesh phase's reference)."""
    counts = dict.fromkeys(ops.launch_counts(), 0)
    routes = dict.fromkeys(GRAM_ROUTES, 0)
    ckpt_dir = Path(__file__).resolve().parent / "build" / "lm_trainer_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    m = None
    runs = {}
    for part, steps, blocked in (("dense", TRAIN_STEPS, False),
                                 ("blocked", TRAIN_BLOCKED_STEPS, True)):
        kern = kernel_vs_plain_steps(cfg, part, steps, blocked=blocked,
                                     device=device, counts=counts,
                                     routes=routes, ckpt_dir=ckpt_dir,
                                     save_at=1 if part == "dense" else None)
        m = m or kern["m"]
        runs[part] = kern

    stream = train_run(cfg, f"(streaming, refresh every {TRAIN_REFRESH}, "
                       f"λ = {TRAIN_STREAM_LAM:g})", TRAIN_STREAM_STEPS,
                       curvature="streaming", damping=TRAIN_STREAM_LAM,
                       device=device)
    got = (stream["metrics"]["curvature_refreshes"],
           stream["metrics"]["curvature_hits"])
    print(f"  (streaming) refreshes {got[0]}, hits {got[1]} (expected "
          f"{TRAIN_STREAM_EXPECT})", flush=True)
    if got != TRAIN_STREAM_EXPECT:
        raise AssertionError(f"LM trainer (streaming): refreshes, hits {got}")
    runs_stream = {key: stream[key] for key in ("losses", "ms")}
    del stream
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # (d) the checkpoint saved after step 1 of the dense kernel run
    dense = runs["dense"]
    restored = dense["restore_state"](ckpt_dir, 1)
    same = all(a.dtype == b.dtype and torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
        if isinstance(a, torch.Tensor) else a == b
        for a, b in zip(leaves(restored), leaves(dense["saved"])))
    dense.pop("saved")
    ops.reset_launch_counts()
    _, metrics = dense["step_fn"](restored, 2)
    loss2 = float(metrics["loss"])
    add_launches(counts, routes)
    err = abs(loss2 - dense["losses"][2]) / abs(dense["losses"][2])
    print(f"  (checkpoint) restored leaves bit-equal to the saved ones: "
          f"{same}; step 2 from the checkpoint: loss {loss2:.6f} against "
          f"{dense['losses'][2]:.6f} uninterrupted ({err:.2e}, gate "
          f"{TRAIN_LOSS_GATE:g})", flush=True)
    if not same or not err < TRAIN_LOSS_GATE:
        raise AssertionError("LM trainer: the checkpoint round trip differs")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if device == "cuda":
        profile_gram_path("one LM NGD step (exact, dense, kernels)",
                          lambda: dense["step_fn"](restored, 2))
        require_tensor_core_gram("LM NGD trainer", routes)
    one = {part: {key: run[key] for key in ("losses", "ms", "natgrad")}
           for part, run in runs.items()}
    one["streaming"] = runs_stream
    peak = dense["peak"]
    del restored, runs, dense
    gc.collect()
    return {"counts": counts, "m": m, "one": one, "peak": peak}


# ---------------------------------------------------------------------------
# 13f. the NGD trainer over a mesh of the card (ROADMAP A7's training half)
# ---------------------------------------------------------------------------

def slab_view(S, v, x):
    """A ``ShardedScores``'s slabs as one ``BlockedScores`` in column order
    (block-major, then position), v and x cut the same way: what
    ``natgrad64`` reads. No copy: the slabs lie on the one card."""
    v_blocks = tuple(v) if S.blocked else (v,)
    x_blocks = tuple(x) if S.blocked else (x,)
    blocks, vs, xs = [], [], []
    for b in range(len(S.slabs[0])):
        widths = [slab[b].shape[1] for slab in S.slabs]
        blocks += [slab[b] for slab in S.slabs]
        vs += torch.split(v_blocks[b], widths)
        xs += torch.split(x_blocks[b], widths)
    return BlockedScores(blocks), tuple(vs), tuple(xs)


def mesh_train_run(cfg, mesh, layout: dict, steps: int, total_steps: int,
                   device: str = "cuda", check: bool = True,
                   damping: float = TRAIN_LAM, curvature=None) -> dict:
    """``steps`` NGD steps of ``make_ngd_train_step`` over ``mesh``
    (``layout``: its keywords) from the seed's weights, as
    ``build_trainer``'s NGD at train_main's defaults with a
    ``total_steps`` schedule: exact through ``ops.chol_solve_fused``, or
    under a ``curvature`` policy. Returns the losses, step ms (host clock,
    ended by a sync), each step's launches, the last metrics, the final
    params, the peak and (``check``, exact) step 0's natural gradient
    against float64 on its own slabs."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    api = get_api(cfg)
    data = SyntheticLM(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=SEED)
    first = FirstSolve(ops.chol_solve_fused)
    opt = NaturalGradient(
        warmup_cosine(TRAIN_LR, warmup_steps=max(total_steps // 20, 1),
                      total_steps=total_steps),
        damping=damping, solver=first if check else ops.chol_solve_fused,
        curvature=curvature)
    params = seed_params(cfg, device)
    state = opt.init(params)
    step = make_ngd_train_step(api, opt, mesh, **layout)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {"losses": [], "ms": [], "counts": [], "natgrad": None}
    for s_ in range(steps):
        sync()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, data.batch_at(s_))
        out["losses"].append(float(metrics["loss"]))
        sync()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["counts"].append(ops.launch_counts())
        if first.first is not None:
            S, v, x, lam = first.take()
            out["natgrad"] = natgrad64(*slab_view(S, v, x), lam)
            del S, v, x
    out["peak"] = torch.cuda.max_memory_allocated() / 1e9 \
        if device == "cuda" else 0.0
    out["params"], out["metrics"] = params, metrics
    return out


def expected_mesh_launches(blocks: int) -> dict:
    """A step's launches over a (data, model) mesh: one ``gram_sv`` and one
    ``ngd_apply`` a column slab of every block, one ``cholesky`` and one
    substitution."""
    slabs = MESH_SHAPE[1] * blocks
    return {"gram_sv": slabs, "ngd_apply": slabs, "cholesky": 1,
            "trisolve": 1}


def mesh_layouts_path(cfg, one: dict, device: str = "cuda") -> dict:
    """(a) Each layout's MESH_STEPS steps against the one-position kernel
    run (``one``: ``lm_trainer_path``'s), gated as the constants say, then
    a rerun bit for bit. Returns each layout's launches (first runs)."""
    mesh = make_mesh(MESH_SHAPE, ("data", "model"), device=device)
    out = {}
    for name, layout in MESH_LAYOUTS.items():
        part = "blocked" if layout.get("blocked") else "dense"
        total = TRAIN_BLOCKED_STEPS if part == "blocked" else TRAIN_STEPS
        run = mesh_train_run(cfg, mesh, layout, MESH_STEPS, total, device)
        again = mesh_train_run(cfg, mesh, layout, MESH_STEPS, total, device,
                               check=False)
        same = run["losses"] == again["losses"] and all(
            torch.equal(a, b) for a, b in zip(leaves(run["params"]),
                                             leaves(again["params"])))
        blocks = len(leaves(run["params"])) if part == "blocked" else 1
        want = expected_mesh_launches(blocks)
        counts = {}
        for c in run["counts"]:
            add_counts(counts, c)
        ref, ng, ng1 = one[part], run["natgrad"], one[part]["natgrad"]
        errs = [abs(a - b) / abs(b) for a, b in
                zip(run["losses"], ref["losses"])]
        print(f"  ({name}) loss " + " ".join(
            f"{x:.6f}" for x in run["losses"]) + " (one position "
            + " ".join(f"{x:.6f}" for x in ref["losses"][:MESH_STEPS])
            + f"; worst {max(errs):.2e}, gate {TRAIN_LOSS_GATE:g}); step ms "
            + " ".join(f"{x:.1f}" for x in run["ms"]) + " (rerun "
            + " ".join(f"{x:.1f}" for x in again["ms"]) + "; one position "
            + " ".join(f"{x:.1f}" for x in ref["ms"][:MESH_STEPS])
            + f"); step 0's natural gradient {ng['err']:.3e} from the "
            f"float64 solve (one position {ng1['err']:.3e}; gate ≤ that + "
            f"{TRAIN_RES_GATE:g}), residual {ng['residual']:.3e} (one "
            f"position {ng1['residual']:.3e}; printed: rounding leads it at "
            f"λ = {TRAIN_LAM:g}); launches a step "
            + ", ".join(f"{k}={v}" for k, v in run["counts"][0].items()
                        if v)
            + f" (expected {want}); peak {run['peak']:.2f} GB; rerun bit "
            f"for bit: {same}", flush=True)
        if not max(errs) < TRAIN_LOSS_GATE or not same:
            raise AssertionError(f"mesh trainer ({name}): losses "
                                 f"{max(errs):.3e} from one position, "
                                 f"rerun equal {same}")
        if not ng["err"] <= ng1["err"] + TRAIN_RES_GATE:
            raise AssertionError(f"mesh trainer ({name}): natural gradient "
                                 f"{ng['err']:.3e} from float64, one "
                                 f"position {ng1['err']:.3e}")
        if device == "cuda":
            for c in run["counts"]:
                for kname, n in want.items():
                    require_launches(f"mesh trainer ({name})", c, kname, n)
        out[name] = counts
        del run, again
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    out["streaming"] = mesh_streaming_run(cfg, mesh, one["streaming"],
                                          device)
    return out


def mesh_streaming_run(cfg, mesh, one: dict, device: str = "cuda") -> dict:
    """The streaming policy over the mesh (1d), as the one-position
    streaming run (λ = TRAIN_STREAM_LAM, a refresh every TRAIN_REFRESH):
    its losses within TRAIN_LOSS_GATE of ``one``'s, the same refreshes and
    hits; a refresh launches one ``gram_sv`` a slab, a hit one
    ``sv_cross`` a slab, every step one ``ngd_apply`` a slab, one
    ``cholesky`` and one substitution. Returns its launches."""
    policy = StreamingCurvature(TRAIN_BATCH, refresh_every=TRAIN_REFRESH,
                                device=device)
    run = mesh_train_run(cfg, mesh, {}, TRAIN_STREAM_STEPS,
                         TRAIN_STREAM_STEPS, device, check=False,
                         damping=TRAIN_STREAM_LAM, curvature=policy)
    counts = {}
    for c in run["counts"]:
        add_counts(counts, c)
    got = (run["metrics"]["curvature_refreshes"],
           run["metrics"]["curvature_hits"])
    errs = [abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                one["losses"])]
    slabs, steps = MESH_SHAPE[1], TRAIN_STREAM_STEPS
    want = {"gram_sv": slabs * got[0], "sv_cross": slabs * got[1],
            "ngd_apply": slabs * steps, "cholesky": steps,
            "trisolve": steps}
    print(f"  (1d, streaming, refresh every {TRAIN_REFRESH}, λ = "
          f"{TRAIN_STREAM_LAM:g}) loss " + " ".join(
              f"{x:.6f}" for x in run["losses"]) + " (one position "
          + " ".join(f"{x:.6f}" for x in one["losses"])
          + f"; worst {max(errs):.2e}, gate {TRAIN_LOSS_GATE:g}); step ms "
          + " ".join(f"{x:.1f}" for x in run["ms"]) + " (one position "
          + " ".join(f"{x:.1f}" for x in one["ms"]) + f"); refreshes, "
          f"hits {got} (expected {TRAIN_STREAM_EXPECT}); launches "
          + ", ".join(f"{k}={v}" for k, v in counts.items() if v)
          + f" (expected {want}); peak {run['peak']:.2f} GB", flush=True)
    if got != TRAIN_STREAM_EXPECT or not max(errs) < TRAIN_LOSS_GATE:
        raise AssertionError(f"mesh trainer (streaming): {got}, losses "
                             f"{max(errs):.3e} from one position")
    if device == "cuda":
        for kname, n in want.items():
            require_launches("mesh trainer (streaming)", counts, kname, n)
    return counts


def hybrid_path(cfg, device: str = "cuda") -> dict:
    """(b) One ``HybridNGD`` step, NGD on the embedding table through
    ``ops.chol_solve_fused`` and AdamW on the rest: its update against
    ``NaturalGradient`` on the subset alone and ``AdamW`` on the rest,
    bit for bit. Returns the hybrid step's launches."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    api = get_api(cfg)
    keep = (lambda path: path == "embed")
    params = seed_params(cfg, device)
    batch = batch_to(SyntheticLM(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                 seed=SEED).batch_at(0), device)
    grads, _ = grad_and_value(api.loss, has_aux=True)(params, batch)
    t0 = time.perf_counter()
    S = per_sample_scores(
        lambda pw, ex: api.sample_logp({**params, **pw}, ex),
        {"embed": params["embed"]}, batch)
    sync()
    score_ms = (time.perf_counter() - t0) * 1e3

    def ngd():
        return NaturalGradient(TRAIN_LR, damping=TRAIN_LAM,
                               solver=ops.chol_solve_fused)

    hyb = HybridNGD(keep, ngd=ngd(), adamw=AdamW(3e-3))
    hstate = hyb.init(params)
    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    upd, _ = hyb.update(grads, hstate, params, scores=S)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    gsel, grest = partition_params(grads, keep)
    psel, prest = partition_params(params, keep)
    alone, adamw = ngd(), AdamW(3e-3)
    usel, _ = alone.update(gsel, alone.init(psel), psel, scores=S)
    urest, _ = adamw.update(grest, adamw.init(prest), prest)
    want = merge_params(usel, urest)
    same = all(torch.equal(a, b) for a, b in zip(leaves(upd), leaves(want)))
    moved = float(upd["embed"].float().abs().max())
    s_gb = S.numel() * S.element_size() / 1e9
    print(f"  (hybrid) NGD on embed {tuple(params['embed'].shape)} (S "
          f"{tuple(S.shape)} {S.dtype}, {s_gb:.2f} GB, score pass "
          f"{score_ms:.1f} ms), AdamW on the other "
          f"{len(leaves(params)) - 1} leaves: update {ms:.1f} ms, launches "
          + ", ".join(f"{k}={v}" for k, v in counts.items() if v)
          + f"; bit for bit the two optimizers alone: {same}; embed moved "
          f"by at most {moved:.3e}"
          + (f"; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
             if device == "cuda" else ""), flush=True)
    if not same or not np.isfinite(moved) or moved == 0.0:
        raise AssertionError("HybridNGD: the update is not its two halves")
    if device == "cuda":
        for kname in ("gram_sv", "cholesky", "trisolve", "ngd_apply"):
            require_launches("HybridNGD step", counts, kname, 1)
    return counts


def compress_path(cfg, device: str = "cuda") -> None:
    """(c) ``bf16_allreduce`` and one ``Int8ErrorFeedback`` step over the
    LM's gradient in MESH_DP data-parallel pieces of the batch: bf16
    within COMPRESS_GATE of the fp32 sum relative to its max, and both
    (the int8 residuals too) within COMPRESS_CPU_GATE of the CPU's."""
    api = get_api(cfg)
    params = seed_params(cfg, device)
    batch = SyntheticLM(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                        seed=SEED).batch_at(0)
    step = TRAIN_BATCH // MESH_DP
    grad = grad_and_value(api.loss, has_aux=True)
    pos = [grad(params, batch_to({k: v[i * step:(i + 1) * step]
                                  for k, v in batch.items()}, device))[0]
           for i in range(MESH_DP)]
    del params
    host = [tree_map(lambda t: t.cpu(), g) for g in pos]
    comp = Int8ErrorFeedback()
    worst = {"bf16": 0.0, "bf16_cpu": 0.0, "int8": 0.0, "int8_cpu": 0.0,
             "res_cpu": 0.0}
    t0 = time.perf_counter()
    bf = bf16_allreduce(pos)
    q, qst = comp.allreduce(pos, [comp.init(g) for g in pos])
    if device == "cuda":
        torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bf_cpu = bf16_allreduce(host)
    q_cpu, qst_cpu = comp.allreduce(host, [comp.init(g) for g in host])
    cpu_s = time.perf_counter() - t0
    big = 0.0

    def gap(a, b) -> float:          # the CPU's result compared on a's device
        return float((a - b.to(a.device)).abs().max())

    for i, parts in enumerate(zip(*(leaves(g) for g in pos))):
        exact = parts[0].float().clone()
        for p_ in parts[1:]:
            exact += p_.float()
        big = max(big, float(exact.abs().max()))
        worst["bf16"] = max(worst["bf16"], gap(leaves(bf)[i], exact))
        worst["int8"] = max(worst["int8"], gap(leaves(q)[i], exact))
        worst["bf16_cpu"] = max(worst["bf16_cpu"],
                                gap(leaves(bf)[i], leaves(bf_cpu)[i]))
        worst["int8_cpu"] = max(worst["int8_cpu"],
                                gap(leaves(q)[i], leaves(q_cpu)[i]))
        for a, b in zip(qst, qst_cpu):
            worst["res_cpu"] = max(worst["res_cpu"], gap(
                leaves(a.residual)[i], leaves(b.residual)[i]))
        del exact
    rel = {k: v / max(big, 1e-30) for k, v in worst.items()}
    print(f"  (compression) {MESH_DP} pieces of the gradient "
          f"({sum(t.numel() for t in leaves(bf)):,} values): bf16 "
          f"{rel['bf16']:.3e} from the fp32 sum relative to its max (gate "
          f"{COMPRESS_GATE:g}), int8 + error feedback {rel['int8']:.3e}; "
          f"card vs CPU: bf16 {rel['bf16_cpu']:.3e}, int8 "
          f"{rel['int8_cpu']:.3e}, residuals {rel['res_cpu']:.3e} (gate "
          f"{COMPRESS_CPU_GATE:g}); {card_s:.2f} s on the card, "
          f"{cpu_s:.2f} s on the CPU", flush=True)
    if not rel["bf16"] < COMPRESS_GATE or not np.isfinite(rel["int8"]) or \
            not max(rel["bf16_cpu"], rel["int8_cpu"],
                    rel["res_cpu"]) < COMPRESS_CPU_GATE:
        raise AssertionError(f"compressed all-reduce: {rel}")


def mesh_cli_path() -> dict:
    """(d) ``train_main --smoke --optimizer {ngd, adamw} --mesh-shape 2,2
    --steps MESH_CLI_STEPS`` with every position on the card, and on the
    CPU: every step's loss within TRAIN_LOSS_GATE. Returns the card runs'
    launches."""
    tmp = tempfile.mkdtemp(prefix="mesh_cli_")
    total = {}
    try:
        for optimizer in ("ngd", "adamw"):
            runs = {}
            for dev in ("cuda", "cpu"):
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                losses, report = train_main(
                    ["--arch", LM_ARCH, "--smoke", "--device", dev,
                     "--optimizer", optimizer, "--mesh-shape", "2,2",
                     "--steps", str(MESH_CLI_STEPS), "--ckpt-dir",
                     os.path.join(tmp, f"{optimizer}_{dev}")])
                if dev == "cuda":
                    torch.cuda.synchronize()
                runs[dev] = {"losses": losses, "report": report,
                             "wall": time.perf_counter() - t0,
                             "counts": ops.launch_counts()}
            card, cpu = runs["cuda"], runs["cpu"]
            add_counts(total, card["counts"])
            errs = [abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                                        cpu["losses"])]
            print(f"  train_main --smoke --optimizer {optimizer} --mesh-shape "
                  f"2,2: card {card['wall']:.1f} s, CPU {cpu['wall']:.1f} s; "
                  "losses on the card " + " ".join(
                      f"{v:.6g}" for v in card["losses"])
                  + "; vs the CPU per step " + " ".join(
                      f"{v:.1e}" for v in errs)
                  + f" (gate {TRAIN_LOSS_GATE:g}); card launches "
                  + ", ".join(f"{k}={v}" for k, v in card["counts"].items()
                              if v), flush=True)
            if len(card["losses"]) != MESH_CLI_STEPS or \
                    not card["report"]["completed"] or \
                    not max(errs) < TRAIN_LOSS_GATE:
                raise AssertionError(f"train_main --mesh-shape 2,2 "
                                     f"({optimizer}): {max(errs):.3e}")
        require_launches("train_main --mesh-shape 2,2 (ngd)", total,
                         "gram_sv", MESH_SHAPE[1] * MESH_CLI_STEPS)
        return total
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def mesh_trainer_path(cfg, one: dict) -> dict:
    """The phase: (a) the layouts, (b) HybridNGD, (c) compression, (d) the
    CLI. Returns the launches of (a), (b) and (d) by label."""
    print(f"  {device_line()}: the four positions share this card, so the "
          "times check agreement and launches, not multi-card speed",
          flush=True)
    t0 = time.perf_counter()
    paths = {f"mesh trainer, {k}": v
             for k, v in mesh_layouts_path(cfg, one).items()}
    times = {"layouts": time.perf_counter() - t0}
    for part, run in (("HybridNGD", lambda: hybrid_path(cfg)),
                      ("compression", lambda: compress_path(cfg)),
                      ("train_main", mesh_cli_path)):
        t0 = time.perf_counter()
        counts = run()
        times[part] = time.perf_counter() - t0
        if counts is not None:
            paths[f"mesh trainer, {part}"] = counts
        gc.collect()
        torch.cuda.empty_cache()
    SEEDED.clear()
    print("  the parts' seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in times.items()), flush=True)
    return paths


# ---------------------------------------------------------------------------
# 12. times and bounds at the main-path shape
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# 13g. the dry run against the card (ROADMAP A9)
# ---------------------------------------------------------------------------

# The dry run's predictions held to the card's own readings of the same
# calls. Memory: the card's peak over the call (max_memory_allocated,
# less what other phases left allocated) ÷ the meta trace's resident
# bytes (arguments + the high-water mark of what the call allocates) on a
# one-position mesh; the caching allocator rounds each block up to 512
# bytes, so [0.8, 1.25] for a single solve and [0.5, 2.0] for the LM
# trainer's phase, whose peak spans three steps, step 0's float64 check
# and the allocator's reuse across them. Time: the call (CUDA events) may
# not beat 0.95 × the roofline's bound of the trace's operations and
# bytes at the H100 SXM's peaks (``hlo_analysis.HW``): a faster reading
# would mean wrong peaks or wrong counts.
DRY_SOLVE_GATE, DRY_TRAINER_GATE, DRY_TIME_GATE = (0.8, 1.25), (0.5, 2.0), 0.95
# full-width cells (ROADMAP A9): the reference's slow test's cell, the
# largest model's train cell and the paper-scale solver on the multi-pod
# mesh, traced on meta in this process
DRY_CELLS = (("whisper-base", "decode_32k", "multi", None),
             ("qwen3-moe-235b-a22b", "train_4k", "single", None),
             (None, None, "multi", (4096, 1_000_000)))
DRY_CARD_BYTES = 80 * 2 ** 30           # the card's 80 GB of device memory
# the ported quickstart at its defaults; the reference's checks
# (tests/test_examples.py:24-33)
QUICKSTART_GATE, QUICKSTART_CACHE = 1e-2, (2, 1)


def one_position_mesh():
    return make_mesh((1, 1), ("data", "model"), device="meta")


def dry_solve_checks() -> dict:
    """(a) Algorithm 1 at each Table-1 shape: the dry run's resident bytes,
    would-be launches and roofline bound against the card's peak, launch
    counts and time of the same ``chol_solve_fused`` call, S and v already
    resident. Returns the launches of one call a shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    mesh = one_position_mesh()
    total = dict.fromkeys(ops.launch_counts(), 0)
    for n, m in TABLE1:
        rec = dryrun.analyze_cell(dryrun.build_solver_cell(n, m, mesh), mesh)
        predicted = rec["memory"]["resident_bytes"]
        would = {k: int(c["launches"])
                 for k, c in rec["cost"]["kernels"].items()}
        bound_ms = rec["roofline"]["bound_s"] * 1e3
        S, v = solve_inputs(n, m, gen)
        torch.cuda.synchronize()
        other = torch.cuda.memory_allocated() - (S.numel() + v.numel()) * 4
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        x = ops.chol_solve_fused(S, v, LAM0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - other
        counts = {k: c for k, c in ops.launch_counts().items() if c}
        add_counts(total, ops.launch_counts())
        if x.shape != (m,) or not torch.isfinite(x).all():
            raise AssertionError(f"dry run vs card {n}x{m}: x not finite")
        del x
        ms = time_ms(lambda: ops.chol_solve_fused(S, v, LAM0))
        ratio = peak / predicted
        print(f"  {n}x{m}: peak {peak:,} B on the card, {predicted:,} B "
              f"predicted (arguments {rec['memory']['argument_bytes']:,} + "
              f"{rec['memory']['peak_bytes']:,}), ratio {ratio:.4f} (gate "
              f"{DRY_SOLVE_GATE}); launches {counts}, predicted {would}; "
              f"{ms:.4f} ms against a bound of {bound_ms:.4f} ms "
              f"({rec['roofline']['dominant']}; ratio {ms / bound_ms:.2f}, "
              f"gate ≥ {DRY_TIME_GATE})", flush=True)
        if not DRY_SOLVE_GATE[0] <= ratio <= DRY_SOLVE_GATE[1]:
            raise AssertionError(f"dry run vs card {n}x{m}: peak ratio "
                                 f"{ratio:.4f}")
        if counts != would:
            raise AssertionError(f"dry run vs card {n}x{m}: launches "
                                 f"{counts}, predicted {would}")
        if not ms >= DRY_TIME_GATE * bound_ms:
            raise AssertionError(f"dry run vs card {n}x{m}: {ms:.4f} ms beats "
                                 f"the bound {bound_ms:.4f} ms")
        del S, v
    return total


def dry_trainer_check(peak: int) -> None:
    """(b) The dry run of the LM NGD trainer phase's own configuration —
    llama3.2-3b at LM_LAYERS layers, bf16, batch TRAIN_BATCH, seq
    TRAIN_SEQ, one position, Algorithm 1 on the kernels — beside that
    phase's measured peak (its dense kernel run)."""
    mesh = one_position_mesh()
    cell = dryrun.build_cell(
        LM_ARCH, WorkloadShape("lm_trainer", "train", TRAIN_SEQ, TRAIN_BATCH),
        mesh, optimizer="ngd", overrides={"n_layers": str(LM_LAYERS)})
    rec = dryrun.analyze_cell(cell, mesh)
    mem = rec["memory"]
    ratio = peak / mem["resident_bytes"]
    would = {k: int(c["launches"]) for k, c in rec["cost"]["kernels"].items()}
    print(f"  LM NGD trainer ({LM_ARCH}, {LM_LAYERS} layers, batch "
          f"{TRAIN_BATCH}, seq {TRAIN_SEQ}): the phase's peak {peak:,} B; "
          f"predicted {mem['resident_bytes']:,} B (arguments "
          f"{mem['argument_bytes']:,} + {mem['peak_bytes']:,}); ratio "
          f"{ratio:.4f} (gate {DRY_TRAINER_GATE}); a step's launches "
          f"predicted {would}; the trace {rec['compile_s']} s; roofline "
          f"bound {rec['roofline']['bound_s'] * 1e3:.2f} ms "
          f"({rec['roofline']['dominant']})", flush=True)
    if not DRY_TRAINER_GATE[0] <= ratio <= DRY_TRAINER_GATE[1]:
        raise AssertionError(f"dry run vs the LM trainer: ratio {ratio:.4f}")


def dry_cells() -> None:
    """(c) The full-width cells, each traced on meta in this process."""
    t_all = time.perf_counter()
    for arch, shape, mesh_kind, solver in DRY_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, mesh_kind, solver_nm=solver)
        mem, roof = rec["memory"], rec["roofline"]
        tag = dryrun._cell_id(rec)
        print(f"  {tag}: {time.perf_counter() - t0:.1f} s; arguments "
              f"{mem['argument_bytes']:,} B a position (replicated; the "
              f"sharding rules' {mem['sharded_argument_bytes']:,}), peak "
              f"{mem['peak_bytes']:,} B, flops/position "
              f"{rec['cost']['flops']:.3e}, wire {rec['collectives']['total_wire_bytes']:,} B, "
              f"bound {roof['bound_s']:.4f} s ({roof['dominant']})",
              flush=True)
        if rec["chips"] != (512 if mesh_kind == "multi" else 256) \
                or not all(np.isfinite(roof[k]) for k in (
                    "t_compute_s", "t_memory_s", "t_collective_s")):
            raise AssertionError(f"dry run {tag}: {rec['chips']} positions, "
                                 f"roofline {roof}")
        if arch == "whisper-base" and not mem["peak_bytes"] < DRY_CARD_BYTES:
            raise AssertionError(f"dry run {tag}: peak {mem['peak_bytes']:,} "
                                 f"B does not fit the card")
    print(f"  the full-width cells {time.perf_counter() - t_all:.1f} s",
          flush=True)


def quickstart_path() -> dict:
    """(d) ``examples_torch/quickstart.py`` at its defaults (512, 100,000)
    on the card, under the reference's checks. Returns its launches."""
    path = Path(__file__).resolve().parent / "examples_torch" / "quickstart.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    ops.reset_launch_counts()
    results = quickstart.main(emit=lambda line: print(f"  {line}",
                                                      flush=True))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for name in ("chol", "eigh", "svd"):
        if not results[name][1] < QUICKSTART_GATE:
            raise AssertionError(f"quickstart {name}: residual "
                                 f"{results[name][1]:.3e}")
    if results["cache"] != QUICKSTART_CACHE:
        raise AssertionError(f"quickstart cache (hits, refreshes) "
                             f"{results['cache']}")
    for kname in ("gram_sv", "cholesky", "trisolve", "ngd_apply"):
        require_launches("quickstart", counts, kname)
    return counts


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(name, n, m, k, es, bw, flops, gram_rate,
          v_es=None) -> tuple[float, str]:
    """Least time for the function: each input read once and each output
    written once, against the operations at peak — fp32, or for the Gram's
    products of window rows ``gram_rate``: the rate of fp32-accurate
    products on the tensor cores (3xTF32, a third of the dense TF32 peak,
    for an fp32 window; the dense bf16 peak for a bf16 one). The Gram
    counts the lower triangle (gram_sv's u at the fp32 rate), the
    Cholesky n³/3; the larger wins. ``serve_solve`` counts the window
    twice: its apply pass needs all of w, so all of u = S·V, before its
    first column, and a window beyond the 50 MB of L2 (410 MB at the main
    shape) is read from device memory again. ``v_es``: the bytes of one
    element of v where they differ from the window's (the NGD step's v is
    fp32 beside a bf16 window)."""
    f4 = 4
    ves = es if v_es is None else v_es
    win = n * m * es
    tri = n * (n + 1) * m                     # 2 flop × n(n+1)/2 × m
    nbytes, t_ops = {
        "sv_cross": (win + m * k * f4 + n * k * f4, 2 * n * m * k / flops),
        "serve_apply": (win + n * k * f4 + 2 * m * k * f4,
                        2 * n * m * k / flops),
        "trisolve": (n * n * f4 + 2 * n * k * f4, 2 * n * n * k / flops),
        # the window twice: the apply pass needs all of u = S·V first
        "serve_solve": (2 * win + n * n * f4 + 2 * m * k * f4,
                        (4 * n * m * k + 2 * n * n * k) / flops),
        "fold_cols": (win + k * m * es + (n + k) * k * f4,
                      2 * (n + k) * m * k / flops),
        "gram": (win + n * n * f4, tri / gram_rate),
        "gram_acc": (win + 2 * n * n * f4, tri / gram_rate),
        "gram_sv": (win + m * ves + n * n * f4 + n * f4,
                    tri / gram_rate + 2 * n * m / flops),
        "cholesky": (2 * n * n * f4, n ** 3 / 3 / flops),
        "ngd_apply": (win + n * f4 + m * ves + m * f4, 2 * n * m / flops),
        # the lower triangle read and written once, X read once; 6 flop a
        # rotation of a lower element, k rotations each
        "cholupdate": (n * (n + 1) * f4 + n * k * f4,
                       3 * n * (n + 1) * k / flops),
    }[name]
    t_b, t_o = nbytes / bw * 1e3, t_ops * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def time_cases(cases: dict, library: dict, bound_of, label: str,
               **timing) -> dict:
    """Plain, kernel, kernel, plain (in turns, one call), then the library
    call; returns the JSON fields of each kernel. ``timing``: ``time_ms``'s
    iters and warm-up."""
    out = {}
    for name, fn in cases.items():
        p1 = time_ms(lambda: fn("ref"), **timing)
        k1 = time_ms(lambda: fn("kernel"), **timing)
        k2 = time_ms(lambda: fn("kernel"), **timing)
        p2 = time_ms(lambda: fn("ref"), **timing)
        lib = time_ms(library[name], **timing) if name in library else None
        b, by = bound_of(name)
        out[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "library_ms": lib, "bound_ms": b, "bound_by": by}
        print(f"  {label} {name}: kernel {k1:.4f}/{k2:.4f} ms, "
              f"plain {p1:.4f}/{p2:.4f} ms, library "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound {b:.4f} ms "
              f"({by})", flush=True)
    return out


def timings(dtype, k: int, bw: float, flops: float) -> dict:
    """The serve kernels at (N, M), k right-hand sides."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    S, L = window(N, M, dtype, gen)
    V = torch.randn((M, k), generator=gen, device="cuda")
    w = torch.randn((N, k), generator=gen, device="cuda")
    rows = (torch.randn((k, M), generator=gen, device="cuda") / M ** 0.5).to(dtype)
    library = {}
    if dtype == torch.float32:
        library = {
            "sv_cross": lambda: torch.matmul(S, V),
            "serve_apply": lambda: torch.addmm(V, S.T, w, beta=1 / LAM0,
                                               alpha=-1 / LAM0),
            "trisolve": lambda: torch.cholesky_solve(w, L),
            "fold_cols": lambda: torch.matmul(S, rows.T),
        }
    es = S.element_size()
    return time_cases(
        kernel_cases(S, L, V, w, rows, LAM0), library,
        lambda name: bound(name, N, M, k, es, bw, flops, flops),
        f"{str(dtype)[6:]} k={k}")


def algorithm1_timings(dtype, bw: float, flops: float,
                       gram_rate: float) -> dict:
    """The Algorithm-1 kernels at (N, M), one right-hand side. Row 3's
    library call is one ``torch.mm(S, Sv.T)`` with Sv = [S; v] built
    outside the timed region: W and u in one call, over the full square.
    The Gram's bound on the fp32 FMA rate (the CUDA-core route's) is
    printed beside the tensor-core bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    S = (torch.randn((N, M), generator=gen, device="cuda") / M ** 0.5).to(dtype)
    v = torch.randn((M,), generator=gen, device="cuda")
    w = torch.randn((N,), generator=gen, device="cuda")
    W = spd(N, gen)
    acc = torch.zeros((N, N), device="cuda")   # gram_acc accumulates in place
    vs = v.to(dtype)
    Sv = torch.cat([S, vs[None]])
    cases = {
        "gram": lambda mode: ops.gram(S, mode=mode),
        "gram_acc": lambda mode: ops.gram_acc(S, acc, mode=mode),
        "gram_sv": lambda mode: ops.gram_sv(S, vs, mode=mode),
        "cholesky": lambda mode: ops.cholesky(W, mode=mode),
        "ngd_apply": lambda mode: ops.ngd_apply(S, w, vs, LAM0, mode=mode),
    }
    library = {}
    if dtype == torch.float32:
        library = {
            "gram": lambda: torch.matmul(S, S.T),
            "gram_acc": lambda: torch.addmm(acc, S, S.T),
            "gram_sv": lambda: torch.mm(S, Sv.T),
            "cholesky": lambda: torch.linalg.cholesky(W),
            "ngd_apply": lambda: torch.addmv(v, S.T, w, beta=1 / LAM0,
                                             alpha=-1 / LAM0),
        }
    es = S.element_size()
    fma = {name: bound(name, N, M, 1, es, bw, flops, flops)[0]
           for name in ("gram", "gram_acc", "gram_sv")}
    print(f"  {str(dtype)[6:]} Gram bound on the fp32 FMA rate (the CUDA-core "
          "route's): " + ", ".join(f"{k} {t:.4f} ms" for k, t in fma.items()),
          flush=True)
    return time_cases(
        cases, library,
        lambda name: bound(name, N, M, 1, es, bw, flops, gram_rate),
        f"{str(dtype)[6:]}")


def trainer_shape_timings(bw: float, flops: float, bf16_flops: float,
                          m: int) -> dict:
    """``gram_sv`` and ``ngd_apply`` at the LM trainer's shape: n = 8 rows
    of a bf16 window of m columns, v as the step gives it (fp32 holding
    bf16 values; ``gram_sv`` takes it rounded to bf16, ``ngd_apply`` in
    fp32). First each kernel against its plain version on the same
    inputs: ``gram_sv``'s W and u also against their float64 values over
    column chunks (one fp32 sum over 6e8 columns, the plain version's, is
    itself ≈ 1e-4 off), within PASS_TOL; ``ngd_apply`` (n = 8 terms a
    column) against the plain version within PASS_TOL. Then the times;
    ``gram_sv``'s library call is ``torch.mm(S, Sv.T, out_dtype=fp32)``
    with Sv = [S; v] built outside the timing (bf16 operands, an fp32
    result), where this torch takes ``out_dtype`` — the script prints why
    not where it does not. ``ngd_apply`` has no such call."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    n = TRAIN_BATCH
    S = torch.randn((n, m), generator=gen, device="cuda",
                    dtype=torch.bfloat16).mul_(m ** -0.5)
    v = torch.randn((m,), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    v32, w = v.float(), torch.randn((n,), generator=gen, device="cuda")
    W64 = gram64(S)
    u64 = sum(S[:, j:j + (1 << 25)].double() @ v[j:j + (1 << 25)].double()
              for j in range(0, m, 1 << 25))
    (Wk, uk), (Wp, up) = (ops.gram_sv(S, v, mode=mode)
                          for mode in ("kernel", "ref"))
    x_err = rel(ops.ngd_apply(S, w, v32, TRAIN_LAM, mode="kernel"),
                ops.ngd_apply(S, w, v32, TRAIN_LAM, mode="ref"))
    errs = {"W": rel(Wk, W64), "u": rel(uk, u64), "W plain": rel(Wp, W64),
            "u plain": rel(up, u64), "W kernel vs plain": rel(Wk, Wp)}
    print(f"  ({n}, {m:,}) bf16 gram_sv vs float64: "
          + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
          + f" (gate {PASS_TOL:g}); ngd_apply vs plain {x_err:.2e} (gate "
          f"{PASS_TOL:g})", flush=True)
    if not (errs["W"] < PASS_TOL and errs["u"] < PASS_TOL
            and x_err < PASS_TOL):
        raise AssertionError(f"the LM trainer's shape: gram_sv {errs}, "
                             f"ngd_apply {x_err:.3e}")
    del W64, u64, Wk, uk, Wp, up
    Sv = torch.cat([S, v[None]])
    library = {}
    try:
        got = torch.mm(S[:, :4096], Sv[:, :4096].T, out_dtype=torch.float32)
        if got.dtype != torch.float32:
            raise TypeError(f"torch.mm(out_dtype=) gave {got.dtype}")
        library["gram_sv"] = lambda: torch.mm(S, Sv.T,
                                              out_dtype=torch.float32)
    except (TypeError, RuntimeError) as e:
        print(f"  no library time for gram_sv: torch {torch.__version__}'s "
              f"torch.mm(out_dtype=float32) on bf16 operands: {e}",
              flush=True)
    timing = {"iters": 3, "warmup": 1}
    out = time_cases(
        {"gram_sv": lambda mode: ops.gram_sv(S, v, mode=mode)}, library,
        lambda name: bound(name, n, m, 1, 2, bw, flops, bf16_flops),
        f"({n}, {m:,}) bf16", **timing)
    # v read in fp32: the bound counts its 4 bytes a column
    out.update(time_cases(
        {"ngd_apply": lambda mode: ops.ngd_apply(S, w, v32, TRAIN_LAM,
                                                 mode=mode)}, {},
        lambda name: bound(name, n, m, 1, 2, bw, flops, bf16_flops, v_es=4),
        f"({n}, {m:,}) bf16, v fp32", **timing))
    del S, v, v32, Sv
    return out


def cholupdate_timings(bw: float, flops: float) -> dict:
    """The kernel at (N, 16) and (2048, 16) beside its plain version, the
    refactorization chol(L·Lᵀ + X·Xᵀ) (context only: no PyTorch call
    computes a rank-k update, so the library column is null) and the
    bound; then one update + downdate slide of the Table-1 window."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    out = {}
    for n in (N, 2048):
        L, X = cholupdate_inputs(n, SLIDE_K, 1, gen)
        refac = time_ms(lambda: torch.linalg.cholesky(L @ L.T + X @ X.T))
        t = time_cases({"cholupdate": lambda mode: ops.cholupdate(
            L, X, mode=mode)}, {}, lambda name: bound(
                name, n, 0, SLIDE_K, 4, bw, flops, flops),
            f"n={n} k={SLIDE_K}")
        print(f"  n={n} k={SLIDE_K} refactorization chol(LLᵀ + XXᵀ): "
              f"{refac:.4f} ms", flush=True)
        if n == N:
            out = t
    S_t, _ = solve_inputs(N, M, gen)
    fac = chol_factorize(S_t, LAM0)
    X_new, X_old = slide(S_t, 0, gen)
    ms = time_ms(lambda: fac.update(X_new, S_new=S_t).downdate(
        X_old, S_new=S_t))
    plain = time_ms(lambda: chol_factorize(S_t, LAM0))
    print(f"  one slide at {N}x{M}, k = {SLIDE_K} (update + downdate, W and "
          f"L): {ms:.4f} ms; refactorizing the window (plain gram + "
          f"Cholesky) {plain:.4f} ms", flush=True)
    return out


def flash_bound(T, H, KH, hd, es, causal, bw, peak) -> tuple[float, str]:
    """Least time of one attention forward: q, k, v read and o written
    once; 4·hd flop per live (q, k) pair — T(T+1)/2 pairs causal, T²
    bidirectional — at the operands' type's peak."""
    pairs = T * (T + 1) // 2 if causal else T * T
    t_b = (2 * T * H + 2 * T * KH) * hd * es / bw * 1e3
    t_o = 4 * hd * H * pairs / peak * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def flash_timings(bw: float, bf16_flops: float) -> dict:
    """Row 11 at llama3.2-3b's layer shape (24 query / 8 KV heads, hd
    128, bf16, causal): T = 1024 (the serving trace's prefill) and
    T = 32,768 (the long prefill, returned for the JSON line). The library
    call is scaled_dot_product_attention with the KV heads expanded to 24
    outside the timed call; the port never calls it."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    out = {}
    for T in (1024, LONG_T):
        q, k, v = attention_inputs(1, T, 8, 3, 128, torch.bfloat16, gen)
        qt = q.transpose(1, 2)
        kt, vt = (t.repeat_interleave(3, dim=2).transpose(1, 2) for t in (k, v))
        timing = {"iters": 2, "warmup": 1} if T == LONG_T else {}
        out = time_cases(
            {"flash_attention": lambda mode: ops.flash_attention(
                q, k, v, causal=True, mode=mode)},
            {"flash_attention": lambda: torch.nn.functional
             .scaled_dot_product_attention(qt, kt, vt, is_causal=True)},
            lambda name: flash_bound(T, 24, 8, 128, 2, True, bw, bf16_flops),
            f"(1, {T}, 24/8, 128) bf16 causal", **timing)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase("device")
    card = device_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    bw, flops, tf32_flops, bf16_flops = peaks(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; bound peaks "
          f"{bw / 1e12:.2f} TB/s, {flops / 1e12:.0f} TFLOP/s fp32, "
          f"{tf32_flops / 1e12:.1f} TFLOP/s TF32, "
          f"{bf16_flops / 1e12:.0f} TFLOP/s bf16")

    phase("build")
    build()

    phase("kernel checks (kernel vs plain on the card, repeat bit-identical)")
    main_err = kernel_checks()
    trisolve_checks()
    main_err.update(algorithm1_checks())

    trace = make_trace()
    phase(f"serving path, dense window {N}x{M} fp32")
    dense = main_path(trace, blocked=False)
    phase(f"serving path, dense window {N}x{M} fp32, observed: fold journal, "
          f"metrics registry, health monitor (audit every 4), tracer, flight "
          f"recorder")
    observed = observed_path(trace, dense)
    phase(f"serving path, blocked window {WIDTHS}")
    blocked = main_path(trace, blocked=True)

    phase(f"Algorithm 1, chol_solve_fused at {TABLE1}, λ = {LAM0:g}")
    solve_counts = algorithm1_path()
    phase(f"NGD trainer, {NGD_STEPS} steps (examples/ngd_mlp_train.py --big)")
    step_counts, step_inputs = trainer_path()

    paths = {"serving, dense": dense["counts"],
             "serving, dense, observed": observed["counts"],
             "serving, blocked": blocked["counts"],
             "Algorithm 1": solve_counts, "NGD trainer": step_counts}
    for label, counts in paths.items():
        print(f"  launches on {label}: "
              + ", ".join(f"{k}={v}" for k, v in counts.items() if v))
    new = ("gram", "gram_acc", "gram_sv", "cholesky", "ngd_apply")
    missing = [k for k in new if solve_counts[k] + step_counts[k] == 0]
    if missing:
        raise AssertionError(f"Algorithm 1 kernels never launched: {missing}")

    phase("cholupdate checks (kernel vs plain on the card, repeat "
          "bit-identical)")
    main_err.update(cholupdate_checks())
    phase(f"maintained factorization, {SLIDES} slides of {SLIDE_K} columns "
          f"at {N}x{M}, λ = {LAM0:g}")
    paths["maintained factorization"] = maintained_path()
    phase(f"tenant factor view, rank {TENANT_RANK} at {N}x{M}, "
          f"λ₀ = {LAM0:g}")
    paths["tenant view"] = tenant_path()
    for label in ("maintained factorization", "tenant view"):
        print(f"  launches on {label}: " + ", ".join(
            f"{k}={v}" for k, v in paths[label].items() if v))
        if paths[label]["cholupdate"] == 0:
            raise AssertionError(f"cholupdate never launched on {label}")
    phase(f"tenant serving, dense window {N}x{M} fp32: the dense trace with "
          f"zipf({TENANT_ZIPF:g}) tenant ids among {TENANTS}, rank "
          f"{TENANT_RANK}, a {TENANT_BUDGET} B budget")
    paths["tenant serving"] = tenant_serving_path(trace)["counts"]
    t0 = time.perf_counter()
    phase(f"sharded serving tier: the dense trace through AsyncSolveServer, "
          f"replicated and on {SHARD_POSITIONS} positions of the card (1d, "
          f"2d as (2, 2), blocked), a bf16 window (1d) and m = {PAD_M:,} "
          f"(1d, padded); then a second 1d run and one with seeded sleeps")
    for label, counts in sharded_serving_path(trace, dense).items():
        paths[f"sharded serving, {label}"] = counts
    phase(f"sharded Algorithm 1 at {N}x{M} on {SHARD_POSITIONS} positions "
          f"(1d, 2d) and the rank-{SLIDE_K} update with its columns sharded "
          f"(composed, rotations)")
    paths["sharded Algorithm 1"] = sharded_algorithm1_path()
    print(f"  the sharded phases {time.perf_counter() - t0:.1f} s",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase(f"the fleet: {FLEET_WORKERS} worker processes on the card behind "
          f"a Dispatcher at {N}x{M}, λ₀ = {LAM0:g}: (a) the dense trace, "
          f"round robin, gossip, fp32, the workers profiled; (b) the same, "
          f"bf16 window sharded 1d on async workers, profiled; (c) by_adapter without gossip, then SIGTERM to one "
          f"worker; (d) serve_main --smoke --fleet 2 --route by_adapter on "
          f"the card and the CPU, and --async")
    fleet = fleet_path(trace)
    paths["fleet, in the workers"] = fleet["counts"]
    eager = dense["summary"]
    print(f"  phase 4's eager server in this run: p50 {eager['p50_ms']:.3f} "
          f"ms  p99 {eager['p99_ms']:.3f} ms  {eager['rps']:.1f} req/s; the "
          f"fleet phase {time.perf_counter() - t0:.1f} s", flush=True)
    phase(f"streaming curvature, {STREAM_N}x{M}, {STREAM_STEPS} solves")
    streaming_path()

    phase("flash-attention checks (kernel vs plain on the card, repeat "
          "bit-identical)")
    main_err.update(flash_checks())
    lm_cfg = configs.get_config(LM_ARCH).scaled(n_layers=LM_LAYERS)
    phase(f"LM serving, {LM_ARCH} at published widths, {LM_LAYERS} layers, "
          f"window {LM_WINDOW}, seq {LM_SEQ}, {LM_REQUESTS} requests, burst "
          f"{LM_BURST}, {LM_NEW} decoded tokens, λ₀ = {LM_LAM0:g}")
    paths["LM serving"] = lm_serving_path(lm_cfg)["counts"]
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"LM serving CLI at the reference's defaults: python -m "
          f"repro_torch.serve --full --n-layers {LM_LAYERS} (12 requests, "
          f"window 8, seq 16, burst 3, checkpoints every 8 rounds and at "
          f"exit, the audit every 4) with the metrics endpoint, snapshot, "
          f"trace and profile; then --smoke on the card and on the CPU")
    paths["LM serving CLI"] = lm_cli_path()["counts"]
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"LM serving CLI with tenants: python -m repro_torch.serve --full "
          f"--n-layers {LM_LAYERS} --tenants {LM_TENANTS} --tenant-rank "
          f"{LM_TENANT_RANK} --tenant-budget-mb {LM_TENANT_BUDGET_MB:g}; "
          f"then --smoke --tenants 4 on the card and on the CPU")
    paths["LM serving CLI, tenants"] = lm_tenant_cli_path()["counts"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase(f"LM serving CLI, sharded: python -m repro_torch.serve --full "
          f"--n-layers {LM_LAYERS} --mesh 1d --async (exit checkpoint "
          f"restored); then --smoke --mesh 1d --async on the card and on the "
          f"CPU")
    paths["LM serving CLI, sharded"] = sharded_cli_path()["counts"]
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {time.perf_counter() - t0:.1f} s", flush=True)
    phase(f"LM NGD trainer, {LM_ARCH} at published widths, {LM_LAYERS} "
          f"layers, bf16, batch {TRAIN_BATCH}, seq {TRAIN_SEQ}, λ = "
          f"{TRAIN_LAM:g}, lr {TRAIN_LR:g}")
    trainer = lm_trainer_path(lm_cfg)
    paths["LM NGD trainer"] = trainer["counts"]
    for kname in ("gram_sv", "cholesky", "trisolve", "ngd_apply"):
        require_launches("LM NGD trainer", paths["LM NGD trainer"], kname)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase(f"LM NGD trainer over a {MESH_SHAPE} (data, model) mesh of four "
          f"positions on the card: {', '.join(MESH_LAYOUTS)} ({MESH_STEPS} "
          f"exact steps each, and a rerun), the streaming policy (1d, "
          f"{TRAIN_STREAM_STEPS} steps), one HybridNGD step (NGD on the "
          f"embedding), bf16 and int8 all-reduce of the gradient, "
          f"train_main --smoke --mesh-shape 2,2 on the card and the CPU")
    paths.update(mesh_trainer_path(lm_cfg, trainer["one"]))
    SEEDED.clear()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase(f"dry run against the card: (a) chol_solve_fused at {TABLE1} "
          f"(peak, launches, time vs the meta trace's resident bytes, "
          f"would-be launches and roofline bound); (b) the LM NGD trainer "
          f"phase's peak vs its dry run; (c) full-width cells on meta; (d) "
          f"examples_torch/quickstart.py at (512, 100000)")
    paths["dry run, Table-1 solves"] = dry_solve_checks()
    dry_trainer_check(trainer["peak"])
    dry_cells()
    paths["quickstart"] = quickstart_path()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {time.perf_counter() - t0:.1f} s", flush=True)
    phase(f"long prefill, {LM_ARCH}, all 28 layers, bf16, one prompt of "
          f"{LONG_T} tokens")
    paths["long prefill"] = long_prefill(configs.get_config(LM_ARCH),
                                         LONG_T)["counts"]
    gc.collect()
    torch.cuda.empty_cache()
    t_zoo = time.perf_counter()
    phase("LM serving, MoE and Mamba2: "
          + "; ".join(f"{a}, {n} layers, {w or 'float32'} window, burst {b}"
                      for a, n, w, b in ZOO_SERVED)
          + f"; phase 13's trace otherwise (window {LM_WINDOW}, seq "
          f"{LM_SEQ}, {LM_REQUESTS} requests)")
    for arch, counts in zoo_serving_path().items():
        paths[f"LM serving, {arch}"] = counts
    t0 = time.perf_counter()
    phase(f"LM serving, MoE and Mamba2: {MAMBA_ARCH}, {MAMBA_LAYERS} of 48 "
          f"layers, "
          f"prefill of {MAMBA_PROMPT} tokens at batch {MAMBA_B} + "
          f"{MAMBA_STEPS} teacher-forced decode steps (fp32), then bf16 "
          f"prefill of {MAMBA_TIMED_PROMPT} tokens and decode timed")
    paths["mamba2 prefill + decode"] = mamba_decode_path()["counts"]
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase("LM serving, MoE and Mamba2: python -m repro_torch.serve --arch "
          f"{{{', '.join(ZOO_CLI)}}} --smoke on the card and on the CPU")
    paths["LM serving CLI, zoo"] = zoo_cli_path()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {time.perf_counter() - t0:.1f} s; the MoE and Mamba2 phase "
          f"{time.perf_counter() - t_zoo:.1f} s", flush=True)
    t_a6b = time.perf_counter()
    for title, key, run in (
            (f"LM serving, encoder-decoder: {WHISPER_ARCH} at published "
             f"widths, all 6 + 6 layers, bf16 weights, float32 window; phase "
             f"13's trace with decode off (window {LM_WINDOW}, seq {LM_SEQ}, "
             f"{LM_REQUESTS} requests, burst {LM_BURST})",
             f"LM serving, {WHISPER_ARCH}",
             lambda: lm_serving_path(configs.get_config(WHISPER_ARCH),
                                     decode_tokens=0)),
            (f"encoder-decoder: {WHISPER_ARCH}, all 6 + 6 layers, fp32, "
             f"batch {WHISPER_B}, 1500 frames, prefill of {WHISPER_PROMPT} "
             f"tokens + {WHISPER_STEPS} teacher-forced decode steps, then "
             f"bf16 timed", f"{WHISPER_ARCH} prefill + decode",
             whisper_decode_path),
            (f"encoder-decoder: {WHISPER_ARCH} NGD trainer at published "
             f"widths, all layers, bf16, batch {TRAIN_BATCH}, seq "
             f"{TRAIN_SEQ}, λ = {TRAIN_LAM:g}, lr {TRAIN_LR:g}",
             f"{WHISPER_ARCH} NGD trainer", whisper_trainer_path),
            (f"patch prefix: {PIXTRAL_ARCH} at published widths, "
             f"{PIXTRAL_LAYERS} of 40 layers, fp32, batch {PIXTRAL_B}, "
             f"256 patches + {PIXTRAL_PROMPT} tokens, {PIXTRAL_STEPS} "
             f"teacher-forced decode steps, then bf16 timed",
             f"{PIXTRAL_ARCH} prefill + decode", pixtral_decode_path),
            ("encoder-decoder and patch prefix: python -m repro_torch.serve "
             "--arch {whisper-base --decode-tokens 0, pixtral-12b} --smoke "
             f"and train_main --smoke --optimizer ngd --steps "
             f"{A6B_TRAIN_STEPS}, on the card and on the CPU",
             "LM CLIs, whisper-base and pixtral-12b",
             lambda: {"counts": zoo_cli_path(A6B_CLI, A6B_TRAIN_STEPS)})):
        t0 = time.perf_counter()
        phase(title)
        paths[key] = run()["counts"]
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"  the encoder-decoder and patch-prefix phase "
          f"{time.perf_counter() - t_a6b:.1f} s", flush=True)
    for label in ("tenant serving", *(k for k in paths if
                                      k.startswith("sharded ")),
                  "fleet, in the workers",
                  "LM serving", "LM serving CLI",
                  "LM serving CLI, tenants", "LM serving CLI, sharded",
                  "LM NGD trainer",
                  *(k for k in paths if k.startswith("mesh trainer")),
                  "dry run, Table-1 solves", "quickstart",
                  "long prefill") + tuple(
                      f"LM serving, {a}" for a, _, _, _ in ZOO_SERVED) + (
                      "mamba2 prefill + decode", "LM serving CLI, zoo",
                      f"LM serving, {WHISPER_ARCH}",
                      f"{WHISPER_ARCH} prefill + decode",
                      f"{WHISPER_ARCH} NGD trainer",
                      f"{PIXTRAL_ARCH} prefill + decode",
                      "LM CLIs, whisper-base and pixtral-12b"):
        print(f"  launches on {label}: " + ", ".join(
            f"{k}={v}" for k, v in paths[label].items() if v))

    phase("profiles")
    profile_flush(trace)
    profile_flush(trace, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    S, v = solve_inputs(N, M, gen)
    busy = profile_gram_path(
        f"one chol_solve_fused at {N}x{M}",
        lambda: ops.chol_solve_fused(S, v, LAM0),
        seen=lambda b, _: any("tri::trisolve_kernel" in k for k in b))
    require_cluster_trisolve(f"one chol_solve_fused at {N}x{M}", busy)
    opt, st, p, Xd, yd = step_inputs
    profile_gram_path(f"one NGD step (n = {MLP_N})",
                      lambda: ngd_step(opt, st, p, Xd, yd))
    fac = chol_factorize(S, LAM0)
    X_new, X_old = slide(S, 0, gen)
    calls = {}
    busy = profile_retaken(
        f"one update + downdate slide at {N}x{M}, k = {SLIDE_K}",
        lambda: fac.update(X_new, S_new=S).downdate(X_old, S_new=S),
        lambda _, c: sum(n for key, n in c.items()
                         if "cholupdate_kernel" in key) >= 2, calls=calls)
    require_one_launch_a_sweep("the slide", busy, calls, sweeps=2)
    del S, v, fac

    phase(f"kernel times at {N}x{M}")
    t32 = timings(torch.float32, PER_MB, bw, flops)
    timings(torch.bfloat16, PER_MB, bw, flops)
    t32.update(algorithm1_timings(torch.float32, bw, flops, tf32_flops / 3))
    algorithm1_timings(torch.bfloat16, bw, flops, bf16_flops)
    phase(f"kernel times at the LM trainer's shape ({TRAIN_BATCH}, "
          f"{trainer['m']:,}), bf16")
    trainer_shape_timings(bw, flops, bf16_flops, trainer["m"])
    phase("Cholesky times (path A's n)")
    cholesky_timings(bw, flops)
    phase(f"cholupdate times, k = {SLIDE_K}")
    t32.update(cholupdate_timings(bw, flops))
    phase("flash-attention times (llama3.2-3b layer shape)")
    t32.update(flash_timings(bw, bf16_flops))

    lines = []
    for kname, (source, replaces) in KERNELS.items():
        launches = sum(counts[kname] for counts in paths.values())
        lines.append({"name": kname, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": launches,
                      "max_abs_err": main_err[kname], **t32[kname]})
    print(f"serve parity worst: dense {dense['worst']:.3e}, blocked "
          f"{blocked['worst']:.3e}")
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
