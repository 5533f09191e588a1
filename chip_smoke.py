#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA GPU (written for the H100).

Phases, each printing its own lines:

1. device — name and power limit (``nvidia-smi``); no CUDA → exit 1;
2. build  — compile the hand-written CUDA kernels from ``csrc/``;
3. kernel checks — every kernel against its plain PyTorch version on the
   card over a shape sweep up to (2048, 200_000), fp32 and bf16 windows,
   k ∈ {1, 5, 8, 16}; a second call must be bit-identical;
4. main path, dense — ``SolveServer`` at the paper's Table-1 shape
   (n = 1024 samples, m = 100_000 parameters, λ₀ = 1e-3): 64 requests
   with fold rows, one mixed-λ microbatch, age refreshes; the same trace
   through the port on the CPU (plain versions throughout) is the
   reference;
5. main path, blocked — the same window in four blocks, same trace;
6. per-kernel launches, times, plain and library times, and bounds.

Any failed check raises, so the script exits non-zero. The last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import BlockedScores  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.serve import (OnlineAdaptation, SolveServer,  # noqa: E402
                               TokenBudgetBatcher, init_serve_state)

N, M, LAM0 = 1024, 100_000, 1e-3          # configs/paper.py Table-1 row
WIDTHS = (40_000, 30_000, 20_000, 10_000)
SWEEP_SHAPES = [(8, 128), (32, 300), (100, 1000), (130, 515), (N, M),
                (2048, 200_000)]
SWEEP_K = (1, 5, 8, 16)
REQUESTS, PER_MB, ROWS_PER_REQ, MIXED_MB = 64, 8, 2, 3
SEED = 0

# Reduction order over m ≤ 2·10⁵ differs from cuBLAS's: 1e-4 relative for
# the one-reduction passes; the solve adds two triangular solves whose
# error grows with n, so 1e-3 at n = 2048.
PASS_TOL = 1e-4
SERVE_GATE = 5e-3                      # benchmarks/serve.py's bound

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "serve_solve": ("src/repro_torch/kernels/csrc/serve_solve.cu",
                    "src/repro/kernels/serve_solve.py:107"),
    "sv_cross": ("src/repro_torch/kernels/csrc/serve_solve.cu",
                 "src/repro/kernels/serve_solve.py:153"),
    "serve_apply": ("src/repro_torch/kernels/csrc/serve_solve.cu",
                    "src/repro/kernels/serve_solve.py:187"),
    "trisolve": ("src/repro_torch/kernels/csrc/serve_solve.cu",
                 "src/repro/kernels/serve_solve.py:46"),
    "fold_cols": ("src/repro_torch/kernels/csrc/fold.cu",
                  "src/repro/kernels/fold.py:54"),
}


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


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


def peaks(name: str) -> tuple[float, float]:
    """(bytes/s, fp32 FLOP/s) from NVIDIA's data sheets: H100 SXM
    3.35 TB/s and 67 TFLOP/s; the PCIe part 2.0 TB/s and 51 TFLOP/s."""
    return (2.0e12, 51e12) if "PCIe" in name else (3.35e12, 67e12)


def build() -> None:
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
          f"({_build.build_dir()})")
    for name in libs:
        log = (_build.build_dir() / f"lib{name}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or ("spill" in line
                                           and "0 bytes spill stores" not in line):
                    print(f"  ptxas {name}: {line.strip()}")


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


def window(n, m, dtype, gen):
    S = (torch.randn((n, m), generator=gen, device="cuda") / m ** 0.5).to(dtype)
    S32 = S.float()
    L = torch.linalg.cholesky(S32 @ S32.T
                              + LAM0 * torch.eye(n, device="cuda"))
    return S, L.contiguous()


def kernel_checks() -> dict:
    """Sweep; returns {kernel: abs error at the main shape, fp32, k=8}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    main_err = {}
    for n, m in SWEEP_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            S, L = window(n, m, dtype, gen)
            worst = {}
            for k in SWEEP_K:
                V = torch.randn((m, k), generator=gen, device="cuda")
                w = torch.randn((n, k), generator=gen, device="cuda")
                rows = (torch.randn((k, m), generator=gen, device="cuda")
                        / m ** 0.5).to(dtype)
                for name, fn in kernel_cases(S, L, V, w, rows, LAM0).items():
                    got, again = fn("kernel"), fn("kernel")
                    plain = fn("ref")
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise AssertionError(f"{name} {n}x{m} {dtype} k={k}: "
                                             "repeat call not bit-identical")
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
            print(f"  {n}x{m} {str(dtype)[6:]}: worst rel err "
                  + " ".join(f"{k}={v:.2e}" for k, v in worst.items()),
                  flush=True)
    return main_err


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


def drive(S, vs, rows, lams, device, blocked):
    """Serve the trace on ``device``; returns (responses, final state,
    metrics summary)."""
    dev = torch.device(device)
    Sd = S.to(dev)
    Sd = BlockedScores.from_dense(Sd, WIDTHS) if blocked else Sd
    state = init_serve_state(Sd, LAM0, device=device)
    vs = [split(v.to(dev), blocked) for v in vs]
    rows = [split(r.to(dev), blocked) for r in rows]

    def server(st):
        return SolveServer(st, batcher=TokenBudgetBatcher(max_requests=PER_MB),
                           adaptation=OnlineAdaptation(refresh_every=4),
                           monitor_drift=False, fused=True)

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

    srv = server(state)
    out = {}
    for b in range(0, REQUESTS, PER_MB):
        uids = {srv.submit(vs[i], damping=lams[i], rows=rows[i]): i
                for i in range(b, b + PER_MB)}
        for res in srv.flush():
            x = torch.cat(res.x) if blocked else res.x
            out[uids[res.uid]] = x.float().cpu()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, srv.state, srv.metrics.summary()


def main_path(trace, blocked: bool) -> dict:
    kind = "blocked" if blocked else "dense"
    t0 = time.perf_counter()
    gx, gstate, summary = drive(*trace, "cuda", blocked)
    counts = ops.launch_counts()
    t_gpu = time.perf_counter() - t0
    print(f"  {kind} GPU: p50 {summary['p50_ms']:.3f} ms  p99 "
          f"{summary['p99_ms']:.3f} ms  {summary['rps']:.1f} req/s  "
          f"(phase {t_gpu:.1f} s)  launches {counts}", flush=True)
    t0 = time.perf_counter()
    cx, cstate, csummary = drive(*trace, "cpu", blocked)
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
    return {"counts": counts, "worst": worst, "W": w_err, "L": l_err,
            "summary": summary}


def profile_flush(trace) -> None:
    """One dense microbatch (8 requests with fold rows) under
    torch.profiler: wall time, device-busy share, device time by kernel."""
    S, vs, rows, lams = trace
    Sd = S.cuda()
    vs = [v.cuda() for v in vs[:PER_MB]]
    rows = [r.cuda() for r in rows[:PER_MB]]
    srv = SolveServer(init_serve_state(Sd, LAM0),
                      batcher=TokenBudgetBatcher(max_requests=PER_MB),
                      adaptation=OnlineAdaptation(refresh_every=10 ** 6),
                      monitor_drift=False)
    for _ in range(2):                       # warm-up, then the profiled one
        for v, r in zip(vs, rows):
            srv.submit(v, rows=r)
        torch.cuda.synchronize()
        act = [torch.profiler.ProfilerActivity.CPU,
               torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=act) as prof:
            t0 = time.perf_counter()
            srv.flush()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy = {e.key: e.self_device_time_total / 1e3 for e in events}
    if not busy:
        print(f"  flush {wall:.3f} ms wall; device time not measured "
              "(the profiler returned no device events)")
        return
    total = sum(busy.values())
    print(f"  flush of {PER_MB} requests + {PER_MB} folds: {wall:.3f} ms wall, "
          f"device busy {total:.3f} ms ({100 * total / wall:.1f} %)")
    for key, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {ms:8.3f} ms  {key[:90]}")


# ---------------------------------------------------------------------------
# 6. times and bounds at the main-path shape
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
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


def bound(name, n, m, k, es, bw, flops) -> tuple[float, str]:
    """Least time for the function: each input read once and each output
    written once, against fp32 operations at peak; the larger wins."""
    f4 = 4
    win = n * m * es
    nbytes, nops = {
        "sv_cross": (win + m * k * f4 + n * k * f4, 2 * n * m * k),
        "serve_apply": (win + n * k * f4 + 2 * m * k * f4, 2 * n * m * k),
        "trisolve": (n * n * f4 + 2 * n * k * f4, 2 * n * n * k),
        "serve_solve": (win + n * n * f4 + 2 * m * k * f4,
                        4 * n * m * k + 2 * n * n * k),
        "fold_cols": (win + k * m * es + (n + k) * k * f4,
                      2 * (n + k) * m * k),
    }[name]
    t_b, t_o = nbytes / bw * 1e3, nops / flops * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def timings(dtype, k: int, bw: float, flops: float) -> dict:
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
    out = {}
    for name, fn in kernel_cases(S, L, V, w, rows, LAM0).items():
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1 = time_ms(lambda: fn("ref"))
        k1 = time_ms(lambda: fn("kernel"))
        k2 = time_ms(lambda: fn("kernel"))
        p2 = time_ms(lambda: fn("ref"))
        lib = time_ms(library[name]) if name in library else None
        b, by = bound(name, N, M, k, es, bw, flops)
        out[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "library_ms": lib, "bound_ms": b, "bound_by": by}
        print(f"  {str(dtype)[6:]} k={k} {name}: kernel {k1:.4f}/{k2:.4f} ms, "
              f"plain {p1:.4f}/{p2:.4f} ms, library "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound {b:.4f} ms "
              f"({by})", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    phase("device")
    card = device_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    bw, flops = peaks(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; bound peaks "
          f"{bw / 1e12:.2f} TB/s, {flops / 1e12:.0f} TFLOP/s fp32")

    phase("build")
    build()

    phase("kernel checks (kernel vs plain on the card, repeat bit-identical)")
    main_err = kernel_checks()

    trace = make_trace()
    phase(f"main path, dense window {N}x{M} fp32")
    dense = main_path(trace, blocked=False)
    phase(f"main path, blocked window {WIDTHS}")
    blocked = main_path(trace, blocked=True)

    phase("profile of one dense flush")
    profile_flush(trace)

    phase(f"kernel times at {N}x{M}, k={PER_MB}")
    t32 = timings(torch.float32, PER_MB, bw, flops)
    timings(torch.bfloat16, PER_MB, bw, flops)

    lines = []
    for kname, (source, replaces) in KERNELS.items():
        launches = dense["counts"][kname] + blocked["counts"][kname]
        lines.append({"name": kname, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": launches,
                      "max_abs_err": main_err[kname], **t32[kname]})
    print(f"serve parity worst: dense {dense['worst']:.3e}, blocked "
          f"{blocked['worst']:.3e}")
    print(card)
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
