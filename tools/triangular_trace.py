#!/usr/bin/env python3
"""Where a call of the two triangular chains spends its time, on one CUDA
card: per-phase timestamps inside ``cholupdate`` and the substitution
(``trisolve``), and the substitution's warp solve alone.

The kernels are not changed for this. The script copies ``csrc/`` into
``build/trace/`` (git-ignored), writes ``clock64()`` and ``%globaltimer``
stamps into that copy at fixed places (it stops if a place is not found,
so the stamps follow the sources), builds it with the package's flags and
calls the copies through their C entries:

* ``cholupdate`` at (1024, 16) and (2048, 16): the cycles of one panel's
  factorization, per column split into its parts (the broadcast of the
  row, the scan, the square root, the rest of the rotations, publishing,
  the 16-rotation apply), and the hand-off from one panel to the next;
* the substitution at n = 1024, k = 1 and 8: per step, the solve, when the
  next panel's owner starts its step, its staging and first update, its
  wait for the pushed panel, the hand-off and its last update;
* the warp solve of one 64-row diagonal block alone (one block on an SM,
  forward and backward, one and eight columns).

Stamps cost cycles: the phases add up to more than an unstamped call.

    python3 tools/triangular_trace.py      # on the card (needs nvcc)
"""
from __future__ import annotations

import ctypes
import importlib
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "trace"
SLOTS = 1 << 20                 # stamps kept on the device

STAMPS = f"""
__device__ unsigned long long g_stamp[{SLOTS}][2];
__device__ int g_stamp_col;
__device__ __forceinline__ unsigned long long global_ns() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}}
#define STAMP(i) do {{ g_stamp[i][0] = clock64(); g_stamp[i][1] = global_ns(); }} while (0)
"""
BENCH = r'''
#include "trisolve.cuh"
template <int KT, bool BW>
__global__ void solve_bench(long long* cycles, int reps) {
  __shared__ float D[64 * 65], dinv[64], rows[64 * KT];
  for (int e = threadIdx.x; e < 64 * 65; e += blockDim.x) D[e] = e % 65 == e / 65 ? 2.f : 0.01f;
  for (int e = threadIdx.x; e < 64; e += blockDim.x) dinv[e] = 0.5f;
  for (int e = threadIdx.x; e < 64 * KT; e += blockDim.x) rows[e] = 1.f;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < reps; ++i)
    if (threadIdx.x < 32 * KT) repro::tri::solve_diag<KT, BW>(rows, D, dinv, nullptr, -1, nullptr);
  __syncthreads();
  if (threadIdx.x == 0) cycles[0] = (clock64() - t0) / reps;
}
extern "C" int solve_bench_launch(void* cycles, int kt, int backward) {
  long long* c = static_cast<long long*>(cycles);
  if (kt == 1) {
    if (backward) solve_bench<1, true><<<1, 32>>>(c, 200);
    else solve_bench<1, false><<<1, 32>>>(c, 200);
  } else {
    if (backward) solve_bench<8, true><<<1, 256>>>(c, 200);
    else solve_bench<8, false><<<1, 256>>>(c, 200);
  }
  return cudaDeviceSynchronize();
}
'''
# cholupdate: group g's stamps at g·128 + slot (lane 0): 0 start, 1 + p after
# the apply of panel p, 100 and 101 around the panel step; group 3's column
# parts at 200000 + j·8 + part (lane 31)
CHOLUPDATE = [
    ("      // trailing steps: panels p < g, in order,",
     "      if (lane == 0) STAMP(g * 128);\n      // trailing steps: panels p < g, in order,"),
    ("          Lp[static_cast<size_t>(r0 + rr) * n + q0 + lane] = sh.tile[rr][lane];\n"
     "        __syncwarp();\n",
     "          Lp[static_cast<size_t>(r0 + rr) * n + q0 + lane] = sh.tile[rr][lane];\n"
     "        __syncwarp();\n        if (lane == 0) STAMP(g * 128 + 1 + p);\n"),
    ("      uint4* out = pairs + static_cast<size_t>(r0) * KC;\n",
     "      uint4* out = pairs + static_cast<size_t>(r0) * KC;\n"
     "      if (lane == 0) STAMP(g * 128 + 100);\n"),
    ("      for (int rr = 0; rr < rows; ++rr)\n        if (r0 + lane < n)",
     "      if (lane == 0) STAMP(g * 128 + 101);\n"
     "      for (int rr = 0; rr < rows; ++rr)\n        if (r0 + lane < n)"),
    ("        warp_rotations<KC, SIGN>(x, lane == j, kc, &sh.diag[j][j], eps, sh.bsh, sh.rot);\n",
     "        if (g == 3 && lane == 31) { g_stamp_col = j; STAMP(200000 + j * 8); }\n"
     "        warp_rotations<KC, SIGN>(x, lane == j, kc, &sh.diag[j][j], eps, sh.bsh, sh.rot);\n"
     "        if (g == 3 && lane == 31) STAMP(200000 + j * 8 + 1);\n"),
    ("        if (lane > j) sh.diag[lane][j] = rotate_row<KC, SIGN>(sh.diag[lane][j], x, sh.rot, kc);\n"
     "        __syncwarp();\n",
     "        if (g == 3 && lane == 31) STAMP(200000 + j * 8 + 2);\n"
     "        if (lane > j) sh.diag[lane][j] = rotate_row<KC, SIGN>(sh.diag[lane][j], x, sh.rot, kc);\n"
     "        if (g == 3 && lane == 31) STAMP(200000 + j * 8 + 3);\n        __syncwarp();\n"),
    ("  const float b = lane < kc ? bsh[lane] : 0.f;\n",
     "  const float b = lane < kc ? bsh[lane] : 0.f;\n"
     "  if (blockIdx.x == 3 && lane == 31) STAMP(200000 + g_stamp_col * 8 + 4);\n"),
    ("  float p = fmaf(a, a, sq);\n",
     "  if (blockIdx.x == 3 && lane == 31) STAMP(200000 + g_stamp_col * 8 + 5);\n"
     "  float p = fmaf(a, a, sq);\n"),
    ("  const bool live = b != 0.f;\n",
     "  if (blockIdx.x == 3 && lane == 31) STAMP(200000 + g_stamp_col * 8 + 6);\n"
     "  const bool live = b != 0.f;\n"),
]
# substitution: block b's stamps of step s at (b·256 + s)·8 + slot (thread 0):
# 0 top, 1 before the solve, 6 after it, 2 before the branch, 7 after the
# lookahead's first update, 3 once the pushed panel (or the barrier) is in,
# 4 end of the step
TRISOLVE = [
    ("    const bool solving = owner(p) == rank;\n",
     "    const bool solving = owner(p) == rank;\n"
     "    const int stamp = (blockIdx.x * 256 + s) * 8;\n    if (tid == 0) STAMP(stamp);\n"),
    ("    if (solving && solver_warp) {\n      const int to",
     "    if (tid == 0) STAMP(stamp + 1);\n    if (solving && solver_warp) {\n      const int to"),
    ("    cluster_arrive();\n    if (ahead) {",
     "    if (tid == 0) STAMP(stamp + 6);\n    cluster_arrive();\n    if (tid == 0) STAMP(stamp + 2);\n"
     "    if (ahead) {"),
    ("      if (s >= 1 && back(s - 1) == back(s)) update_rows<KT>(rows_of(next), T2, y);\n",
     "      if (s >= 1 && back(s - 1) == back(s)) update_rows<KT>(rows_of(next), T2, y);\n"
     "      if (tid == 0) STAMP(stamp + 7);\n"),
    ("      mbar_wait(&pushed, pushes++ & 1u);\n",
     "      mbar_wait(&pushed, pushes++ & 1u);\n      if (tid == 0) STAMP(stamp + 3);\n"),
    ("      cluster_wait();\n      // a block with rows left",
     "      cluster_wait();\n      if (tid == 0) STAMP(stamp + 3);\n      // a block with rows left"),
    ("    deferred = ahead;\n", "    if (tid == 0) STAMP(stamp + 4);\n    deferred = ahead;\n"),
]


def patch(path: Path, places, after: str, namespace: str) -> None:
    src = path.read_text()
    if after not in src:
        raise SystemExit(f"{path.name}: no {after!r} to put the stamps after")
    src = src.replace(after, after + STAMPS, 1)
    for old, new in places:
        if src.count(old) != 1:
            raise SystemExit(f"{path.name}: the place {old[:50]!r} is not there once; "
                             "update tools/triangular_trace.py to the source")
        src = src.replace(old, new)
    src += ("\nextern \"C\" int repro_stamps(void* host, int n) {\n"
            f"  return cudaMemcpyFromSymbol(host, {namespace}g_stamp, n * 16);\n}}\n")
    path.write_text(src)


def main() -> int:
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    cholup = importlib.import_module("repro_torch.kernels.cholupdate")
    serve = importlib.import_module("repro_torch.kernels.serve_solve")

    if not torch.cuda.is_available():
        print("triangular_trace: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    shutil.rmtree(OUT, ignore_errors=True)
    shutil.copytree(CSRC, OUT)
    patch(OUT / "cholupdate.cu", CHOLUPDATE, "namespace {\n", "")
    patch(OUT / "trisolve.cuh", TRISOLVE, "namespace repro {\n", "repro::")
    (OUT / "bench.cu").write_text(BENCH)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(OUT), "-o",
         str(OUT / f"lib{name}.so"), str(OUT / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in ("cholupdate", "serve_solve", "bench")}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the stamped {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in ("cholupdate", "serve_solve"):
        libs[name].repro_stamps.argtypes = [P, I]
        libs[name].repro_set_device(0)
    libs["cholupdate"].cholupdate_launch.argtypes = \
        cholup._SIGNATURES["cholupdate_launch"]
    libs["serve_solve"].trisolve_launch.argtypes = \
        serve._SIGNATURES["trisolve_launch"]
    libs["bench"].solve_bench_launch.argtypes = [P, I, I]

    def stamps(lib, first, count):
        buf = np.zeros((first + count, 2), dtype=np.uint64)
        if lib.repro_stamps(buf.ctypes.data, first + count):
            raise RuntimeError("reading the stamps failed")
        return buf[first:].astype(np.int64)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    ghz = torch.cuda.get_device_properties(0).clock_rate / 1e6
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in (1024, 2048):
        A = torch.randn((n, n), generator=gen, device="cuda")
        X = torch.randn((n, 16), generator=gen, device="cuda")
        L = torch.linalg.cholesky(A @ A.T + n * torch.eye(n, device="cuda"))
        L = L.contiguous()
        out = torch.empty_like(L)
        work = torch.empty((cholup.work_floats(n, 16),), device="cuda")
        for _ in range(3):
            if libs["cholupdate"].cholupdate_launch(
                    L.data_ptr(), X.data_ptr(), out.data_ptr(),
                    work.data_ptr(), n, 16, 1, stream()):
                raise RuntimeError("cholupdate failed")
        torch.cuda.synchronize()
        groups = n // 32
        st = stamps(libs["cholupdate"], 0, groups * 128).reshape(groups, 128, 2)
        start, end = st[:, 100], st[:, 101]
        panel = (end[:, 0] - start[:, 0]).mean()
        gap = (start[1:, 1] - end[:-1, 1]).mean()
        col = stamps(libs["cholupdate"], 200000, 32 * 8).reshape(32, 8, 2)[:, :, 0]

        def part(a, b):
            return (col[1:31, b] - col[1:31, a]).mean()
        print(f"cholupdate (n={n}, k=16): a panel's factorization {panel:.0f} "
              f"cycles ({panel / 32:.0f} a column), panel to panel {gap:.0f} ns, "
              f"whole sweep {end[-1, 1] - start[0, 1]} ns", flush=True)
        print(f"  a column (stamped, group 3): row broadcast {part(0, 4):.0f}, "
              f"scan {part(4, 5):.0f}, square root to ballot {part(5, 6):.0f}, "
              f"rest of the rotations {part(6, 1):.0f}, publish {part(1, 2):.0f}, "
              f"apply {part(2, 3):.0f}, to the next column "
              f"{(col[2:32, 0] - col[1:31, 3]).mean():.0f} cycles", flush=True)
    n = 1024
    S = torch.randn((n, 4 * n), generator=gen, device="cuda") / (4 * n) ** 0.5
    L = torch.linalg.cholesky(S @ S.T + 1e-3 * torch.eye(n, device="cuda"))
    L = L.contiguous()
    panels, steps = n // 64, 2 * (n // 64)
    own = [s % 8 if s < panels else (steps - 1 - s) % 8 for s in range(steps)]
    nxt = [own[s + 1] if s + 1 < steps else own[s] for s in range(steps)]
    # steps whose next owner differs and that do not touch the turn
    ok = [s for s in range(1, steps - 1)
          if nxt[s] != own[s] and s not in (panels - 1, panels)]
    for k in (1, 8):
        U = torch.randn((n, k), generator=gen, device="cuda")
        w = torch.empty_like(U)
        for _ in range(3):
            if libs["serve_solve"].trisolve_launch(
                    L.data_ptr(), U.data_ptr(), 1, n, k,
                    serve.trisolve_columns(n, k), w.data_ptr(), stream()):
                raise RuntimeError("trisolve failed")
        torch.cuda.synchronize()
        st = stamps(libs["serve_solve"], 0, 8 * 256 * 8).reshape(8, 256, 8, 2)

        def mean(f):
            return float(np.mean([f(s) for s in ok]))
        solve = mean(lambda s: st[own[s], s, 6, 0] - st[own[s], s, 1, 0]) / ghz
        begin = mean(lambda s: st[nxt[s], s, 0, 1] - st[own[s - 1], s - 1, 6, 1])
        arrive = mean(lambda s: st[nxt[s], s, 2, 0] - st[nxt[s], s, 0, 0]) / ghz
        first = mean(lambda s: st[nxt[s], s, 7, 0] - st[nxt[s], s, 2, 0]) / ghz
        wait = mean(lambda s: st[nxt[s], s, 3, 0] - st[nxt[s], s, 7, 0]) / ghz
        handoff = mean(lambda s: st[nxt[s], s, 3, 1] - st[own[s], s, 6, 1])
        last = mean(lambda s: st[nxt[s], s, 4, 0] - st[nxt[s], s, 3, 0]) / ghz
        step = float(np.mean(np.diff([st[own[s], s, 6, 1] for s in range(steps)])))
        print(f"trisolve (n={n}, k={k}), ns a step: solve {solve:.0f}; the next "
              f"owner starts its step {begin:+.0f} after the previous solve, "
              f"arrives at the barrier in {arrive:.0f}, stages and applies the "
              f"step before in {first:.0f}, waits {wait:.0f} for the push "
              f"(solved to taken {handoff:.0f}), applies it in {last:.0f}; "
              f"step {step:.0f}", flush=True)
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    for kt in (1, 8):
        for backward in (0, 1):
            if libs["bench"].solve_bench_launch(cycles.data_ptr(), kt, backward):
                raise RuntimeError("solve_bench failed")
            print(f"warp solve alone, {kt} column(s) "
                  f"{'backward' if backward else 'forward'}: "
                  f"{int(cycles.item())} cycles a 64-row block", flush=True)
    print(f"(clock {ghz:.3f} GHz) {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
