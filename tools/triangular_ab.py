#!/usr/bin/env python3
"""A/B of the two triangular chains — the rank-k update ``cholupdate`` and
the substitution ``trisolve`` — against their previous designs on one CUDA
card.

The previous designs — ``cholupdate`` as one block sweeping a
column-major copy of L between two transposes, ``trisolve`` as one block
per right-hand-side column — are not kept in the package: this script
builds them from copies of their sources taken out of git history
(``cholupdate.cu``, ``serve_solve.cu`` and the headers they include), loads
them beside the current kernels and, through both designs' C entries:

* checks that ``cholupdate`` is bit-identical to the previous kernel (the
  same rotations in the same order with the same formulas) at every size
  it times and over a few ragged ones, update and downdate, and prints the
  largest difference where the previous kernel chunked X otherwise;
* checks that the two substitutions agree (``chip_smoke.py``'s PASS_TOL,
  1e-3 beyond n = 1024) and that each repeats bit for bit;
* times previous, current, current, previous with CUDA events at
  n ∈ {256, 1024, 2048}: ``cholupdate`` at k = 16, ``trisolve`` at k = 1
  and 8; the plain twins beside them.

    # where git is (the copies land in the git-ignored build/ab/prev/):
    python3 tools/triangular_ab.py --extract <commit of the previous designs>
    # on the card (needs nvcc):
    python3 tools/triangular_ab.py
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = "src/repro_torch/kernels/csrc"
FILES = ("cholupdate.cu", "serve_solve.cu", "common.cuh", "cross.cuh",
         "apply.cuh")
PREV = ROOT / "build" / "ab" / "prev"
SIZES = (256, 1024, 2048)
CHOLUP_K, TRISOLVE_K = 16, (1, 8)
RAGGED = ((24, 3), (100, 16), (130, 32), (1024, 40))   # (n, k), bit for bit
PASS_TOL = 1e-4       # chip_smoke.py's, 10× beyond n = 1024


def extract(rev: str) -> None:
    PREV.mkdir(parents=True, exist_ok=True)
    for name in FILES:
        src = subprocess.run(["git", "-C", str(ROOT), "show",
                              f"{rev}:{CSRC}/{name}"], capture_output=True,
                             text=True, check=True).stdout
        if name == "serve_solve.cu" and "trisolve.cuh" in src:
            raise SystemExit(f"{rev}:{CSRC}/{name} is not the previous design")
        (PREV / name).write_text(src)
    print(f"wrote {', '.join(FILES)} to {PREV} from {rev}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--extract", metavar="REV",
                    help="copy the previous sources out of git and stop")
    args = ap.parse_args()
    if args.extract:
        extract(args.extract)
        return 0

    import importlib

    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ops
    # the package exports functions of these names: take the modules
    cholup_mod = importlib.import_module("repro_torch.kernels.cholupdate")
    serve_mod = importlib.import_module("repro_torch.kernels.serve_solve")

    if not torch.cuda.is_available():
        print("triangular_ab: no CUDA device", file=sys.stderr)
        return 1
    if not all((PREV / name).exists() for name in FILES):
        print(f"triangular_ab: {PREV} incomplete; run --extract REV first",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    P, I = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name in ("cholupdate", "serve_solve"):
            so = Path(tmp) / f"lib{name}_prev.so"
            procs[name] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(PREV), "-o",
                 str(so), str(PREV / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        _build.build(("cholupdate", "serve_solve"))
        prev = {}
        for name, (so, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on the previous {name}.cu:\n"
                                   f"{log}")
            prev[name] = ctypes.CDLL(str(so))
        prev["cholupdate"].cholupdate_launch.argtypes = [P, P, P, P, I, I, I, P]
        prev["serve_solve"].trisolve_launch.argtypes = [P, P, I, I, I, P, P]
        for lib, fn in ((prev["cholupdate"], "cholupdate_launch"),
                        (prev["serve_solve"], "trisolve_launch")):
            getattr(lib, fn).restype = I
        cur = {"cholupdate": _build.library("cholupdate",
                                            cholup_mod._SIGNATURES),
               "serve_solve": _build.library("serve_solve",
                                             serve_mod._SIGNATURES)}

        def stream():
            return torch.cuda.current_stream().cuda_stream

        def check(err, what):
            if err:
                raise RuntimeError(f"{what}: CUDA error {err}")

        def cholup_prev(L, X, sign):
            n, k = X.shape
            work = torch.empty_like(L)
            out = torch.empty_like(L)
            check(prev["cholupdate"].cholupdate_launch(
                L.data_ptr(), X.data_ptr(), work.data_ptr(), out.data_ptr(),
                n, k, sign, stream()), "previous cholupdate")
            return out

        def cholup_cur(L, X, sign):
            n, k = X.shape
            out = torch.empty_like(L)
            work = torch.empty((cholup_mod.work_floats(n, k),), device="cuda")
            check(cur["cholupdate"].cholupdate_launch(
                L.data_ptr(), X.data_ptr(), out.data_ptr(), work.data_ptr(),
                n, k, sign, stream()), "cholupdate")
            return out

        def tri_prev(L, U):
            n, k = U.shape
            w = torch.empty_like(U)
            check(prev["serve_solve"].trisolve_launch(
                L.data_ptr(), U.data_ptr(), 1, n, k, w.data_ptr(), stream()),
                "previous trisolve")
            return w

        def tri_cur(L, U):
            n, k = U.shape
            w = torch.empty_like(U)
            check(cur["serve_solve"].trisolve_launch(
                L.data_ptr(), U.data_ptr(), 1, n, k,
                serve_mod.trisolve_columns(n, k), w.data_ptr(), stream()),
                "trisolve")
            return w

        def time_ms(fn, iters=20, warmup=3):
            for _ in range(warmup):
                fn()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / iters

        def rel(a, b):
            a, b = a.double(), b.double()
            return float((a - b).abs().max() / b.abs().max())

        def factor(n, k, sign, gen):
            A = torch.randn((n, n), generator=gen, device="cuda")
            X = torch.randn((n, k), generator=gen, device="cuda")
            W = A @ A.T + n * torch.eye(n, device="cuda")
            if sign < 0:
                W = W + X @ X.T
            return torch.linalg.cholesky(W).contiguous(), X

        gen = torch.Generator(device="cuda").manual_seed(0)
        shapes = [(n, CHOLUP_K) for n in SIZES] + list(RAGGED)
        for n, k in shapes:
            for sign in (1, -1):
                L, X = factor(n, k, sign, gen)
                a, b = cholup_prev(L, X, sign), cholup_cur(L, X, sign)
                torch.cuda.synchronize()
                if not torch.equal(b, ops.cholupdate(L, X, sign=sign)):
                    raise AssertionError("cholupdate: the C entry and ops "
                                         "differ")
                same = torch.equal(a.view(torch.int32), b.view(torch.int32))
                # the previous kernel took X in chunks of 32/⌈n/1024⌉₂ columns
                kc_old = 32 // (1 << ((n - 1) // 1024).bit_length())
                chunks_agree = kc_old == 32 or k <= kc_old
                print(f"cholupdate n={n} k={k} sign={sign:+d}: bit-identical "
                      f"to the previous kernel {same}"
                      + ("" if same else f" (max |diff| {rel(b, a):.2e} of max)"),
                      flush=True)
                if chunks_agree and not same:
                    raise AssertionError(f"cholupdate n={n} k={k}: not "
                                         "bit-identical to the previous kernel")
                if not rel(b, ops.cholupdate(L, X, sign=sign, mode="ref")) < 1e-5:
                    raise AssertionError(f"cholupdate n={n} k={k}: off the "
                                         "plain version")
                if (n, k) in RAGGED:
                    continue
                t = [time_ms(lambda: cholup_prev(L, X, sign)),
                     time_ms(lambda: cholup_cur(L, X, sign)),
                     time_ms(lambda: cholup_cur(L, X, sign)),
                     time_ms(lambda: cholup_prev(L, X, sign))]
                plain = time_ms(lambda: ops.cholupdate(L, X, sign=sign,
                                                       mode="ref"))
                print(f"  n={n} k={k} sign={sign:+d}: previous {t[0]:.4f}/"
                      f"{t[3]:.4f} ms, current {t[1]:.4f}/{t[2]:.4f} ms, plain "
                      f"(composed) {plain:.4f} ms", flush=True)
                del L, X
        for n in SIZES:
            S = torch.randn((n, 4 * n), generator=gen, device="cuda") / (4 * n) ** 0.5
            L = torch.linalg.cholesky(S @ S.T + 1e-3 * torch.eye(n, device="cuda"))
            L = L.contiguous()
            tol = PASS_TOL if n <= 1024 else 10 * PASS_TOL
            for k in TRISOLVE_K:
                U = torch.randn((n, k), generator=gen, device="cuda")
                a, b, again = tri_prev(L, U), tri_cur(L, U), tri_cur(L, U)
                torch.cuda.synchronize()
                diff = rel(b, a)
                if not torch.equal(b, again):
                    raise AssertionError(f"trisolve n={n} k={k}: repeat not "
                                         "bit-identical")
                if not (diff < tol and rel(b, ops.trisolve(L, U, mode="ref")) < tol):
                    raise AssertionError(f"trisolve n={n} k={k}: designs "
                                         f"{diff:.3e} apart")
                t = [time_ms(lambda: tri_prev(L, U)),
                     time_ms(lambda: tri_cur(L, U)),
                     time_ms(lambda: tri_cur(L, U)),
                     time_ms(lambda: tri_prev(L, U))]
                plain = time_ms(lambda: ops.trisolve(L, U, mode="ref"))
                print(f"trisolve n={n} k={k}: previous {t[0]:.4f}/{t[3]:.4f} "
                      f"ms, current {t[1]:.4f}/{t[2]:.4f} ms, plain "
                      f"{plain:.4f} ms; {diff:.2e} apart (max-abs over max)",
                      flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
