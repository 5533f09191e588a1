#!/usr/bin/env python3
"""A/B of the Cholesky kernel against its previous design on one CUDA card.

The previous design (one launch per panel of 16, a last-block counter per
slab; C entry ``cholesky_launch(W, scratch, counters, L, n, stream)``) is
not kept in the package: this script builds it from a copy of its source
taken out of git history, loads it beside the current kernel
(``ops.cholesky``, one cooperative launch), checks they agree, and times
them in turns (previous, current, current, previous) with CUDA events at
n ∈ {256, 1024, 2048} on SPD W = A·Aᵀ/n + I, beside
``torch.linalg.cholesky`` on the same W (the port never calls it).

    # where git is (the copy lands in the git-ignored build/ab/):
    python3 tools/cholesky_ab.py --extract <commit of the previous design>
    # on the card (needs nvcc):
    python3 tools/cholesky_ab.py
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = "src/repro_torch/kernels/csrc/cholesky.cu"
PREV = ROOT / "build" / "ab" / "cholesky_prev.cu"
SIZES = (256, 1024, 2048)
PANEL, SLAB = 16, 64        # the previous design's kPanel and kSlab


def extract(rev: str) -> None:
    src = subprocess.run(["git", "-C", str(ROOT), "show", f"{rev}:{SOURCE}"],
                         capture_output=True, text=True, check=True).stdout
    if "panel_kernel" not in src:
        raise SystemExit(f"{rev}:{SOURCE} is not the per-panel design")
    PREV.parent.mkdir(parents=True, exist_ok=True)
    PREV.write_text(src)
    print(f"wrote {PREV} from {rev}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--extract", metavar="REV",
                    help="copy the previous source out of git and stop")
    args = ap.parse_args()
    if args.extract:
        extract(args.extract)
        return 0

    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ops

    if not torch.cuda.is_available():
        print("cholesky_ab: no CUDA device", file=sys.stderr)
        return 1
    if not PREV.exists():
        print(f"cholesky_ab: {PREV} missing; run --extract REV first",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    _build.build(("cholesky",))
    with tempfile.TemporaryDirectory() as tmp:
        so = Path(tmp) / "libcholesky_prev.so"
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                            "-o", str(so), str(PREV)], capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
        lib = ctypes.CDLL(str(so))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.cholesky_launch.argtypes = [P, P, P, P, I, P]
        lib.cholesky_launch.restype = I

        def prev(W):
            n = W.shape[0]
            slabs = -(-n // SLAB)
            scratch = torch.empty((slabs * n * PANEL + slabs * slabs * PANEL * PANEL,),
                                  device="cuda")
            counters = torch.empty((slabs,), dtype=torch.int32, device="cuda")
            L = torch.empty_like(W)
            err = lib.cholesky_launch(W.data_ptr(), scratch.data_ptr(),
                                      counters.data_ptr(), L.data_ptr(), n,
                                      torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"previous version: CUDA error {err}")
            return L

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

        gen = torch.Generator(device="cuda").manual_seed(0)
        for n in SIZES:
            A = torch.randn((n, n), generator=gen, device="cuda")
            W = A @ A.T / n + torch.eye(n, device="cuda")

            def cur():
                return ops.cholesky(W, mode="kernel")
            a, b = prev(W), cur()
            torch.cuda.synchronize()
            diff = float((a - b).abs().max() / b.abs().max())
            t = [time_ms(lambda: prev(W)), time_ms(cur), time_ms(cur),
                 time_ms(lambda: prev(W))]
            lib_ms = time_ms(lambda: torch.linalg.cholesky(W))
            print(f"n={n}: previous {t[0]:.4f}/{t[3]:.4f} ms, current "
                  f"{t[1]:.4f}/{t[2]:.4f} ms, torch.linalg.cholesky "
                  f"{lib_ms:.4f} ms; factors {diff:.2e} apart (max-abs over max)",
                  flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
