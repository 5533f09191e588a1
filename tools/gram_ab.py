#!/usr/bin/env python3
"""A/B of the Gram and ngd_apply kernels against their previous designs on
one CUDA card.

The previous designs — the Gram on fp32 FMAs for every window
(``gram_partial_kernel``, C entry ``gram_launch`` without the route flag)
and ngd_apply as the k = 1 instance of ``apply.cuh`` — are not kept in the
package: this script builds them from copies of their sources taken out
of git history, loads them beside the current kernels, checks that each
pair agrees, and times them in turns (previous, current, current,
previous) with CUDA events at n ∈ {256, 1024, 2048} × m = 100,000, fp32
and bf16 windows, beside one PyTorch call computing the same function
(the port never calls it), and prints each Gram's distance to the
float64 Gram (Frobenius, relative). Both designs are called through their C
entries by ctypes with the same few checks, so at n = 256, where a
kernel takes about as long as the ``ops`` wrapper's host work, the
comparison times the kernels and not the wrappers. It also builds the
previous ``flash_attention.cu`` (whose helpers now live in
``csrc/hopper.cuh``) and checks that the flash kernel's outputs are
bit-identical to it.

    # where git is (the copies land in the git-ignored build/ab/prev/):
    python3 tools/gram_ab.py --extract <commit of the previous designs>
    # on the card (needs nvcc):
    python3 tools/gram_ab.py
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
FILES = ("gram.cu", "ngd_apply.cu", "flash_attention.cu", "flash_wgmma.cuh",
         "apply.cuh", "common.cuh")
PREV = ROOT / "build" / "ab" / "prev"
SIZES = (256, 1024, 2048)
M, LAM = 100_000, 1e-3
AGREE = 1e-4          # chip_smoke.py's PASS_TOL, between the two designs


def extract(rev: str) -> None:
    PREV.mkdir(parents=True, exist_ok=True)
    for name in FILES:
        src = subprocess.run(["git", "-C", str(ROOT), "show",
                              f"{rev}:{CSRC}/{name}"], capture_output=True,
                             text=True, check=True).stdout
        if name == "gram.cu" and "gram_tc_kernel" in src:
            raise SystemExit(f"{rev}:{CSRC}/gram.cu is not the previous design")
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

    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.gram import (box_columns, gram_split,
                                          tensor_core_route)

    if not torch.cuda.is_available():
        print("gram_ab: no CUDA device", file=sys.stderr)
        return 1
    if not all((PREV / name).exists() for name in FILES):
        print(f"gram_ab: {PREV} incomplete; run --extract REV first",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    _build.build(("gram", "ngd_apply", "flash_attention"))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name in ("gram", "ngd_apply", "flash_attention"):
            so = Path(tmp) / f"lib{name}_prev.so"
            procs[name] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(PREV), "-o",
                 str(so), str(PREV / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        libs = {}
        for name, (so, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on the previous {name}.cu:\n"
                                   f"{log}")
            libs[name] = ctypes.CDLL(str(so))
        libs["gram"].gram_launch.argtypes = [P, I, P, P, P, P, P, P, I, I, I, I,
                                             I, P]
        libs["ngd_apply"].ngd_apply_launch.argtypes = [P, I, P, P, I, P, I, I,
                                                       F, P]
        libs["flash_attention"].flash_attention_launch.argtypes = [
            P, P, P, P, I, I, I, I, I, I, I, F, I, I, P]
        for lib in libs.values():
            for fn in ("gram_launch", "ngd_apply_launch",
                       "flash_attention_launch"):
                if hasattr(lib, fn):
                    getattr(lib, fn).restype = I

        def stream():
            return torch.cuda.current_stream().cuda_stream

        def check(err, what):
            if err:
                raise RuntimeError(f"{what}: CUDA error {err}")

        cur = {name: _build.library(name, sys.modules[
            f"repro_torch.kernels.{name}"]._SIGNATURES)
            for name in ("gram", "ngd_apply")}

        def gram(S, lib, *route):
            """W = S·Sᵀ by a gram_launch; ``route``: the current entry's
            tensor-core flag (none for the previous entry)."""
            n, m = S.shape
            depth = box_columns(S.dtype) if route and route[0] else 16
            tiles, Pn, chunk = gram_split(n, m, depth)
            part = torch.empty((Pn, tiles, 128, 128), device="cuda")
            W = torch.empty((n, n), device="cuda")
            check(lib.gram_launch(
                S.data_ptr(), int(S.dtype == torch.bfloat16), None, None,
                W.data_ptr(), None, part.data_ptr(), None, n, m, tiles, Pn,
                chunk, *route, stream()), "gram")
            return W

        def apply(S, w, v, lib):
            x = torch.empty((S.shape[1],), device="cuda")
            check(lib.ngd_apply_launch(
                S.data_ptr(), int(S.dtype == torch.bfloat16), w.data_ptr(),
                v.data_ptr(), int(v.dtype == torch.bfloat16), x.data_ptr(),
                S.shape[0], S.shape[1], LAM, stream()), "ngd_apply")
            return x

        def prev_flash(q, k, v):
            o = torch.empty_like(q)
            B, Tq, H, hd = q.shape
            check(libs["flash_attention"].flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, B,
                H, k.shape[2], Tq, k.shape[1], hd, hd ** -0.5, 1, 0, stream()),
                "flash_attention")
            return o

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

        gen = torch.Generator(device="cuda").manual_seed(0)
        for dtype in (torch.float32, torch.bfloat16):
            for n in SIZES:
                S = (torch.randn((n, M), generator=gen, device="cuda")
                     / M ** 0.5).to(dtype)
                v = torch.randn((M,), generator=gen, device="cuda").to(dtype)
                w = torch.randn((n,), generator=gen, device="cuda")
                vf = v.float()
                tc = int(tensor_core_route(n, M, dtype))
                pairs = {
                    "gram": (lambda: gram(S, libs["gram"]),
                             lambda: gram(S, cur["gram"], tc),
                             lambda: torch.matmul(S, S.T)),
                    "ngd_apply": (lambda: apply(S, w, v, libs["ngd_apply"]),
                                  lambda: apply(S, w, v, cur["ngd_apply"]),
                                  lambda: torch.addmv(vf, S.T.float(), w,
                                                      beta=1 / LAM,
                                                      alpha=-1 / LAM)
                                  if dtype == torch.float32 else None),
                }
                for name, (old, new, lib) in pairs.items():
                    a, b = old(), new()
                    torch.cuda.synchronize()
                    if not torch.equal(b, (ops.gram(S) if name == "gram" else
                                           ops.ngd_apply(S, w, v, LAM))):
                        raise AssertionError(f"{name}: the C entry and ops "
                                             "differ")
                    diff = rel(b, a)
                    if not diff < AGREE:
                        raise AssertionError(f"{name} n={n} {dtype}: designs "
                                             f"{diff:.3e} apart")
                    t = [time_ms(old), time_ms(new), time_ms(new), time_ms(old)]
                    lib_ms = time_ms(lib) if dtype == torch.float32 else None
                    print(f"{name} {n}x{M} {str(dtype)[6:]}: previous "
                          f"{t[0]:.4f}/{t[3]:.4f} ms, current {t[1]:.4f}/"
                          f"{t[2]:.4f} ms, library "
                          f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}; "
                          f"{diff:.2e} apart (max-abs over max)", flush=True)
                    if name == "gram":
                        W64 = S.double() @ S.double().T
                        Sf = S.float()
                        frob = {k: float((W.double() - W64).norm() / W64.norm())
                                for k, W in (("previous", a), ("current", b),
                                             ("fp32 matmul", Sf @ Sf.T))}
                        del W64
                        print("  vs the float64 Gram (Frobenius): " + ", ".join(
                            f"{k} {e:.2e}" for k, e in frob.items()), flush=True)
                del S
        for T, hd in ((1024, 128), (8192, 128), (1000, 64)):
            q = torch.randn((1, T, 24, hd), generator=gen,
                            device="cuda").to(torch.bfloat16)
            k, v = (torch.randn((1, T, 8, hd), generator=gen,
                                device="cuda").to(torch.bfloat16)
                    for _ in range(2))
            same = torch.equal(prev_flash(q, k, v),
                               ops.flash_attention(q, k, v, causal=True,
                                                   mode="kernel"))
            print(f"flash_attention (1, {T}, 24/8, {hd}) bf16 causal: "
                  f"bit-identical to the previous build {same}", flush=True)
            if not same:
                raise AssertionError("flash attention moved with hopper.cuh")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
