#!/usr/bin/env python3
"""A/B of the bf16 flash-attention kernel's two versions on one CUDA card.

The first version ran bf16 attention as fp32 FMAs on the CUDA cores; the
second runs it on the tensor cores (``mma.sync``). Both live in
``src/repro_torch/kernels/csrc/flash_attention.cu``, which routes bf16 at
hd ≤ 128 to the second. This script builds a copy of that source whose
bf16 calls all take the first version, loads both libraries, checks they
agree, and times them in turns (first, second, second, first) with CUDA
events at llama3.2-3b's layer shape (24 query / 8 KV heads, hd 128, bf16,
causal), T ∈ {1024, 8192, 32768}.

    python3 tools/flash_attention_ab.py        # needs a GPU and nvcc
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build, ops  # noqa: E402

SHAPES = (1024, 8192, 32768)
H, KH, HD = 24, 8, 128


def first_version(out: Path) -> ctypes.CDLL:
    """The source with bf16 routed to the CUDA-core kernel, built and loaded."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    v1 = src.replace("  if (bf16) {   // the tensor cores",
                     "  if (bf16 && hd < 0) {   // the tensor cores")
    v1 = v1.replace(
        "  return dispatch<float>(q, k, v, o, B, H, KH, Tq, Tk, hd, scale, causal, window, st);",
        "  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, H, KH, Tq, Tk, hd, scale,"
        " causal, window, st)\n              : dispatch<float>(q, k, v, o, B, H, KH, Tq, Tk,"
        " hd, scale, causal, window, st);")
    if v1.count("hd < 0") != 1 or v1.count("return bf16 ?") != 1:
        raise RuntimeError("flash_attention.cu's dispatch changed; update this script")
    (out / "v1.cu").write_text(v1)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                        "-o", str(out / "libv1.so"), str(out / "v1.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
    lib = ctypes.CDLL(str(out / "libv1.so"))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_launch.argtypes = [P, P, P, P, I, I, I, I, I, I, I, F, I, I, P]
    lib.flash_attention_launch.restype = I
    return lib


def time_ms(fn, iters: int, warmup: int = 1) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_attention_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    _build.build(("flash_attention",))
    with tempfile.TemporaryDirectory() as tmp:
        lib = first_version(Path(tmp))

        def v1(q, k, v):
            o = torch.empty_like(q)
            err = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, 1, H, KH,
                q.shape[1], k.shape[1], HD, HD ** -0.5, 1, 0,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"first version: CUDA error {err}")
            return o

        gen = torch.Generator(device="cuda").manual_seed(0)
        for T in SHAPES:
            q, k, v = (torch.randn((1, T, heads, HD), generator=gen, device="cuda")
                       .to(torch.bfloat16) for heads in (H, KH, KH))

            def v2():
                return ops.flash_attention(q, k, v, causal=True, mode="kernel")
            a, b = v1(q, k, v), v2()
            torch.cuda.synchronize()
            diff = float((a.float() - b.float()).abs().max() / b.float().abs().max())
            iters = 3 if T > 8192 else 20
            t = [time_ms(lambda: v1(q, k, v), iters), time_ms(v2, iters),
                 time_ms(v2, iters), time_ms(lambda: v1(q, k, v), iters)]
            print(f"T={T}: first version {t[0]:.3f}/{t[3]:.3f} ms, second "
                  f"{t[1]:.3f}/{t[2]:.3f} ms; outputs {diff:.2e} apart (max-abs "
                  "over max)", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
