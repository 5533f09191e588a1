#!/usr/bin/env python3
"""A/B of the bf16 flash-attention kernel's two tensor-core designs on one
CUDA card.

``csrc/flash_attention.cu`` routes bf16 at hd 64 and 128 to the ``wgmma`` +
TMA kernel (``flash_wgmma.cuh``). This script builds a copy of that source
whose dispatch sends those head dims to the ``mma.sync`` kernel that came
before it (``launch_mma``, kept for hd 16 and 32), loads both libraries,
asserts that they agree (1e-2 of the largest |o|, the sweep's bf16 gate:
the two sum in other orders and round p at other running maxima), and
times them in turns (mma.sync, wgmma, wgmma, mma.sync) with CUDA events at
llama3.2-3b's layer shape (24 query / 8 KV heads, hd 128, bf16, causal),
T ∈ {1024, 8192, 32768}, beside ``scaled_dot_product_attention`` on the
same inputs (KV heads expanded outside the timed call; the port never
calls it).

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
TOL = 1e-2


def mma_version(out: Path) -> ctypes.CDLL:
    """A copy of the source with bf16 at hd 64 and 128 routed to mma.sync,
    built and loaded."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    patched = src
    for hd in (64, 128):
        wgmma = f"case {hd}: return fa3::launch<{hd}>("
        if src.count(wgmma) != 1:
            raise RuntimeError("flash_attention.cu's dispatch changed; update "
                               "this script")
        patched = patched.replace(wgmma, f"case {hd}: return launch_mma<{hd}>(")
    (out / "flash_mma.cu").write_text(patched)
    lib_path = out / "libflash_mma.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                        "-o", str(lib_path), str(out / "flash_mma.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
    lib = ctypes.CDLL(str(lib_path))
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
        lib = mma_version(Path(tmp))

        def mma(q, k, v):
            o = torch.empty_like(q)
            err = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, 1, H, KH,
                q.shape[1], k.shape[1], HD, HD ** -0.5, 1, 0,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"mma.sync version: CUDA error {err}")
            return o

        gen = torch.Generator(device="cuda").manual_seed(0)
        for T in SHAPES:
            q, k, v = (torch.randn((1, T, heads, HD), generator=gen, device="cuda")
                       .to(torch.bfloat16) for heads in (H, KH, KH))
            qt = q.transpose(1, 2)
            kt, vt = (t.repeat_interleave(H // KH, dim=2).transpose(1, 2) for t in (k, v))

            def wgmma():
                return ops.flash_attention(q, k, v, causal=True, mode="kernel")

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True)
            a, b = mma(q, k, v), wgmma()
            torch.cuda.synchronize()
            diff = float((a.float() - b.float()).abs().max() / b.float().abs().max())
            if not diff < TOL:
                raise AssertionError(f"T={T}: the two versions {diff:.3e} apart")
            iters = 3 if T > 8192 else 20
            t = [time_ms(lambda: mma(q, k, v), iters), time_ms(wgmma, iters),
                 time_ms(wgmma, iters), time_ms(lambda: mma(q, k, v), iters)]
            lib_ms = time_ms(sdpa, iters)
            tflop = 4 * HD * H * T * (T + 1) / 2 / 1e9
            print(f"T={T}: mma.sync {t[0]:.3f}/{t[3]:.3f} ms, wgmma {t[1]:.3f}/"
                  f"{t[2]:.3f} ms ({tflop / min(t[1], t[2]):.0f} TFLOP/s), SDPA "
                  f"{lib_ms:.3f} ms; outputs {diff:.2e} apart (max-abs over max)",
                  flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
