#!/usr/bin/env python3
"""The Appendix C "svda" baseline's SVD on one CUDA card: each cuSOLVER
driver ``torch.linalg.svd`` offers, on the quickstart's problem
(``examples_torch/quickstart.py``: n = 512, m = 100,000, λ = 1e-2, numpy
``default_rng(0)``), with the relative residual of the solve it gives,
how far its V is from orthonormal, and its time; then the port's
``core.solvers.svd_solve`` on the card and on the CPU. Why
``svd_solve`` names its driver on CUDA.

    python3 tools/svd_drivers.py        # on a machine with a CUDA card
"""
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import residual, svd_solve  # noqa: E402

N, M, LAM = 512, 100_000, 1e-2


def main() -> int:
    if not torch.cuda.is_available():
        print("svd_drivers: no CUDA device", file=sys.stderr)
        return 1
    rng = np.random.default_rng(0)
    S = torch.from_numpy((rng.normal(size=(N, M)) / np.sqrt(N))
                         .astype(np.float32)).cuda()
    v = torch.from_numpy(rng.normal(size=(M,)).astype(np.float32)).cuda()
    eye = torch.eye(N, device="cuda")
    for driver in (None, "gesvd", "gesvdj", "gesvda"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, s, Vt = torch.linalg.svd(S, full_matrices=False, driver=driver)
        Vt_v = Vt @ v
        x = Vt.T @ (Vt_v / (s * s + LAM)) + (v - Vt.T @ Vt_v) / LAM
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        orth = float((Vt @ Vt.T - eye).abs().max())
        print(f"driver {driver}: residual {float(residual(S, v, x, LAM)):.3e}"
              f", max |V Vᵀ − I| {orth:.2e}, {ms:.1f} ms (first call)",
              flush=True)
    print(f"svd_solve on the card: residual "
          f"{float(residual(S, v, svd_solve(S, v, LAM), LAM)):.3e}")
    Sc, vc = S.cpu(), v.cpu()
    print(f"svd_solve on the CPU: residual "
          f"{float(residual(Sc, vc, svd_solve(Sc, vc, LAM), LAM)):.3e}")
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
