"""Quickstart: the paper's Algorithm 1 in five lines, on the PyTorch port.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

Solves (SᵀS + λI)x = v for m ≫ n without ever forming the m×m Fisher
matrix, checks the residual, compares against the two SVD baselines, and
shows the streaming-curvature cache amortizing repeat solves. On the
card (the default) Algorithm 1 runs on the hand-written kernels
(``ops.chol_solve_fused``: the Gram and S·v in one pass, the Cholesky,
the substitution, the apply pass); ``--device cpu`` runs their plain
versions.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import eigh_solve, residual, svd_solve
from repro_torch.core.device import resolve_device
from repro_torch.curvature import CurvatureCache, StreamingCurvature
from repro_torch.kernels import ops


def main(n=512, m=100_000, lam=1e-2, steps=3, emit=print, device=None):
    # κ(F) ≈ ‖S‖²/λ ≈ 2e4 → fp32 residual ~1e-3
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(0)
    S = torch.from_numpy((rng.normal(size=(n, m)) / np.sqrt(n))
                         .astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.normal(size=(m,)).astype(np.float32)).to(dev)

    results = {}
    for name, solver in [("chol (Algorithm 1)", ops.chol_solve_fused),
                         ("eigh (Appendix C)", eigh_solve),
                         ("svd  (Appendix C)", svd_solve)]:
        solver(S, v, lam)                                # warm-up
        sync()
        t0 = time.perf_counter()
        x = solver(S, v, lam)
        sync()
        dt = time.perf_counter() - t0
        r = float(residual(S, v, x, lam))
        results[name.split()[0]] = (dt, r)
        emit(f"{name:20s} {dt * 1e3:8.1f} ms   relative residual {r:.2e}")

    # streaming curvature: the O(n²m) Gram runs once, repeat solves reuse it
    cache = CurvatureCache(StreamingCurvature(n, refresh_every=steps + 1,
                                              device=dev))
    for s in range(steps):
        sync()
        t0 = time.perf_counter()
        x = cache.solve(S, v, lam)
        sync()
        dt = time.perf_counter() - t0
        tag = "refresh" if s == 0 else "cache hit"
        emit(f"curvature cache ({tag})  {dt * 1e3:8.1f} ms   "
             f"relative residual {float(residual(S, v, x, lam)):.2e}")
    stats = cache.stats
    emit(f"curvature cache stats: {int(stats.hits)} hits / "
         f"{int(stats.refreshes)} refreshes")
    results["cache"] = (int(stats.hits), int(stats.refreshes))
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                    "plain versions)")
    main(device=ap.parse_args().device)
