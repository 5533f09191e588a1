"""Stochastic reconfiguration (paper §3) on the PyTorch port: complex
wavefunction, both Fisher conventions.

A toy variational state |ψ_θ⟩ over 10 spins with complex parameters is
optimized toward a target state by SR: S is the centered complex score
matrix, and the update solves (F + λI)δ = -∇E with

  * full complex Fisher  F = S†S   (mode="complex")
  * real-part Fisher     F = Re[S†S]  via S ← [Re S; Im S]  (mode="real_part")

The kernels are real-only, so complex scores take the plain versions on
every device. θ and the target are drawn from numpy generators (the
reference draws them with ``jax.random``).

    PYTHONPATH=src python examples_torch/sr_complex.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import center_scores, chol_solve
from repro_torch.core.device import resolve_device


def main(argv=None, emit=print, spins=10, iters=50):
    """``spins``: 2^spins amplitudes, summed exactly; ``iters`` SR steps a
    mode (the reference's 10 and 50)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs there)")
    dev = resolve_device(ap.parse_args(argv).device)
    L = spins

    spins = ((np.arange(2 ** L)[:, None] >> np.arange(L)) & 1) * 2.0 - 1.0
    basis = torch.from_numpy(spins.astype(np.float32)).to(dev)  # (2^L, L)
    feats = torch.cat([basis, basis * torch.roll(basis, 1, dims=1),
                       basis * torch.roll(basis, 2, dims=1),
                       torch.ones((2 ** L, 1), device=dev)], dim=1)
    P = feats.shape[1]     # complex parameters (m = P ≫ n is NOT needed
                           # here — this demo is about the SR modes)
    featc = feats.to(torch.complex64)

    def draw(seed, scale):
        return np.random.default_rng(seed).normal(size=(P,)) * scale

    target = torch.from_numpy(draw(42, 0.3)).to(dev, torch.complex64)

    def normalized(theta):
        logp = featc @ theta                          # log-linear ansatz
        logp = logp - torch.logsumexp(2 * logp.real, 0) / 2
        return torch.exp(logp)

    def energy(theta):
        """⟨ψ|H|ψ⟩ with H = -|t⟩⟨t| for the normalized target state t."""
        return -torch.abs(torch.vdot(normalized(target), normalized(theta))
                          ) ** 2

    theta0 = torch.from_numpy(draw(0, 0.1) + 1j * draw(1, 0.1)).to(
        dev, torch.complex64)

    def sr_step(th, mode):
        w = torch.softmax(2 * (featc @ th).real, 0)
        S = center_scores(featc, weights=w)
        # torch's gradient of a real loss in a complex leaf is the
        # conjugate of jax.grad's: the reference's conj(g) is g here
        g = torch.func.grad(lambda t: energy(t).real)(th)
        rhs = g if mode == "complex" else g.real
        delta = chol_solve(S, rhs, 1e-3, mode=mode)
        return th - 0.5 * delta.to(torch.complex64)

    out = {}
    for mode in ("complex", "real_part"):
        th = theta0.clone()
        for _ in range(iters):
            th = sr_step(th, mode)
        out[mode] = float(energy(th))
        emit(f"SR mode={mode:10s} final overlap energy "
             f"{out[mode]:+.4f} (perfect = -1.0, start "
             f"{float(energy(theta0)):+.4f})")
    return out


if __name__ == "__main__":
    main()
