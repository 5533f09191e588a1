"""Exact damped NGD on an over-parameterized MLP (the paper's regime:
m ≫ n) vs AdamW — loss per optimizer step, on the PyTorch port.

    PYTHONPATH=src python examples_torch/ngd_mlp_train.py [--big] [--device cpu]

Default: m ≈ 90k params, n = 256 samples (seconds on CPU).
--big:    m ≈ 1.1M params (the paper's 10⁶ scale).

On the card (the default) each NGD step's solve runs on the hand-written
kernels (``ops.chol_solve_fused``); ``--device cpu`` runs their plain
versions.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.pytree import tree_map
from repro_torch.kernels import ops
from repro_torch.optim import AdamW, NaturalGradient, per_sample_scores


def predict(p, x):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    h = torch.tanh(h @ p["w2"] + p["b2"])
    return (h @ p["w3"])[..., 0]


# Damped least squares / Levenberg-Marquardt (paper §3): the score rows are
# the per-sample RESIDUAL Jacobian J_i = ∂r_i/∂θ, so (SᵀS + λI) is the
# damped Gauss-Newton metric and Algorithm 1 solves the LM step exactly.
def sample_obj(p, ex):
    x, y = ex
    return predict(p, x[None])[0] - y          # residual r_i


def main(argv=None, emit=print):
    ap = argparse.ArgumentParser()
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                    "plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    d_in, width = (64, 512) if args.big else (32, 128)
    n = 256
    rng = np.random.default_rng(0)

    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    params = {
        "w1": tensor(rng.normal(size=(d_in, width)) / d_in**0.5),
        "b1": tensor(np.zeros((width,))),
        "w2": tensor(rng.normal(size=(width, width)) / width**0.5),
        "b2": tensor(np.zeros((width,))),
        "w3": tensor(rng.normal(size=(width, 1)) / width**0.5),
    }
    m = sum(x.numel() for x in params.values())
    emit(f"m = {m:,} parameters, n = {n} samples  (m/n = {m / n:.0f})")

    X = tensor(rng.normal(size=(n, d_in)))
    y_true = torch.sin(3 * X[:, :1]).sum(-1) + 0.5 * torch.cos(X[:, 1])

    def loss(p):
        return torch.mean((predict(p, X) - y_true) ** 2)

    opt_ngd = NaturalGradient(1.0, damping=1e-3, momentum=0.0,
                              solver=ops.chol_solve_fused)
    opt_adam = AdamW(1e-2, weight_decay=0.0)

    def ngd_step(p, opt_state):
        g = torch.func.grad(lambda q: 0.5 * loss(q))(p)   # ∇(½ MSE) = Jᵀr/n
        S = per_sample_scores(sample_obj, p, (X, y_true))
        return opt_ngd.update(g, opt_state, p, scores=S)

    def run(kind):
        p = tree_map(torch.clone, params)
        hist = [float(loss(p))]
        st = (opt_ngd if kind == "ngd" else opt_adam).init(p)
        for _ in range(args.steps):
            if kind == "ngd":
                upd, st = ngd_step(p, st)
            else:
                upd, st = opt_adam.update(torch.func.grad(loss)(p), st, p)
            p = tree_map(torch.add, p, upd)
            hist.append(float(loss(p)))
        return hist

    t0 = time.perf_counter()
    h_ngd = run("ngd")
    t_ngd = time.perf_counter() - t0
    t0 = time.perf_counter()
    h_adam = run("adam")
    t_adam = time.perf_counter() - t0

    emit(f"{'step':>5s} {'NGD(chol)':>12s} {'AdamW':>12s}")
    for s in range(0, args.steps + 1, max(args.steps // 10, 1)):
        emit(f"{s:5d} {h_ngd[s]:12.5f} {h_adam[s]:12.5f}")
    emit(f"\nNGD reaches {h_ngd[-1]:.5f} in {args.steps} steps "
         f"({t_ngd:.1f}s); AdamW reaches {h_adam[-1]:.5f} ({t_adam:.1f}s)")
    assert h_ngd[-1] < h_adam[-1], "NGD should win per-step on this problem"
    return h_ngd, h_adam


if __name__ == "__main__":
    main()
