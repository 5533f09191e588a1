"""The port's examples (``examples_torch/``) stay green: the quickstart at
``tests/test_examples.py``'s reduced shape under the reference's checks
and beside the reference quickstart's residuals on the same inputs, the
other four at CPU-sized arguments on ``device="cpu"``."""
import importlib.util
import os

import numpy as np
import pytest

_ROOT = os.path.join(os.path.dirname(__file__), "..")


def _load(folder, name):
    spec = importlib.util.spec_from_file_location(
        f"{folder}_{name}", os.path.join(_ROOT, folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_at_reduced_shape_against_the_reference():
    pytest.importorskip("jax")
    kw = dict(n=32, m=1_500, lam=1e-2, steps=3)
    lines = []
    results = _load("examples_torch", "quickstart").main(
        **kw, emit=lines.append, device="cpu")
    assert set(results) == {"chol", "eigh", "svd", "cache"}
    for name in ("chol", "eigh", "svd"):
        _, r = results[name]
        assert r < 1e-2, (name, r)
    hits, refreshes = results["cache"]
    assert refreshes == 1 and hits == 2          # one Gram, two reuses
    assert any("curvature cache stats" in ln for ln in lines)
    assert len(lines) == 7
    # the same numpy inputs through the reference: fp32 residuals of the
    # same systems, each within a factor of 2 of the reference's
    want = _load("examples", "quickstart").main(**kw, emit=lambda _: None)
    assert want["cache"] == results["cache"]
    for name in ("chol", "eigh", "svd"):
        ratio = results[name][1] / want[name][1]
        assert 0.5 < ratio < 2, (name, results[name][1], want[name][1])


def test_ngd_mlp_train_on_the_cpu():
    lines = []
    h_ngd, h_adam = _load("examples_torch", "ngd_mlp_train").main(
        ["--steps", "5", "--device", "cpu"], emit=lines.append)
    assert lines[0].startswith("m = 20,864 parameters, n = 256 samples")
    assert len(h_ngd) == len(h_adam) == 6
    assert h_ngd[-1] < h_adam[-1] and h_ngd[-1] < 0.1 * h_ngd[0]


def test_lm_ngd_train_on_the_cpu(tmp_path):
    lines = []
    losses, report = _load("examples_torch", "lm_ngd_train").main(
        ["--steps", "3", "--batch", "4", "--seq", "16", "--device", "cpu",
         "--ckpt-dir", str(tmp_path / "ck")], emit=lines.append)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert report["completed"] and report["restarts"] == 0
    assert lines[-1].startswith("trained 3 steps; loss ")


def test_serve_lm_on_the_cpu():
    lines = []
    server, s = _load("examples_torch", "serve_lm").main(
        ["--device", "cpu", "--requests", "2", "--window", "4", "--seq", "8",
         "--new", "3"], emit=lines.append)
    assert s["served"] == 2
    assert lines[0].startswith("window factorized: n=4 m=")
    assert sum(ln.startswith("req ") for ln in lines) == 2
    assert any(ln.startswith("decoded 3 tokens") for ln in lines)
    assert lines[-1].startswith("served 2: p50 ")


def test_sr_complex_on_the_cpu():
    lines = []
    out = _load("examples_torch", "sr_complex").main(
        ["--device", "cpu"], emit=lines.append, spins=6, iters=30)
    assert set(out) == {"complex", "real_part"} and len(lines) == 2
    # the overlap energy is ≥ −1 up to fp32 rounding; the full complex
    # Fisher reaches the target, the real-part one stops short
    assert -1.0 - 1e-6 <= out["complex"] < -0.99
    assert out["complex"] < out["real_part"] < -0.5
