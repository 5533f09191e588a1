"""Rank-k factor algebra of the torch port against ``repro.curvature``:
both methods of ``chol_update``/``chol_downdate``, the ``DowndateAux``
margins, ``replace_factors``, ``chol_append`` and ``chol_drop_leading``.

The factor L′ is compared, not the split parts X, Y: eigenvector signs
of the 2k×2k core may differ between the packages while X·Xᵀ does not.
The margins reproduce the reference's numbers, including where its two
methods report different quantities (1 − σ_max(P)² for the composed
method, the minimum relative pivot margin for the rotations).
"""
import numpy as np
import pytest
import torch

from _torch_parity import pair, rel
from repro.curvature import update as jup
from repro_torch.curvature import update as tup

torch.set_num_threads(1)

TOL = 1e-5
N = 12


def _factor(complex_, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(N, 3 * N))
    if complex_:
        A = A + 1j * rng.normal(size=(N, 3 * N))
    W = A @ A.conj().T / (3 * N) + 0.5 * np.eye(N)
    dt = "complex64" if complex_ else "float32"
    return pair(np.linalg.cholesky(W), dt), rng, dt


def _cols(rng, k, complex_, scale):
    X = rng.normal(size=(N, k))
    if complex_:
        X = X + 1j * rng.normal(size=(N, k))
    return X * scale


@pytest.mark.parametrize("method", ["composed", "rotations"])
@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("k", [1, 3])
def test_update_downdate_match_jax(method, complex_, k):
    (Lj, Lt), rng, dt = _factor(complex_)
    Xj, Xt = pair(_cols(rng, k, complex_, 0.3), dt)
    Uj = jup.chol_update(Lj, Xj, method=method)
    Ut = tup.chol_update(Lt, Xt, method=method)
    assert rel(Ut, Uj) < TOL
    Dj = jup.chol_downdate(Uj, Xj, method=method)
    Dt = tup.chol_downdate(Ut, Xt, method=method)
    assert rel(Dt, Dj) < TOL and rel(Dt, Lt) < 1e-4
    assert torch.equal(torch.triu(Dt, 1), torch.zeros_like(Dt))


@pytest.mark.parametrize("method", ["composed", "rotations"])
@pytest.mark.parametrize("f", [0.5, 0.999])
def test_downdate_aux_margins_match_jax(method, f):
    """Downdating L·Lᵀ by f·(a column of L): the margin decays toward
    singularity as f → 1, as the reference computes it per method."""
    (Lj, Lt), _, _ = _factor(False, seed=1)
    Xj, Xt = Lj[:, 2] * f, Lt[:, 2] * f
    Dj, aj = jup.chol_downdate(Lj, Xj, method=method, return_aux=True)
    Dt, at = tup.chol_downdate(Lt, Xt, method=method, return_aux=True)
    assert rel(Dt, Dj) < 1e-3 * (1 if f < 0.9 else 10)
    assert float(at.margin) == pytest.approx(float(aj.margin), rel=1e-3,
                                             abs=1e-6)
    assert float(at.min_pivot) == pytest.approx(float(aj.min_pivot),
                                                rel=1e-3, abs=1e-6)
    assert bool(at.clamped) == bool(aj.clamped) is False


@pytest.mark.parametrize("method", ["composed", "rotations"])
def test_invalid_downdate_flags_clamp(method):
    (Lj, Lt), _, _ = _factor(False, seed=2)
    Xj, Xt = Lj[:, 0] * 3.0, Lt[:, 0] * 3.0
    _, aj = jup.chol_downdate(Lj, Xj, method=method, return_aux=True)
    _, at = tup.chol_downdate(Lt, Xt, method=method, return_aux=True)
    assert bool(at.clamped) == bool(aj.clamped) is True
    assert float(at.margin) == pytest.approx(float(aj.margin), rel=1e-4)


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_replace_factors_refreshes_factor_like_jax(complex_):
    (Lj, Lt), rng, dt = _factor(complex_, seed=3)
    W = np.asarray(Lj, np.complex128) @ np.asarray(Lj, np.complex128).conj().T
    if not complex_:
        W = W.real
    Wj, Wt = pair(W, dt)
    idx = [4, 5]
    new = _cols(rng, 2, complex_, 0.2) + W[:, idx]
    new[idx, :] = (new[idx, :] + new[idx, :].conj().T) / 2
    nj, nt = pair(new, dt)
    Xj, Yj, Wpj = jup.replace_factors(Wj, nj, np.asarray(idx))
    Xt, Yt, Wpt = tup.replace_factors(Wt, nt, torch.tensor(idx))
    assert rel(Wpt, Wpj) < TOL
    Lpj = jup.chol_downdate(jup.chol_update(Lj, Xj), Yj)
    Lpt = tup.chol_downdate(tup.chol_update(Lt, Xt), Yt)
    assert rel(Lpt, Lpj) < 1e-4
    # the split reproduces the replacement: L'L'† = W'
    Lp = Lpt.to(torch.complex128)
    assert rel(Lp @ Lp.mH, Wpt.to(torch.complex128)) < 1e-4
    # and X·X† − Y·Y† = W' − W exactly as the core says
    D = Xt.to(torch.complex128) @ Xt.to(torch.complex128).mH \
        - Yt.to(torch.complex128) @ Yt.to(torch.complex128).mH
    assert rel(D, (Wpt - Wt).to(torch.complex128)) < 1e-4


def test_append_and_drop_leading_match_jax():
    (Lj, Lt), rng, _ = _factor(False, seed=4)
    B = rng.normal(size=(N, 2)) / 5
    C = B.T @ B + np.eye(2)
    Aj = jup.chol_append(Lj, *(pair(x)[0] for x in (B, C)))
    At = tup.chol_append(Lt, *(pair(x)[1] for x in (B, C)))
    assert At.shape == (N + 2, N + 2) and rel(At, Aj) < TOL
    assert rel(tup.chol_drop_leading(At, 3), jup.chol_drop_leading(Aj, 3)) < TOL
