"""Algorithm 1's factorization in the torch port against the JAX package:
``chol_factorize``, ``solve(return_stats=True)``, ``solve_batch``,
``with_damping`` and ``update``/``downdate``, for dense and blocked windows
in the real, complex and real_part modes; plus the damping schedules.

Tolerance 1e-5 relative: both sides run fp32 at full precision, but the
reductions (Gram, Cholesky, triangular solves) sum in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import pair, rel
from repro.core import damping as jdamping
from repro.core.operator import BlockedScores as JBlocked
from repro.core.solvers import chol_factorize as j_factorize
from repro_torch.core import (BlockedScores, LevenbergMarquardtDamping,
                              auto_drift_tol, chol_factorize, residual)

torch.set_num_threads(1)

TOL = 1e-5
N, M, LAM = 16, 240, 0.3
WIDTHS = (100, 60, 80)


def _data(mode, seed=0):
    rng = np.random.default_rng(seed)
    S = rng.normal(size=(N, M)) / np.sqrt(M)
    V = rng.normal(size=(M, 3))
    if mode == "real":
        return pair(S), pair(V)
    S = S + 1j * rng.normal(size=(N, M)) / np.sqrt(M)
    V = V + 1j * rng.normal(size=(M, 3)) if mode == "complex" else V
    return pair(S, "complex64"), pair(V, "complex64" if mode == "complex"
                                      else "float32")


def _blocked(Sj, St):
    offs = np.cumsum((0,) + WIDTHS)
    sl = [slice(offs[i], offs[i + 1]) for i in range(len(WIDTHS))]
    return (JBlocked([Sj[:, s] for s in sl]),
            BlockedScores([St[:, s].contiguous() for s in sl]))


def _flat(x):
    if isinstance(x, tuple):
        return torch.cat(x) if isinstance(x[0], torch.Tensor) \
            else jnp.concatenate(x)
    return x


MODES = ["real", "complex", "real_part"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("blocked", [False, True], ids=["dense", "blocked"])
def test_factorize_and_solve_match_jax(mode, blocked):
    (Sj, St), (Vj, Vt) = _data(mode)
    if blocked:
        Sj, St = _blocked(Sj, St)
    jf = j_factorize(Sj, LAM, mode=mode)
    tf = chol_factorize(St, LAM, mode=mode)
    assert tf.mode == jf.mode
    assert rel(tf.W, jf.W) < TOL and rel(tf.L, jf.L) < TOL
    assert tf.lam == float(jf.lam)
    xt, st = tf.solve(Vt, return_stats=True)
    xj, sj = jf.solve(Vj, return_stats=True)
    assert rel(_flat(xt), _flat(xj)) < TOL
    assert abs(float(st.residual_norm) - float(sj.residual_norm)) < 1e-5
    assert abs(float(st.gram_cond_proxy) - float(sj.gram_cond_proxy)) \
        < 1e-5 * float(sj.gram_cond_proxy)
    # single RHS, flat (m,)
    assert rel(_flat(tf.solve(Vt[:, 0])), _flat(jf.solve(Vj[:, 0]))) < TOL


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("blocked", [False, True], ids=["dense", "blocked"])
def test_solve_batch_and_with_damping_match_jax(mode, blocked):
    (Sj, St), (Vj, Vt) = _data(mode, seed=1)
    if blocked:
        Sj, St = _blocked(Sj, St)
    jf = j_factorize(Sj, LAM, mode=mode)
    tf = chol_factorize(St, LAM, mode=mode)
    lams = [0.3, 0.05, 1.5]
    xt = tf.solve_batch(Vt, torch.tensor(lams))
    xj = jf.solve_batch(Vj, jnp.asarray(lams))
    assert rel(_flat(xt), _flat(xj)) < TOL
    t2, j2 = tf.with_damping(0.05), jf.with_damping(0.05)
    assert rel(t2.L, j2.L) < TOL
    assert rel(_flat(t2.solve(Vt)), _flat(j2.solve(Vj))) < TOL
    # with all λ equal, solve_batch is with_damping(λ).solve column for column
    same = tf.solve_batch(Vt, torch.full((3,), 0.05))
    assert rel(_flat(same), _flat(t2.solve(Vt))) < TOL


@pytest.mark.parametrize("mode", ["real", "complex"])
def test_update_downdate_match_jax(mode):
    (Sj, St), _ = _data(mode, seed=2)
    rng = np.random.default_rng(3)
    cols = rng.normal(size=(N, 2)) / 4
    if mode == "complex":
        cols = cols + 1j * rng.normal(size=(N, 2)) / 4
    cj, ct = pair(cols, "complex64" if mode == "complex" else "float32")
    jf, tf = j_factorize(Sj, LAM), chol_factorize(St, LAM)
    ju, tu = jf.update(cj), tf.update(ct)
    assert rel(tu.W, ju.W) < TOL and rel(tu.L, ju.L) < TOL
    assert tu.S.shape == (N, M + 2)
    jd, td = ju.downdate(cj, S_new=Sj), tu.downdate(ct, S_new=St)
    assert rel(td.L, jd.L) < TOL and rel(td.L, tf.L) < 1e-4


def test_residual_dense_and_blocked():
    (Sj, St), (Vj, Vt) = _data("real", seed=4)
    tf = chol_factorize(St, LAM)
    x = tf.solve(Vt)
    r = residual(St, Vt, x, LAM)
    _, Sb = _blocked(Sj, St)
    rb = residual(Sb, Vt, x, LAM)
    assert float(r) < 1e-5 and abs(float(rb) - float(r)) < 1e-6


def test_damping_schedules_match_jax():
    jd = jdamping.LevenbergMarquardtDamping(0.1)
    td = LevenbergMarquardtDamping(0.1)
    js, ts = jd.init(), td.init()
    for actual, pred in [(0.1, 1.0), (0.9, 1.0), (0.5, 1.0), (-1.0, 0.5)]:
        js = jd.update(js, actual_reduction=actual, predicted_reduction=pred)
        ts = td.update(ts, actual_reduction=actual, predicted_reduction=pred)
        assert float(ts.lam) == pytest.approx(float(js.lam), rel=1e-6)
        assert float(ts.last_ratio) == pytest.approx(float(js.last_ratio))
        assert float(auto_drift_tol(ts)) == pytest.approx(
            float(jdamping.auto_drift_tol(js)))
    assert float(auto_drift_tol(None)) == pytest.approx(0.25)
