"""The tenant factor view of the torch port against ``repro.tenants``:
``project_rows`` and ``delta_fold`` (dense and blocked windows, the FIFO
wraparound), ``delta_correction``, ``delta_factor`` (the plain composed
method) and ``tenant_factorization`` (through ``CholFactorization.update``
/ ``downdate``, i.e. ``ops.cholupdate``), the private-window oracle, the
empty delta bit for bit, and ``delta_nbytes``; and — on a machine with
CUDA — ``tenant_factorization`` on the rotation kernel against
``delta_factor``.

The correction's columns are never compared across packages: the r×r
core's eigenvector signs (and the basis of a repeated eigenvalue) differ
between numpy/JAX and torch, so the tests compare up·up† − down·down† and
the tenant factor L_t, which are unique. Every input is drawn from a
fixed numpy seed. Tolerances: 1e-5 relative for projections, factors and
the correction form (fp32 on both sides); 1e-4 for solves; 5e-3 against
the private-window oracle (``tests/test_tenants.py``'s bound).
"""
import numpy as np
import pytest
import torch

from _torch_parity import pair, rel
from repro_torch.core import BlockedScores, chol_solve
from repro_torch.kernels import ops
from repro_torch.serve import init_serve_state
from repro_torch.tenants import (augmented_window, delta_correction,
                                 delta_factor, delta_fold, delta_nbytes,
                                 init_tenant_delta, project_rows,
                                 tenant_factorization)

try:
    import jax.numpy as jnp
    from repro import tenants as jten
    from repro.core.operator import BlockedScores as JBlocked
    from repro.serve import init_serve_state as j_init
except ImportError:     # the GPU machine has no JAX; it runs `-m cuda` only
    jnp = jten = JBlocked = j_init = None

torch.set_num_threads(1)

TOL, SOLVE_TOL, BOUND = 1e-5, 1e-4, 5e-3
N, M, LAM0 = 10, 120, 0.1
WIDTHS = (50, 70)


def _dt(complex_):
    return "complex64" if complex_ else "float32"


def _draw(rng, shape, complex_):
    a = rng.normal(size=shape) / np.sqrt(M)
    return a + 1j * rng.normal(size=shape) / np.sqrt(M) if complex_ else a


def _states(complex_=False, blocked=False, seed=0):
    """The same base window in both packages (JAX state, port state)."""
    Sj, St = pair(_draw(np.random.default_rng(seed), (N, M), complex_),
                  _dt(complex_))
    if blocked:
        Sj = JBlocked.from_dense(Sj, WIDTHS)
        St = BlockedScores.from_dense(St, WIDTHS)
    return j_init(Sj, LAM0), init_serve_state(St, LAM0, device="cpu")


def _rows(k, complex_=False, seed=1, blocked=False):
    Rj, Rt = pair(_draw(np.random.default_rng(seed), (k, M), complex_),
                  _dt(complex_))
    if blocked:
        return (tuple(JBlocked.from_dense(Rj, WIDTHS).blocks),
                tuple(BlockedScores.from_dense(Rt, WIDTHS).blocks))
    return Rj, Rt


def _folded(js, ts, folds, rank, complex_=False, signs=None, blocked=False):
    """Both packages' deltas after ``folds`` folds of the given row counts;
    returns (jax delta, port delta, per-fold slots of each)."""
    dj = jten.init_tenant_delta(N, rank, dtype=js.S.dtype)
    dt = init_tenant_delta(N, rank, dtype=ts.S.dtype, device="cpu")
    slots = []
    for i, k in enumerate(folds):
        Rj, Rt = _rows(k, complex_, seed=10 + i, blocked=blocked)
        sg = None if signs is None else signs[i]
        dj, sj = jten.delta_fold(dj, jten.project_rows(js, Rj), signs=sg)
        dt, st = delta_fold(dt, project_rows(ts, Rt), signs=sg)
        slots.append((sj, st))
    return dj, dt, slots


def _form(up, down):
    return up @ up.conj().T - down @ down.conj().T if isinstance(
        up, jnp.ndarray) else up @ up.mH - down @ down.mH


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("blocked", [False, True], ids=["dense", "blocked"])
def test_project_rows_and_fold_match_jax(complex_, blocked):
    js, ts = _states(complex_, blocked)
    Rj, Rt = _rows(3, complex_, blocked=blocked)
    Qj, Qt = jten.project_rows(js, Rj), project_rows(ts, Rt)
    assert Qt.shape == (N, 3) and rel(Qt, Qj) < TOL
    dj, dt, slots = _folded(js, ts, (3,), 4, complex_, blocked=blocked)
    assert slots[0][1] == slots[0][0] == (0, 1, 2)
    assert (dt.cursor, dt.age, dt.filled) == (int(dj.cursor), int(dj.age),
                                              int(dj.filled)) == (3, 1, 3)
    assert rel(dt.cols, dj.cols) < TOL
    assert torch.equal(dt.signs, torch.from_numpy(np.array(dj.signs)))


def test_fifo_wraparound_matches_jax():
    js, ts = _states(seed=2)
    dj, dt, slots = _folded(js, ts, (2, 1, 2), 3,
                            signs=[None, None, [1.0, -1.0]])
    assert [st for _, st in slots] == [sj for sj, _ in slots] == \
        [(0, 1), (2,), (0, 1)]
    assert (dt.cursor, dt.age) == (int(dj.cursor), int(dj.age)) == (2, 3)
    assert rel(dt.cols, dj.cols) < TOL
    assert dt.signs.tolist() == np.asarray(dj.signs).tolist() == \
        [1.0, -1.0, 1.0]
    with pytest.raises(ValueError, match="rank-3"):
        delta_fold(dt, torch.zeros((N, 4)))
    with pytest.raises(ValueError, match="rows"):
        delta_fold(dt, torch.zeros((N + 1, 2)))


CORRECTION_CASES = {
    "plus": ((3,), None),                       # all +1: a pure downdate
    "mixed": ((2, 2), [None, [1.0, -1.0]]),     # both parts
    "partial": ((1,), None),                    # three empty slots
}


@pytest.mark.parametrize("case", list(CORRECTION_CASES))
@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_tenant_factor_matches_jax(case, complex_):
    folds, signs = CORRECTION_CASES[case]
    js, ts = _states(complex_, seed=3)
    dj, dt, _ = _folded(js, ts, folds, 4, complex_, signs)
    uj, wj, cj = jten.delta_correction(dj, js.lam0, return_cond=True)
    ut, wt, ct = delta_correction(dt, ts.lam0, return_cond=True)
    assert rel(_form(ut, wt), _form(uj, wj)) < TOL
    assert float(ct) == pytest.approx(float(cj), rel=TOL)
    if case == "plus":
        assert not ut.any()                   # adding curvature downdates
    # L_t three ways: the composed delta_factor, the factorization view,
    # and the reference's
    Lj = jten.delta_factor(dj, js.L, js.lam0)
    Lt = delta_factor(dt, ts.L, ts.lam0)
    fac = tenant_factorization(ts, dt)
    assert rel(Lt, Lj) < TOL and rel(fac.L, Lj) < TOL
    jfac = jten.tenant_factorization(js, dj)
    assert rel(fac.L, jfac.L) < TOL and rel(fac.W, jfac.W) < TOL
    assert fac.S is ts.S                      # the window is shared
    Lc, cond = delta_factor(dt, ts.L, ts.lam0, return_cond=True)
    assert torch.equal(Lc, Lt) and torch.equal(cond, ct)


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_tenant_solve_matches_private_window(complex_):
    js, ts = _states(complex_, seed=4)
    dj, dt, _ = _folded(js, ts, (3,), 4, complex_)
    vj, vt = pair(_draw(np.random.default_rng(5), (M,), complex_) * M,
                  _dt(complex_))
    got = tenant_factorization(ts, dt).solve(vt)
    S_aug = augmented_window(ts, dt)
    assert S_aug.shape == (N + 4, M)
    assert rel(S_aug, jten.augmented_window(js, dj)) < TOL
    oracle = chol_solve(S_aug, vt, ts.lam0,
                        mode="complex" if complex_ else "auto")
    assert float((got - oracle).norm() / oracle.norm()) < BOUND
    assert rel(got, jten.tenant_factorization(js, dj).solve(vj)) < SOLVE_TOL


def test_empty_delta_factor_is_base_bitwise():
    _, ts = _states(seed=6)
    empty = init_tenant_delta(N, 4, device="cpu")
    up, down = delta_correction(empty, ts.lam0)
    assert not up.any() and not down.any()
    fac = tenant_factorization(ts, empty)
    assert torch.equal(fac.L.view(torch.int32), ts.L.view(torch.int32))
    assert torch.equal(delta_factor(empty, ts.L, ts.lam0).view(torch.int32),
                       ts.L.view(torch.int32))
    *_, cond = delta_correction(empty, ts.lam0, return_cond=True)
    assert float(cond) == 1.0


def test_tenant_factorization_mixed_lambda_and_cached_factor():
    js, ts = _states(seed=7)
    dj, dt, _ = _folded(js, ts, (2,), 3)
    got = tenant_factorization(ts, dt, lam=0.3)
    want = jten.tenant_factorization(js, dj, lam=0.3)
    assert got.lam == pytest.approx(0.3) and rel(got.L, want.L) < TOL
    cached = tenant_factorization(ts, dt, L=got.L)
    assert cached.L is got.L and cached.S is ts.S


def test_delta_bytes_and_window_guards_match_jax():
    for n, r in ((64, 8), (128, 8), (64, 16), (256, 4)):
        assert delta_nbytes(init_tenant_delta(n, r, device="cpu")) == \
            jten.delta_nbytes(jten.init_tenant_delta(n, r))
    js, ts = _states(seed=8)
    _, dt, _ = _folded(js, ts, (2,), 2, signs=[[1.0, -1.0]])
    with pytest.raises(ValueError, match="negative"):
        augmented_window(ts, dt)
    _, tb = _states(blocked=True)
    with pytest.raises(NotImplementedError):
        augmented_window(tb, init_tenant_delta(N, 2, device="cpu"))
    with pytest.raises(ValueError, match="rank"):
        init_tenant_delta(N, 0, device="cpu")


# ---------------------------------------------------------------------------
# on the card: the tenant view through the rotation kernel
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("signs", [None, [1.0, -1.0, 1.0, -1.0]],
                         ids=["plus", "mixed"])
def test_cuda_tenant_factorization_on_the_kernel(signs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100 via chip_smoke "
                    "and `pytest -m cuda`)")
    n, m, lam0 = 256, 20_000, 1e-3
    g = torch.Generator(device="cuda").manual_seed(3)
    S = torch.randn((n, m), generator=g, device="cuda") / m ** 0.5
    state = init_serve_state(S, lam0)
    delta = init_tenant_delta(n, 8)
    for _ in range(2):
        rows = torch.randn((4, m), generator=g, device="cuda") / m ** 0.5
        delta, _ = delta_fold(delta, project_rows(state, rows), signs=signs)
    ops.reset_launch_counts()
    fac = tenant_factorization(state, delta)
    torch.cuda.synchronize()
    assert ops.launch_counts()["cholupdate"] == 2
    assert rel(fac.L, delta_factor(delta, state.L, lam0)) < TOL
    empty = tenant_factorization(state, init_tenant_delta(n, 8))
    assert torch.equal(empty.L.view(torch.int32), state.L.view(torch.int32))
