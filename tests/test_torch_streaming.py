"""The rank-k factor update and the streaming curvature of the torch port
against the JAX package: ``ops.cholupdate``'s plain route against
``repro.kernels.ref.cholupdate_ref``, ``CholFactorization.update`` /
``downdate`` (dense, blocked, complex), ``StreamingGram`` /
``accumulate_gram`` in every mode and kind of piece, ``StreamingCurvature``
/ ``CurvatureCache`` over multi-step traces, and the audit (``condest``,
the residual probe fed the reference's own probes); and — on a machine
with CUDA — the rotation kernel against its plain version.

Every input is drawn from a fixed numpy seed. Tolerances: 1e-5 relative
for factors, Grams and exact solves (``tests/test_kernels.py:64``; fp32
on both sides, sums in other orders); 1e-4 for solves through a factor
updated k times, for the cache's solves and for the audit's estimates,
which chain triangular solves; the cache's counters exactly.
"""
import numpy as np
import pytest
import torch

from _torch_parity import pair, rel
from repro_torch.core import (BlockedScores, DampingState, LazyBlockedScores,
                              chol_factorize)
from repro_torch.curvature import (CurvatureCache, StreamingCurvature,
                                   StreamingGram, accumulate_gram,
                                   audit_factor, condest,
                                   factor_residual_probe)
from repro_torch.curvature import audit as taudit
from repro_torch.kernels import ops
from repro_torch.kernels.cholupdate import cholupdate_cuda

try:
    import jax
    import jax.numpy as jnp
    from repro import core as jcore
    from repro import curvature as jcurv
    from repro.curvature import audit as jaudit
    from repro.kernels import ref as jref
except ImportError:     # the GPU machine has no JAX; it runs `-m cuda` only
    jax = jnp = jcore = jcurv = jaudit = jref = None

torch.set_num_threads(1)

TOL, SOLVE_TOL = 1e-5, 1e-4
WIDTHS = (40, 30, 50)


def _complex_or_real(rng, shape, complex_):
    a = rng.normal(size=shape)
    return a + 1j * rng.normal(size=shape) if complex_ else a


def _dt(complex_):
    return "complex64" if complex_ else "float32"


def _spd_factor(rng, n, X, sign, complex_):
    """L0 of W = A·A† + n·I (plus X·X† for a downdate, so W − X·X† stays
    positive definite), as tests/test_kernels.py:52-60 builds it."""
    A = _complex_or_real(rng, (n, n), complex_)
    W = A @ A.conj().T + n * np.eye(n)
    if sign < 0:
        W = W + X @ X.conj().T
    return W, np.linalg.cholesky(W)


# ---------------------------------------------------------------------------
# ops.cholupdate: the plain route against the reference's oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(16, 1), (24, 4), (64, 8), (100, 3)])
@pytest.mark.parametrize("sign", [1, -1], ids=["update", "downdate"])
@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_cholupdate_plain_route_matches_jax(n, k, sign, complex_):
    rng = np.random.default_rng([n, k, sign + 1, complex_])
    X = _complex_or_real(rng, (n, k), complex_)
    W, L0 = _spd_factor(rng, n, X, sign, complex_)
    Lj, Lt = pair(L0, _dt(complex_))
    Xj, Xt = pair(X, _dt(complex_))
    got = ops.cholupdate(Lt, Xt, sign=sign)
    assert got.dtype == Lt.dtype
    assert rel(got, jref.cholupdate_ref(Lj, Xj, sign)) < TOL
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))
    target = W + sign * (X @ X.conj().T)
    assert rel(got @ got.mH, target) < TOL


def test_cholupdate_dispatch_on_cpu():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(8, 2))
    _, L0 = _spd_factor(rng, 8, X, 1, False)
    L, x = torch.from_numpy(L0).float(), torch.from_numpy(X[:, 0]).float()
    # a 1-D X is one column; the plain route is the one for CPU tensors
    assert torch.equal(ops.cholupdate(L, x), ops.cholupdate(L, x[:, None]))
    assert torch.equal(ops.cholupdate(L, x, mode="ref"), ops.cholupdate(L, x))
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.cholupdate(L, x, mode="kernel")
    with pytest.raises(ValueError, match="mode"):
        ops.cholupdate(L, x, mode="interpret")
    # the launch wrapper never runs the plain version
    with pytest.raises(ValueError, match="CUDA"):
        cholupdate_cuda(L, x[:, None])
    # complex factors take the plain version under every mode
    Lc = L.to(torch.complex64)
    xc = x.to(torch.complex64)
    assert torch.equal(ops.cholupdate(Lc, xc, mode="kernel"),
                       ops.cholupdate(Lc, xc, mode="ref"))
    ops.reset_launch_counts()
    ops.cholupdate(L, x)
    assert ops.launch_counts()["cholupdate"] == 0


# ---------------------------------------------------------------------------
# CholFactorization.update / downdate, now through ops.cholupdate
# ---------------------------------------------------------------------------

def _window(n, m, complex_, seed):
    rng = np.random.default_rng(seed)
    S = _complex_or_real(rng, (n, m), complex_) / np.sqrt(m)
    v = _complex_or_real(rng, (m,), complex_)
    X = _complex_or_real(rng, (n, 3), complex_) / 4
    return pair(S, _dt(complex_)), pair(v, _dt(complex_)), \
        pair(X, _dt(complex_))


def _blocks(Sj, St):
    offs = np.cumsum((0,) + WIDTHS)
    sl = [slice(offs[i], offs[i + 1]) for i in range(len(WIDTHS))]
    return (jcore.BlockedScores([Sj[:, s] for s in sl]),
            BlockedScores([St[:, s].contiguous() for s in sl]))


def _flat(x):
    if isinstance(x, tuple):
        return torch.cat(x) if isinstance(x[0], torch.Tensor) \
            else jnp.concatenate(x)
    return x


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("blocked", [False, True], ids=["dense", "blocked"])
def test_factorization_update_downdate_match_jax(complex_, blocked):
    n, m, lam = 16, sum(WIDTHS), 0.2
    mode = "complex" if complex_ else "real"
    (Sj, St), (vj, vt), (Xj, Xt) = _window(n, m, complex_, seed=7)
    if blocked:
        Sj, St = _blocks(Sj, St)
    jf = jcore.chol_factorize(Sj, lam, mode=mode)
    tf = chol_factorize(St, lam, mode=mode)
    ju, tu = jf.update(Xj), tf.update(Xt)
    assert rel(tu.W, ju.W) < TOL and rel(tu.L, ju.L) < TOL
    assert tu.S.shape == (n, m + 3)          # the columns were appended
    # the grown factorization solves the grown system
    vz = np.zeros((3,), _dt(complex_))
    if blocked:
        vgj = tuple(jcore.BlockedScores.split(Sj, vj)) + (jnp.asarray(vz),)
        vgt = tuple(St.split(vt)) + (torch.from_numpy(vz),)
    else:
        vgj = jnp.concatenate([vj, jnp.asarray(vz)])
        vgt = torch.cat([vt, torch.from_numpy(vz)])
    assert rel(_flat(tu.solve(vgt)), _flat(ju.solve(vgj))) < SOLVE_TOL
    # downdating the same columns with S_new returns to the base factor
    jd, td = ju.downdate(Xj, S_new=Sj), tu.downdate(Xt, S_new=St)
    assert rel(td.L, jd.L) < TOL and rel(td.L, tf.L) < 1e-4
    assert rel(td.W, jd.W) < TOL and td.S is St
    assert rel(_flat(td.solve(vt)), _flat(jd.solve(vj))) < SOLVE_TOL
    # without S_new the downdate keeps S (the stale-S approximation)
    assert tu.downdate(Xt).S is tu.S


# ---------------------------------------------------------------------------
# StreamingGram / accumulate_gram
# ---------------------------------------------------------------------------

def _pieces(Sj, St, kind):
    """The window as the pieces a caller folds: dense column chunks, one
    blocked operator, or lazy builders."""
    offs = np.cumsum((0,) + WIDTHS)
    sl = [slice(offs[i], offs[i + 1]) for i in range(len(WIDTHS))]
    dj = [Sj[:, s] for s in sl]
    dt = [St[:, s].contiguous() for s in sl]
    if kind == "dense":
        return dj, dt
    if kind == "blocked":
        return [jcore.BlockedScores(dj)], [BlockedScores(dt)]
    return ([jcore.LazyBlockedScores(lambda b=b: jcore.BlockedScores([b]))
             for b in dj],
            [LazyBlockedScores(lambda b=b: BlockedScores([b])) for b in dt])


@pytest.mark.parametrize("mode", ["real", "complex", "real_part"])
@pytest.mark.parametrize("kind", ["dense", "blocked", "lazy"])
def test_streaming_gram_matches_jax(mode, kind):
    n, m, lam = 12, sum(WIDTHS), 0.1
    complex_ = mode != "real"
    (Sj, St), (vj, vt), _ = _window(n, m, complex_, seed=11)
    dual_n = 2 * n if mode == "real_part" else n
    pj, pt = _pieces(Sj, St, kind)
    gj = jcurv.StreamingGram(dual_n, mode=mode)
    gt = StreamingGram(dual_n, mode=mode, device="cpu")
    for a, b in zip(pj, pt):
        gj, gt = gj.update(a), gt.update(b)
    assert gt.m == gj.m == m
    assert gt.W.dtype == (torch.complex64 if mode == "complex"
                          else torch.float32)
    assert rel(gt.gram(), gj.gram()) < TOL
    one_j = jcurv.accumulate_gram(pj, mode=mode)
    one_t = accumulate_gram(pt, mode=mode)
    assert rel(one_t, one_j) < TOL and one_t.device == St.device
    # retiring the last block leaves the Gram of the others
    w = WIDTHS[-1]
    dj = gj.downdate(Sj[:, -w:])
    dt = gt.downdate(St[:, -w:].contiguous())
    assert dt.m == dj.m == m - w and rel(dt.gram(), dj.gram()) < TOL
    # the accumulated W skips chol_factorize's Gram pass
    xj = gj.factorize(Sj, lam, mode=mode).solve(vj)
    xt = gt.factorize(St, lam, mode=mode).solve(vt)
    assert rel(xt, xj) < SOLVE_TOL


def test_streaming_gram_rejects_bad_input():
    with pytest.raises(ValueError, match="mode"):
        StreamingGram(4, mode="imaginary", device="cpu")
    with pytest.raises(ValueError, match="dual rows"):
        StreamingGram(5, device="cpu").update(torch.zeros(4, 3))
    with pytest.raises(ValueError, match="no pieces"):
        accumulate_gram([])


# ---------------------------------------------------------------------------
# StreamingCurvature / CurvatureCache over multi-step traces
# ---------------------------------------------------------------------------

N, M = 12, 160


def _trace(seed, steps, jump=None, eps=1e-3):
    """A drifting window: S_t = S_0 + eps·t·E / √m, with an unrelated
    window at step ``jump``; a fresh v per step."""
    rng = np.random.default_rng(seed)
    S0 = rng.normal(size=(N, M)) / np.sqrt(M)
    E = rng.normal(size=(N, M)) / np.sqrt(M)
    out = []
    for t in range(steps):
        S = rng.normal(size=(N, M)) / np.sqrt(M) if t == jump \
            else S0 + eps * t * E
        out.append((pair(S), pair(rng.normal(size=(M,)))))
    return out


CASES = {
    # name: (policy kwargs, trace kwargs, per-step λ, per-step ratio)
    "age": (dict(refresh_every=2), dict(steps=5), [0.1] * 5, None),
    "drift_tol": (dict(refresh_every=100, drift_tol=0.5),
                  dict(steps=5, jump=3), [0.1] * 5, None),
    "drift_frac": (dict(refresh_every=100, drift_frac=0.9),
                   dict(steps=6, eps=2e-2), [0.5] * 6,
                   [1.0, 1.0, 1e-3, 1.0, 1e-3, 1.0]),
    "lambda": (dict(refresh_every=100), dict(steps=4),
               [0.1, 0.3, 0.05, 1.7], None),
    "blocked": (dict(refresh_every=3, drift_tol=0.5),
                dict(steps=5, jump=4), [0.2] * 5, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cache_trace_matches_jax(case):
    kw, tkw, lams, ratios = CASES[case]
    trace = _trace(sum(map(ord, case)), **tkw)
    jc = jcurv.CurvatureCache(jcurv.StreamingCurvature(N, **kw))
    tc = CurvatureCache(StreamingCurvature(N, device="cpu", **kw))
    for t, ((Sj, St), (vj, vt)) in enumerate(trace):
        if case == "blocked":
            Sj, St = _blocks_of(Sj, St)
        dj = dt = None
        if ratios is not None:
            dj = jcore.DampingState(jnp.float32(lams[t]),
                                    jnp.float32(ratios[t]))
            dt = DampingState(torch.tensor(lams[t]), torch.tensor(ratios[t]))
        xj = jc.solve(Sj, vj, lams[t], damping_state=dj)
        xt = tc.solve(St, vt, lams[t], damping_state=dt)
        js, ts = jc.state, tc.state
        assert (ts.stats.hits, ts.stats.refreshes, ts.age) == \
            (int(js.stats.hits), int(js.stats.refreshes), int(js.age)), t
        assert ts.stats.last_residual == pytest.approx(
            float(js.stats.last_residual), rel=1e-3, abs=1e-6)
        assert rel(_flat(xt), _flat(xj)) < SOLVE_TOL
        assert rel(ts.W, js.W) < TOL
    # each trace takes both branches of its trigger
    assert 0 < tc.stats.hits and 0 < tc.stats.refreshes
    if case == "lambda":      # re-damped every step, refreshed only once
        assert tc.stats.refreshes == 1


def _blocks_of(Sj, St):
    widths = (60, 100)
    return (jcore.BlockedScores.from_dense(Sj, widths),
            BlockedScores.from_dense(St, widths))


def test_cache_state_is_pure_and_audit_matches_jax():
    (Sj, St), (vj, vt) = _trace(3, 1)[0]
    pol = StreamingCurvature(N, refresh_every=2, device="cpu")
    st0 = pol.init()
    assert st0.age == 2 ** 31 - 2 and st0.stats.last_residual == -1.0
    _, st1 = pol.solve(St, vt, 0.1, st0)
    assert st0.age == 2 ** 31 - 2 and st1.age == 1   # st0 untouched
    jc = jcurv.CurvatureCache(jcurv.StreamingCurvature(N))
    tc = CurvatureCache(pol)
    jc.solve(Sj, vj, 0.1)
    tc.solve(St, vt, 0.1)
    ja, ta = jc.audit(Sj, 0.1), tc.audit(St, 0.1)
    assert ta["condest"] == pytest.approx(ja["condest"], rel=SOLVE_TOL)
    # a fresh factor: both probes read rounding noise only
    assert ta["residual"] < 1e-5 and ja["residual"] < 1e-5
    tc.reset()
    assert tc.stats == st0.stats
    # a metrics registry is accepted and counts as the reference's does
    from repro.obs import MetricsRegistry as JRegistry
    from repro_torch.obs import MetricsRegistry
    jreg, treg = JRegistry(), MetricsRegistry()
    jrc = jcurv.CurvatureCache(jcurv.StreamingCurvature(N, refresh_every=2),
                               registry=jreg)
    trc = CurvatureCache(pol, registry=treg)
    for cache, S_, v_ in ((jrc, Sj, vj), (trc, St, vt)):
        cache.solve(S_, v_, 0.1)
        cache.solve(S_, v_, 0.1)
    jsnap, tsnap = jreg.snapshot(), treg.snapshot()
    assert tsnap["counters"] == jsnap["counters"] == {
        "curvature.cache_hits": 1, "curvature.refreshes": 1}
    assert tsnap["gauges"]["curvature.factor_age"] == \
        jsnap["gauges"]["curvature.factor_age"] == 2.0
    with pytest.raises(ValueError, match="complex"):
        pol.solve(St.to(torch.complex64), vt, 0.1, st0)
    with pytest.raises(ValueError):
        StreamingCurvature(N, refresh_every=0, device="cpu")


# ---------------------------------------------------------------------------
# the audit
# ---------------------------------------------------------------------------

def _audit_inputs(complex_, drifted):
    """(W, L, λ) of a damped Gram; ``drifted`` factors a perturbed Gram, so
    the residual probe reads a real drift."""
    rng = np.random.default_rng([complex_, drifted])
    n, m, lam = 20, 90, 0.05
    S = _complex_or_real(rng, (n, m), complex_) / np.sqrt(m)
    W = S @ S.conj().T
    Wf = W + (0.05 * np.diag(rng.uniform(size=n)) if drifted else 0)
    L = np.linalg.cholesky(Wf + lam * np.eye(n))
    return pair(W, _dt(complex_)), pair(L, _dt(complex_)), lam


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("iters", [1, 3])
def test_condest_matches_jax(complex_, iters):
    (Wj, Wt), (Lj, Lt), lam = _audit_inputs(complex_, drifted=False)
    got = condest(Wt, Lt, lam, iters=iters)
    assert float(got) == pytest.approx(
        float(jaudit.condest(Wj, Lj, lam, iters=iters)), rel=SOLVE_TOL)
    assert float(taudit.invnorm1_est(Lt, iters=iters)) == pytest.approx(
        float(jaudit.invnorm1_est(Lj, iters=iters)), rel=SOLVE_TOL)
    # a lower bound on the exact 1-norm condition number, within a small
    # factor of it
    A = Wt.to(torch.complex128 if complex_ else torch.float64) \
        + lam * torch.eye(Wt.shape[0])
    exact = float(torch.linalg.matrix_norm(A, 1)
                  * torch.linalg.matrix_norm(torch.linalg.inv(A), 1))
    assert exact / 10 < float(got) <= exact * (1 + 1e-4)


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("step", [0, 7])
def test_probe_residual_fed_the_reference_probes(complex_, step):
    """The reference's Rademacher probes (``jax.random``, key 0x5EED folded
    with ``step``) through the port's arithmetic give the reference's
    number."""
    (Wj, Wt), (Lj, Lt), lam = _audit_inputs(complex_, drifted=True)
    key = jax.random.fold_in(jax.random.PRNGKey(0x5EED),
                             jnp.asarray(step, jnp.uint32))
    z = jax.random.rademacher(key, (Wt.shape[0], 3), dtype=jnp.float32)
    got = taudit._probe_residual(Wt, Lt, lam, torch.from_numpy(np.array(z)))
    want = float(jaudit.factor_residual_probe(Wj, Lj, lam, probes=3,
                                              step=step))
    assert want > 1e-2                       # a real drift, not noise
    assert float(got) == pytest.approx(want, rel=SOLVE_TOL)


def test_port_probes_are_deterministic_signs():
    (_, Wt), (_, Lt), lam = _audit_inputs(False, drifted=True)
    z = taudit._probes(20, 4, 5, torch.float32, "cpu")
    assert z.shape == (20, 4) and set(z.unique().tolist()) == {-1.0, 1.0}
    assert torch.equal(z, taudit._probes(20, 4, 5, torch.float32, "cpu"))
    assert not torch.equal(z, taudit._probes(20, 4, 6, torch.float32, "cpu"))
    r = factor_residual_probe(Wt, Lt, lam, probes=4, step=5)
    assert torch.equal(r, taudit._probe_residual(Wt, Lt, lam, z))
    a = audit_factor(Wt, Lt, lam, probes=4, step=5)
    assert torch.equal(a.residual, r)
    assert torch.equal(a.condest, condest(Wt, Lt, lam))


# ---------------------------------------------------------------------------
# on the card: the rotation kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 24, 64, 100, 1024, 2048])
@pytest.mark.parametrize("k", [1, 3, 16, 40])
@pytest.mark.parametrize("sign", [1, -1], ids=["update", "downdate"])
def test_cuda_cholupdate_matches_plain(n, k, sign):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100 via chip_smoke "
                    "and `pytest -m cuda`)")
    g = torch.Generator(device="cuda").manual_seed(n * 100 + k)
    A = torch.randn((n, n), generator=g, device="cuda")
    X = torch.randn((n, k), generator=g, device="cuda")
    W = A @ A.T + n * torch.eye(n, device="cuda")
    if sign < 0:
        W = W + X @ X.T
    L = torch.linalg.cholesky(W).contiguous()
    ops.reset_launch_counts()
    got, again = ops.cholupdate(L, X, sign=sign), ops.cholupdate(L, X,
                                                                 sign=sign)
    torch.cuda.synchronize()
    assert ops.launch_counts()["cholupdate"] == 2
    assert torch.equal(got, again)
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))
    assert rel(got, ops.cholupdate(L, X, sign=sign, mode="ref")) < TOL
    # zero and −0.0 columns are exact no-ops; no column at all returns L
    assert torch.equal(ops.cholupdate(L, X[:, :0], sign=sign), torch.tril(L))
    Z = torch.zeros_like(X)
    assert torch.equal(ops.cholupdate(L, Z, sign=sign).view(torch.int32),
                       torch.tril(L).view(torch.int32))
    Xm = torch.cat([X, -Z[:, :1]], dim=1)
    assert torch.equal(ops.cholupdate(L, Xm, sign=sign), got)
