"""The serving slice of the torch port against the JAX package: the same
request trace (fused uniform-λ microbatches, one mixed-λ microbatch,
folds that wrap the FIFO, an age-triggered refresh) through both
packages' ``SolveServer`` on the CPU, plus bf16 windows, the state array
round trip in both directions, the CUDA-by-default device rule and
``OnlineAdaptation.from_policy``."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.operator import BlockedScores as JBlocked
from repro.curvature import StreamingCurvature as JPolicy
from repro.serve import (OnlineAdaptation as JAdapt, SolveServer as JServer,
                         TokenBudgetBatcher as JBatcher,
                         init_serve_state as j_init)
from repro.serve.state import (serve_state_arrays as j_arrays,
                               serve_state_from_arrays as j_from_arrays)
from repro_torch.core import BlockedScores
from repro_torch.curvature import StreamingCurvature
from repro_torch.serve import (OnlineAdaptation, SolveServer,
                               TokenBudgetBatcher, init_serve_state,
                               serve_state_arrays, serve_state_from_arrays)

torch.set_num_threads(1)

N, M = 48, 700          # the size of tests/test_kernels_serve.py:97
LAM = 0.05
WIDTHS = (300, 250, 150)
TOL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _trace(seed):
    """20 requests in five microbatches of 4: uniform λ₀ except requests
    8-11 (per-request λ, the mixed path). All but the last request carry 3
    fold rows: 57 rows wrap the 48-slot FIFO."""
    rng = np.random.default_rng(seed)
    S = (rng.normal(size=(N, M)) / np.sqrt(M)).astype(np.float32)
    vs = [rng.normal(size=(M,)).astype(np.float32) for _ in range(20)]
    lams = [None] * 20
    lams[8:12] = [0.2, 0.07, 0.2, 0.5]
    rows = {i: (rng.normal(size=(3, M)) / np.sqrt(M)).astype(np.float32)
            for i in range(19)}
    return S, vs, lams, rows


def _blocks(a):
    offs = np.cumsum((0,) + WIDTHS)
    return [np.ascontiguousarray(a[..., offs[i]:offs[i + 1]])
            for i in range(len(WIDTHS))]


def _drive_jax(S, vs, lams, rows, *, blocked=False, window_dtype=None):
    Sj = JBlocked([jnp.asarray(b) for b in _blocks(S)]) if blocked \
        else jnp.asarray(S)
    srv = JServer(j_init(Sj, LAM, window_dtype=window_dtype),
                  batcher=JBatcher(max_requests=4),
                  adaptation=JAdapt(refresh_every=3, drift_frac=None),
                  monitor_drift=False)
    sub = {}
    for i, v in enumerate(vs):
        r = rows.get(i)
        if blocked:
            v = tuple(jnp.asarray(b) for b in _blocks(v))
            r = None if r is None else tuple(jnp.asarray(b) for b in _blocks(r))
        else:
            v, r = jnp.asarray(v), None if r is None else jnp.asarray(r)
        sub[srv.submit(v, damping=lams[i], rows=r)] = i
    out = {}
    for res in srv.flush():
        x = np.concatenate([np.asarray(b) for b in res.x]) if blocked \
            else np.asarray(res.x)
        out[sub[res.uid]] = x
    return srv, out


def _drive_torch(S, vs, lams, rows, *, blocked=False, window_dtype=None):
    St = BlockedScores([torch.from_numpy(b) for b in _blocks(S)]) if blocked \
        else torch.from_numpy(S)
    srv = SolveServer(init_serve_state(St, LAM, window_dtype=window_dtype,
                                       device="cpu"),
                      batcher=TokenBudgetBatcher(max_requests=4),
                      adaptation=OnlineAdaptation(refresh_every=3,
                                                  drift_frac=None),
                      monitor_drift=False)
    sub = {}
    for i, v in enumerate(vs):
        r = rows.get(i)
        if blocked:
            v = tuple(torch.from_numpy(b) for b in _blocks(v))
            r = None if r is None else tuple(torch.from_numpy(b)
                                             for b in _blocks(r))
        else:
            v, r = torch.from_numpy(v), None if r is None else torch.from_numpy(r)
        sub[srv.submit(v, damping=lams[i], rows=r)] = i
    out = {}
    for res in srv.flush():
        x = torch.cat(res.x).numpy() if blocked else res.x.numpy()
        out[sub[res.uid]] = x
    return srv, out


@pytest.mark.parametrize("blocked", [False, True], ids=["dense", "blocked"])
def test_serve_trace_matches_jax(blocked):
    """Every response within 1e-4 relative of the JAX server on the same
    trace, and the final resident state agrees. (Measured worst case on
    this trace, CPU: 2.7e-7 dense, 1.8e-7 blocked; the serving
    benchmark's gate is 5e-3.)"""
    data = _trace(7)
    jsrv, jx = _drive_jax(*data, blocked=blocked)
    tsrv, tx = _drive_torch(*data, blocked=blocked)
    assert sorted(jx) == sorted(tx) == list(range(20))
    worst = max(_rel(tx[i], jx[i]) for i in jx)
    assert worst < TOL, worst
    js, ts = jsrv.state, tsrv.state
    assert _rel(ts.W, js.W) < TOL and _rel(ts.L, js.L) < TOL
    assert ts.slot == int(js.slot) and ts.age == int(js.age)
    # 19 folds of 3 rows wrap the 48-slot FIFO; one age refresh after the
    # third microbatch
    assert ts.stats.adapted == int(js.stats.adapted) == 57
    assert ts.slot == 57 % N
    assert ts.stats.refreshes == int(js.stats.refreshes) == 1
    for f in ("served", "microbatches", "adapted", "refreshes"):
        assert getattr(ts.stats, f) == int(getattr(js.stats, f)), f
    assert ts.stats.last_residual == float(js.stats.last_residual)
    tS = ts.S.to_dense() if blocked else ts.S
    jS = js.S.to_dense() if blocked else js.S
    assert np.array_equal(tS.numpy(), np.asarray(jS))


def test_bf16_window_trace_matches_jax():
    data = _trace(8)
    jsrv, jx = _drive_jax(*data, window_dtype="bfloat16")
    tsrv, tx = _drive_torch(*data, window_dtype="bfloat16")
    assert tsrv.state.S.dtype == torch.bfloat16
    assert tsrv.state.W.dtype == torch.float32
    worst = max(_rel(tx[i], jx[i]) for i in jx)
    assert worst < TOL, worst
    assert np.array_equal(
        tsrv.state.S.view(torch.int16).numpy().view(np.uint16),
        np.asarray(jsrv.state.S).view(np.uint16))


@pytest.mark.parametrize("window_dtype", [None, "bfloat16"],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("blocked", [False, True], ids=["dense", "blocked"])
def test_state_arrays_round_trip_jax_torch_jax(window_dtype, blocked):
    """JAX → arrays → port → arrays → JAX is bit-exact, and both packages
    fingerprint the same buffers identically."""
    rng = np.random.default_rng(9)
    S = (rng.normal(size=(12, 160)) / 13).astype(np.float32)
    Sj = JBlocked([jnp.asarray(S[:, :100]), jnp.asarray(S[:, 100:])],
                  names=("a", "b")) if blocked else jnp.asarray(S)
    jst = j_init(Sj, 0.1, window_dtype=window_dtype)
    arrays, meta = j_arrays(jst)
    tst = serve_state_from_arrays(arrays, meta, device="cpu")
    assert tst.fingerprint() == jst.fingerprint()
    assert tst.fingerprint(full=False) == jst.fingerprint(full=False)
    arrays2, meta2 = serve_state_arrays(tst)
    assert meta2 == meta
    assert sorted(arrays2) == sorted(arrays)
    for key in arrays:
        assert arrays2[key].dtype == arrays[key].dtype, key
        assert np.array_equal(arrays2[key], arrays[key]), key
    back = j_from_arrays(arrays2, meta2)
    assert back.fingerprint() == jst.fingerprint()


def test_state_from_torch_loads_in_jax():
    rng = np.random.default_rng(10)
    S = torch.from_numpy((rng.normal(size=(10, 90)) / 10).astype(np.float32))
    srv = SolveServer(init_serve_state(S, 0.2, device="cpu"),
                      adaptation=OnlineAdaptation(refresh_every=100))
    srv.apply_fold(torch.from_numpy(
        (rng.normal(size=(3, 90)) / 10).astype(np.float32)))
    arrays, meta = serve_state_arrays(srv.state)
    jst = j_from_arrays(arrays, meta)
    assert jst.fingerprint() == srv.state.fingerprint()
    assert int(jst.slot) == 3 and int(jst.stats.adapted) == 3


def test_cuda_default_refuses_cpu_fallback(monkeypatch):
    """Host data goes to CUDA unless the caller asks for the CPU; with no
    GPU that raises instead of silently running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    S = np.ones((4, 8), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_serve_state(S, 0.1)
    arrays, meta = serve_state_arrays(
        init_serve_state(S + np.eye(4, 8, dtype=np.float32), 0.1,
                         device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_state_from_arrays(arrays, meta)


def test_nonfinite_fold_rejected_and_slot_replay_checked():
    rng = np.random.default_rng(12)
    S = torch.from_numpy((rng.normal(size=(8, 64)) / 8).astype(np.float32))
    adapt = OnlineAdaptation(refresh_every=100)
    srv = SolveServer(init_serve_state(S, 0.1, device="cpu"),
                      adaptation=adapt)
    before = srv.state
    bad = torch.ones((2, 64))
    bad[1, 5] = float("nan")
    srv.apply_fold(bad)
    assert srv.state is before and adapt.rejected_nonfinite == 1
    with pytest.raises(ValueError, match="out of order"):
        srv.apply_fold(torch.ones((2, 64)), slots=(1, 2))
    srv.apply_fold(torch.ones((2, 64)) / 8, slots=(0, 1))
    assert srv.state.slot == 2
    # value semantics: the old state's window is untouched
    assert torch.equal(before.S, S)


def test_downdate_margin_tracking_matches_jax():
    """``track_margins`` drains the folds' downdate margins at
    ``maybe_refresh`` — the numbers the reference publishes as the
    ``curvature.downdate_margin`` gauge and ``downdate_clamped`` counter."""
    from repro.obs.metrics import MetricsRegistry
    rng = np.random.default_rng(13)
    S = (rng.normal(size=(16, 200)) / np.sqrt(200)).astype(np.float32)
    rows = [(rng.normal(size=(2, 200)) / np.sqrt(200)).astype(np.float32)
            for _ in range(3)]
    reg = MetricsRegistry()
    jad = JAdapt(refresh_every=100, registry=reg)
    jst = j_init(jnp.asarray(S), 0.1)
    tad = OnlineAdaptation(refresh_every=100, track_margins=True)
    tst = init_serve_state(torch.from_numpy(S), 0.1, device="cpu")
    for r in rows:
        jst = jad.fold(jst, jnp.asarray(r))
        tst = tad.fold(tst, torch.from_numpy(r))
    # the reference drains only the folds whose device work has finished
    # (its gauge may lag on a busy host); wait for all of them, so its
    # gauge is the minimum over every fold, as the port's drain takes it
    import jax
    jax.block_until_ready([a.margin for a in jad._pending_aux])
    jst, _ = jad.maybe_refresh(jst)
    tst, _ = tad.maybe_refresh(tst)
    expect = reg.gauge("curvature.downdate_margin").value
    assert 0.0 < expect < 1.0
    assert tad.downdate_margin == pytest.approx(expect, rel=1e-4)
    assert tad.downdate_clamped == \
        reg.counter("curvature.downdate_clamped").value == 0
    assert not tad._pending_aux


@pytest.mark.parametrize("policy", [
    {"refresh_every": 7, "drift_tol": 1e-3, "drift_frac": None},
    {"refresh_every": 3, "drift_tol": None, "drift_frac": 0.4,
     "jitter": 2e-5},
    {"refresh_every": 5, "drift_tol": None, "drift_frac": None},
    {"refresh_every": 4, "drift_tol": None, "jitter": 1e-6, "bare": True},
], ids=["static_tol", "frac", "no_drift", "no_drift_frac_attr"])
def test_adaptation_from_policy_matches_jax(policy):
    """``OnlineAdaptation.from_policy`` adopts a ``StreamingCurvature``
    policy's thresholds as the reference's does (``repro/serve/adapt.py``);
    a policy object without ``drift_frac`` gives none, and ``jitter=``
    overrides the policy's."""
    policy = dict(policy)
    if policy.pop("bare", False):
        jp = tp = types.SimpleNamespace(**policy)
    else:
        jp, tp = JPolicy(8, **policy), StreamingCurvature(8, **policy)
    for jitter in (None, 3e-4):
        ja = JAdapt.from_policy(jp, jitter=jitter)
        ta = OnlineAdaptation.from_policy(tp, jitter=jitter)
        assert (ta.refresh_every, ta.drift_tol, ta.drift_frac, ta.jitter) \
            == (ja.refresh_every, ja.drift_tol, ja.drift_frac, ja.jitter)
        assert ta.jitter == (policy.get("jitter", 0.0) if jitter is None
                             else jitter)
        jt, tt = ja.effective_drift_tol(), ta.effective_drift_tol()
        assert (jt is None) == (tt is None)
        if tt is not None:
            assert abs(float(jt) - tt) <= 1e-7 * abs(tt)
