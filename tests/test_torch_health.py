"""Numerical health in the torch port against the JAX package: the rule
engine (rules, events, verdicts, the fleet merge), the adaptation's
hooks (metric names and counts over one fold/refresh trace, the audit
cadence, the rejected-fold counter and its event), the two downdate
margin cases the reference's own tests get wrong, and the server's and
the curvature cache's series.

The JAX ``OnlineAdaptation`` is driven directly, its pending margins
waited for before its drain (it drains only finished folds). Tolerances:
margins, condition estimates and residuals to rtol 1e-3 of the JAX value
where both are well above rounding (the solver tests' bound on an fp32
solve, ``tests/test_kernels.py:103-108``); counts and verdicts exactly.
The audit's probes differ between the packages (a ``torch.Generator``
against ``jax.random``), so its residual is compared by its rule only."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.curvature import CurvatureCache as JCache
from repro.curvature import StreamingCurvature as JPolicy
from repro.curvature.update import chol_downdate as j_downdate
from repro.serve import OnlineAdaptation as JAdapt
from repro.serve import init_serve_state as j_init
from repro_torch import obs as tobs
from repro_torch.curvature import CurvatureCache, StreamingCurvature
from repro_torch.curvature.update import chol_downdate
from repro_torch.serve import (OnlineAdaptation, SolveServer,
                               TokenBudgetBatcher, init_serve_state)

torch.set_num_threads(1)

REL = 1e-3


def _pair(S, lam, *, audit_every=1, window_dtype=None):
    """(JAX, port): (state, adaptation, registry, monitor) each."""
    out = []
    for o, init, Adapt, arr in (
            (jobs, lambda s, **kw: j_init(jnp.asarray(s), lam, **kw),
             JAdapt, jnp.asarray),
            (tobs, lambda s, **kw: init_serve_state(
                torch.from_numpy(s), lam, device="cpu", **kw),
             OnlineAdaptation, torch.from_numpy)):
        reg = o.MetricsRegistry()
        mon = o.HealthMonitor(reg)
        ad = Adapt(refresh_every=10 ** 9, drift_tol=None, drift_frac=None,
                   registry=reg, health=mon, audit_every=audit_every)
        kw = {} if window_dtype is None else {
            "window_dtype": jnp.bfloat16 if o is jobs else "bfloat16"}
        out.append([init(np.asarray(S, np.float32), **kw), ad, reg, mon,
                    arr])
    return out


def _boundary(side, rows):
    state, ad, reg, mon, arr = side
    state = ad.fold(state, arr(np.asarray(rows, np.float32)))
    if isinstance(ad, JAdapt):
        jax.block_until_ready([a.margin for a in ad._pending_aux])
    state, _ = ad.maybe_refresh(state)
    side[0] = state


def _active(mon):
    return sorted(mon.report()["active"])


def test_rule_engine_matches_jax():
    """The same gauge and counter sequence: the same new events, verdicts,
    active rules and mirrored ``health.verdict`` gauge, step by step; the
    shipped rules are the reference's."""
    assert [tuple(r.__dict__.values()) for r in tobs.default_rules()] == \
        [tuple(r.__dict__.values()) for r in jobs.default_rules()]
    assert [r.bound for r in tobs.default_rules(margin_tol=1e-6)] == \
        [r.bound for r in jobs.default_rules(margin_tol=1e-6)]
    steps = [("g", "curvature.downdate_margin", 0.5),
             ("g", "curvature.downdate_margin", 1e-5),
             ("g", "curvature.downdate_margin", 9e-6),      # no re-fire
             ("g", "curvature.downdate_margin", 1e-7),      # moved > 50 %
             ("c", "serve.fold.rejected_nonfinite", 2),
             ("g", "curvature.downdate_margin", -0.25),
             ("g", "curvature.condest", 1e9),
             ("g", "curvature.downdate_margin", 0.9),
             ("c", "curvature.downdate_clamped", 0)]
    sides = []
    for o in (jobs, tobs):
        reg = o.MetricsRegistry()
        mon = o.HealthMonitor(reg, clock=lambda: 1.0)
        trail = []
        for kind, name, v in steps:
            if kind == "g":
                reg.gauge(name).set(v)
            else:
                reg.counter(name).inc(v)
            new = mon.evaluate()
            trail.append(([e.as_dict() for e in new], mon.verdict(),
                          mon.report(), reg.gauge("health.verdict").value))
        ev = o.HealthEvent(ts=2.0, severity="critical", rule="manual",
                           series="x", value=1.0, bound=0.0,
                           recommendation="r")
        mon.record_event(ev)
        trail.append(mon.report())
        mon.clear()
        trail.append((mon.report(), reg.gauge("health.verdict").value))
        sides.append(trail)
    assert sides[0] == sides[1]
    verdicts = [t[1] for t in sides[1][:len(steps)]]
    # the condition estimate of step 7 stays above its bound to the end
    assert verdicts == ["ok", "degraded", "degraded", "degraded", "degraded",
                        "critical", "critical", "degraded", "degraded"]


def test_merge_health_matches_jax():
    reps = [{"verdict": "degraded",
             "active": {"condest": {"severity": "degraded", "ts": 2.0}},
             "events": [{"ts": 2.0, "rule": "condest"}]},
            {"verdict": "critical",
             "active": {"condest": {"severity": "critical", "ts": 1.0}},
             "events": [{"ts": 1.0, "rule": "condest"}]},
            {}, {"verdict": "ok", "active": {}, "events": []}]
    assert tobs.merge_health(reps) == jobs.merge_health(reps)
    assert tobs.merge_health(reps)["verdict"] == "critical"
    assert tobs.merge_health(reps)["members"] == 3


@pytest.mark.parametrize("window_dtype", [None, "bfloat16"],
                         ids=["fp32", "bf16"])
def test_fold_trace_series_match_jax(window_dtype):
    """Four folds with the audit every 2 boundaries, then a forced
    refresh: the same counters exactly, the same gauge names, margins and
    condition estimates within REL, and the same verdict."""
    rng = np.random.default_rng(0)
    n, m, k = 8, 48, 2
    S = rng.normal(size=(n, m)) / np.sqrt(m)
    jside, tside = _pair(S, 1e-2, audit_every=2, window_dtype=window_dtype)
    for _ in range(4):
        rows = rng.normal(size=(k, m)) / np.sqrt(m)
        _boundary(jside, rows)
        _boundary(tside, rows)
    for side in (jside, tside):
        side[0], refreshed = side[1].maybe_refresh(side[0], force=True)
        assert refreshed
    js, ts = jside[2].snapshot(), tside[2].snapshot()
    assert ts["counters"] == js["counters"] == {
        "curvature.folds": 4, "curvature.fold_rows": 8,
        "curvature.refreshes": 1, "curvature.refresh_force": 1}
    assert sorted(ts["gauges"]) == sorted(js["gauges"])
    for name in ("curvature.downdate_margin", "curvature.condest"):
        assert ts["gauges"][name] == pytest.approx(js["gauges"][name],
                                                   rel=REL)
    wname = "window.bytes.bfloat16" if window_dtype else \
        "window.bytes.float32"
    assert ts["gauges"][wname] == js["gauges"][wname] == n * m * (
        2 if window_dtype else 4)
    assert tside[3].verdict() == jside[3].verdict() == "ok"
    assert tside[1].downdate_margin == ts["gauges"][
        "curvature.downdate_margin"]


@pytest.mark.parametrize("case", ["x1e3_lam1e-8", "x1e4_lam1e-2"])
def test_downdate_margin_cases_state_what_the_reference_does(case):
    """The reference's two fold margin cases: the window's first two rows
    scaled up, the fold retiring them. At ×1e3 and λ = 1e-8 the margin
    in float64 is positive and below 1e-6, and so is the reference's in
    fp32 — ``degraded``, no clamp — not the ``critical`` its own test
    expects; the port's is positive too (it splits the fold's core in
    float64; an fp32 split gave a negative margin and ``critical``). At
    ×1e4 and λ = 1e-2 both margins are ≤ 0: critical, with the clamp
    counter."""
    scale, lam = (1e3, 1e-8) if case == "x1e3_lam1e-8" else (1e4, 1e-2)
    rng = np.random.default_rng(0)
    n, m, k = 8, 32, 2
    S = rng.normal(size=(n, m)) / np.sqrt(m)
    S[:k] *= scale
    jside, tside = _pair(S, lam)
    rows = rng.normal(size=(k, m)) / np.sqrt(m)
    _boundary(jside, rows)
    _boundary(tside, rows)
    js, ts = jside[2].snapshot(), tside[2].snapshot()
    jm, tm = (s["gauges"]["curvature.downdate_margin"] for s in (js, ts))
    assert tside[3].verdict() == jside[3].verdict()
    if case == "x1e3_lam1e-8":
        # min eig of L⁻¹(W' + λĨ)L⁻ᵀ in float64: the margin's true value
        S64 = S.astype(np.float32).astype(np.float64)
        S2 = S64.copy()
        S2[:k] = rows.astype(np.float32)
        L64 = np.linalg.cholesky(S64 @ S64.T + lam * np.eye(n))
        P = np.linalg.solve(L64, S2 @ S2.T + lam * np.eye(n))
        m64 = np.linalg.eigvalsh(np.linalg.solve(L64, P.T)).min()
        assert jside[3].verdict() == "degraded"
        assert 0.0 < m64 < 1e-6 and 0.0 < jm < 1e-6 and 0.0 < tm < 1e-6
        for side in (jside, tside):
            assert "downdate_margin" in _active(side[3])
            assert "downdate_margin_invalid" not in _active(side[3])
        assert "curvature.downdate_clamped" not in ts["counters"]
        assert "curvature.downdate_clamped" not in js["counters"]
    else:
        assert jside[3].verdict() == "critical"
        assert jm <= 0.0 and tm <= 0.0
        assert _active(tside[3]) == _active(jside[3])
        assert ts["counters"]["curvature.downdate_clamped"] == \
            js["counters"]["curvature.downdate_clamped"] == 1


def test_rotations_margin_is_the_min_relative_pivot():
    """The reference's property test of the margin: downdating
    W = I + uu† by f·t_crit·u, complex, n = 16. The rotations margin is
    the minimum relative pivot of the sweep — 0.30 at f = 0.999 here,
    above the 0.2 the reference's hypothesis test asks of it — while the
    composed one is 1 − f². The port's margins equal the reference's."""
    rng = np.random.default_rng(0)
    n = 16
    u = rng.normal(size=(n, 1)) + 1j * rng.normal(size=(n, 1))
    L = np.linalg.cholesky(np.eye(n) + u @ u.conj().T).astype(np.complex64)
    t_crit = float(np.sqrt(1 + 1 / float((u.conj().T @ u).real[0, 0])))
    fracs = (0.2, 0.5, 0.8, 0.95, 0.999)
    got = {}
    for method in ("rotations", "composed"):
        for f in fracs:
            X = (f * t_crit * u).astype(np.complex64)
            _, ja = j_downdate(jnp.asarray(L), jnp.asarray(X), method=method,
                               return_aux=True)
            _, ta = chol_downdate(torch.from_numpy(L), torch.from_numpy(X),
                                  method=method, return_aux=True)
            assert not bool(ta.clamped) and not bool(ja.clamped)
            assert float(ta.margin) == pytest.approx(float(ja.margin),
                                                     rel=REL, abs=1e-5)
            got[method, f] = float(ta.margin)
    rot = [got["rotations", f] for f in fracs]
    assert all(a > b for a, b in zip(rot, rot[1:]))
    assert rot[-1] == pytest.approx(0.3019, abs=1e-3) and rot[-1] > 0.2
    np.testing.assert_allclose([got["composed", f] for f in fracs],
                               [1 - f * f for f in fracs], rtol=1e-2,
                               atol=1e-3)


def test_nonfinite_fold_rejected_with_counter_and_event():
    rng = np.random.default_rng(1)
    n, m, k = 8, 32, 2
    S = rng.normal(size=(n, m)) / np.sqrt(m)
    jside, tside = _pair(S, 1e-2)
    bad = rng.normal(size=(k, m)).astype(np.float32)
    bad[0, 3] = np.nan
    bad2 = bad.copy()
    bad2[0, 3] = np.inf
    for side in (jside, tside):
        state, ad, reg, mon, arr = side
        for rows in (bad, bad2):
            after = ad.fold(state, arr(rows))
            # the poisoned rows never reach the factor or the window
            assert np.array_equal(np.asarray(after.L), np.asarray(state.L))
            assert np.array_equal(np.asarray(after.S), np.asarray(state.S))
    js, ts = jside[2].snapshot(), tside[2].snapshot()
    assert ts["counters"] == js["counters"] == {
        "serve.fold.rejected_nonfinite": 2}
    assert tside[1].rejected_nonfinite == 2
    assert _active(tside[3]) == _active(jside[3]) == ["nonfinite_folds"]
    assert tside[3].verdict() == jside[3].verdict() == "degraded"
    ev = tside[3].report()["active"]["nonfinite_folds"]
    jev = jside[3].report()["active"]["nonfinite_folds"]
    assert {k: v for k, v in ev.items() if k != "ts"} == \
        {k: v for k, v in jev.items() if k != "ts"}


def test_audit_only_with_a_registry_and_at_its_cadence():
    """As in the reference the audit runs at every ``audit_every``-th
    maintenance boundary and only with a registry; ``audit`` itself
    matches the JAX condition estimate."""
    rng = np.random.default_rng(2)
    S = (rng.normal(size=(8, 40)) / np.sqrt(40)).astype(np.float32)
    st = init_serve_state(torch.from_numpy(S), 1e-2, device="cpu")
    bare = OnlineAdaptation(audit_every=1)
    bare.maybe_refresh(st)
    assert bare._audit_step == 0
    reg = tobs.MetricsRegistry()
    ad = OnlineAdaptation(audit_every=3, registry=reg)
    for i in range(7):
        ad.maybe_refresh(st)
    assert ad._audit_step == 2
    out = ad.audit(st)
    jout = JAdapt(audit_every=1).audit(j_init(jnp.asarray(S), 1e-2))
    assert out["condest"] == pytest.approx(jout["condest"], rel=REL)
    assert out["residual"] < 1e-5 and jout["residual"] < 1e-5
    assert reg.gauge("curvature.condest").value == out["condest"]


def test_server_reports_the_reference_series():
    """A flush of the port's server with a registry, a tracer and a health
    monitor: the reference's series names, request counts and spans."""
    rng = np.random.default_rng(3)
    n, m = 8, 32
    S = torch.from_numpy((rng.normal(size=(n, m)) / np.sqrt(m))
                         .astype(np.float32))
    reg = tobs.MetricsRegistry()
    mon = tobs.HealthMonitor(reg)
    tracer = tobs.Tracer()
    srv = SolveServer(
        init_serve_state(S, 1e-2, device="cpu"),
        batcher=TokenBudgetBatcher(max_tokens=2 ** 20, max_requests=2),
        adaptation=OnlineAdaptation(refresh_every=2, drift_tol=None,
                                    drift_frac=None, audit_every=1),
        registry=reg, tracer=tracer, health=mon)
    assert srv.adaptation.registry is reg and srv.adaptation.health is mon
    for i in range(3):
        rows = torch.from_numpy((rng.normal(size=(1, m)) / np.sqrt(m))
                                .astype(np.float32))
        srv.submit(torch.from_numpy(rng.normal(size=(m,))
                                    .astype(np.float32)),
                   tokens=4, rows=rows, trace=f"r{i}")
    assert reg.gauge("serve.queue_depth").value == 3
    srv.flush()
    snap = reg.snapshot()
    assert snap["counters"] == {
        "serve.microbatches": 2, "serve.requests": 3, "serve.tokens": 12,
        "curvature.folds": 3, "curvature.fold_rows": 3,
        "curvature.refreshes": 1, "curvature.refresh_age": 1}
    assert set(snap["gauges"]) == {
        "serve.queue_depth", "serve.queue_oldest_age_s", "window.bytes.float32",
        "curvature.downdate_margin", "curvature.condest",
        "curvature.factor_residual", "health.verdict",
        "curvature.factor_age", "curvature.last_drift_residual"}
    assert {h: v["count"] for h, v in snap["histograms"].items()} == {
        "serve.solve_latency_s": 2, "serve.request_latency_s": 3,
        "serve.queue_wait_s": 3}
    names = [e["name"] for e in tracer.events()]
    assert names.count("request") == names.count("queue_wait") == 3
    assert names.count("fold") == 3 and names.count("device_solve") == 2
    assert names.count("refresh") == 1
    assert {e["args"]["trace"] for e in tracer.events()
            if e["name"] == "request"} == {"r0", "r1", "r2"}
    assert mon.verdict() == "ok"


def test_cache_registry_and_audit_match_jax():
    rng = np.random.default_rng(4)
    S = (rng.normal(size=(6, 50)) / np.sqrt(50)).astype(np.float32)
    v = rng.normal(size=(50,)).astype(np.float32)
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jc = JCache(JPolicy(6, refresh_every=3, drift_tol=1e-3), registry=jreg)
    tc = CurvatureCache(StreamingCurvature(6, refresh_every=3,
                                           drift_tol=1e-3, device="cpu"),
                        registry=treg)
    for _ in range(4):
        jc.solve(jnp.asarray(S), jnp.asarray(v), 0.1)
        tc.solve(torch.from_numpy(S), torch.from_numpy(v), 0.1)
    ja, ta = jc.audit(jnp.asarray(S), 0.1), tc.audit(torch.from_numpy(S), 0.1)
    js, ts = jreg.snapshot(), treg.snapshot()
    assert ts["counters"] == js["counters"]
    assert sorted(ts["gauges"]) == sorted(js["gauges"])
    assert ts["gauges"]["curvature.factor_age"] == \
        js["gauges"]["curvature.factor_age"]
    assert ta["condest"] == pytest.approx(ja["condest"], rel=REL)
    assert ts["gauges"]["curvature.condest"] == ta["condest"]
