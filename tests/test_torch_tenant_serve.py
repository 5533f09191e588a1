"""Tenant serving in the torch port against the JAX package (CPU, plain
versions; on the card the same microbatches run the ``serve_solve``
kernels, ``chip_smoke.py``):

* ``SolveServer(tenants=)``: a tenant's responses within SOLVE_TOL
  (``tests/test_torch_tenants.py``'s 1e-4) of
  ``repro.tenants.tenant_factorization(...).solve`` on the reference's
  delta of the same folds, dense and blocked windows; mixed λ in one
  tenant's microbatch (λ₀ = 0.01 held rounded to fp32, so a request's
  0.01 re-damps, as in the reference);
* a tenant request's rows fold into its delta, never the shared window
  (S, W and L unchanged bit for bit), as the reference's manager folds
  them; responses under an evicting budget bit for bit those without one;
* ``submit(tenant=)`` without a manager raises; the registry reaches a
  manager that has none; the tracer's ``device_solve`` and the
  recorder's digests carry the tenant;
* ``build_server(tenant_rank=, tenant_budget_mb=)``;
* ``serve_main --smoke --device cpu --tenants N``: the reference's
  ``tenants:`` line, and tenant ids equal to the reference's zipf
  arithmetic on the same seed;
* C10: ``--profile-dir`` starts the profiler before ``build_server``, and
  the trace holds the window's factorization.

Fixed numpy seeds, no thread, no JAX server; every file under
``tmp_path`` (``tempfile.tempdir`` patched for the CLI's spill dirs)."""
import json
import re
import tempfile

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from _torch_parity import pair, rel  # noqa: E402
from repro import tenants as jten  # noqa: E402
from repro.serve import init_serve_state as j_init  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import BlockedScores  # noqa: E402
from repro_torch.launch.trainer import build_server  # noqa: E402
from repro_torch.obs import (FlightRecorder, MetricsRegistry,  # noqa: E402
                             ProfileHooks, Tracer)
from repro_torch.serve import (OnlineAdaptation, SolveServer,  # noqa: E402
                               TokenBudgetBatcher, init_serve_state)
from repro_torch.serve import main as serve_cli  # noqa: E402
from repro_torch.tenants import TenantManager  # noqa: E402

torch.set_num_threads(1)

SOLVE_TOL = 1e-4
N, M, LAM0 = 10, 120, 0.01
WIDTHS = (50, 70)
# the line python -m repro.serve --tenants 4 --tenant-budget-mb 0.001
# prints at its defaults (seed 0, 12 requests, window 8)
REFERENCE_TENANTS_LINE = (
    "tenants: 4 seen, 4 resident (608 B / 1048 budget), 0 evictions, "
    "0 activations, 0 factor hits / 10 builds; hot {'t0': 5, 't1': 3, "
    "'t3': 1, 't2': 1}")


def _states(blocked=False, seed=0):
    Sj, St = pair(np.random.default_rng(seed).normal(size=(N, M))
                  / np.sqrt(M))
    if blocked:
        St = BlockedScores.from_dense(St, WIDTHS)
    return j_init(Sj, LAM0), init_serve_state(St, LAM0, device="cpu")


def _rows(k, seed):
    return pair(np.random.default_rng(seed).normal(size=(k, M)) / np.sqrt(M))


def _server(state, tmp_path, **kw):
    tenants = kw.pop("tenants", None) or TenantManager(
        3, spill_dir=tmp_path / "spill", budget_bytes=kw.pop("budget", None))
    return SolveServer(state, batcher=TokenBudgetBatcher(max_tokens=64,
                                                         max_requests=4),
                       adaptation=OnlineAdaptation(refresh_every=1000),
                       tenants=tenants, **kw)


def _fold_tenants(srv, js, ts, tmp_path):
    """Folds of tenants a and b in the port's server (rows split as its
    window) and in a reference manager over the dense window; returns the
    reference manager."""
    mj = jten.TenantManager(3, spill_dir=tmp_path / "jax")
    for tid, k, seed in (("a", 2, 3), ("b", 1, 4), ("a", 2, 5)):
        Rj, Rt = _rows(k, seed)
        if isinstance(ts.S, BlockedScores):
            Rt = tuple(BlockedScores.from_dense(Rt, WIDTHS).blocks)
        mj.fold(js, tid, Rj)
        srv.tenants.fold(ts, tid, Rt)
    return mj


def _flat(x):
    return torch.cat(x) if isinstance(x, (tuple, list)) else x


@pytest.mark.parametrize("blocked", [False, True], ids=["dense", "blocked"])
def test_tenant_responses_match_jax(blocked, tmp_path):
    js, ts = _states(blocked)
    srv = _server(ts, tmp_path)
    mj = _fold_tenants(srv, js, ts, tmp_path)
    Vj, Vt = pair(np.random.default_rng(6).normal(size=(3, M)))
    uids = {srv.submit(Vt[0], tenant="a"): ("a", 0),
            srv.submit(Vt[1]): (None, 1),
            srv.submit(Vt[2], tenant="b"): ("b", 2)}
    res = {r.uid: r for r in srv.flush()}
    for uid, (tid, j) in uids.items():
        if tid is None:
            want = jten.tenant_factorization(
                js, jten.init_tenant_delta(N, 3)).solve(Vj[j])
        else:
            want = jten.tenant_factorization(
                js, mj._tenants[tid].delta).solve(Vj[j])
        assert rel(_flat(res[uid].x), want) < SOLVE_TOL, tid
    assert srv.tenants.stats.materializations == 2
    assert srv.state.stats.served == 3 and srv.state.stats.microbatches == 3


@pytest.mark.parametrize("blocked", [False, True], ids=["dense", "blocked"])
def test_mixed_lambda_in_one_tenant_matches_jax(blocked, tmp_path):
    js, ts = _states(blocked, seed=1)
    srv = _server(ts, tmp_path)
    mj = _fold_tenants(srv, js, ts, tmp_path)
    Vj, Vt = pair(np.random.default_rng(7).normal(size=(3, M)))
    lams = (None, 0.37, 0.01)       # λ₀, another λ, and λ₀ unrounded
    uids = [srv.submit(Vt[j], tenant="a", damping=lam)
            for j, lam in enumerate(lams)]
    res = {r.uid: r for r in srv.flush()}
    assert srv.state.stats.microbatches == 1
    for j, (uid, lam) in enumerate(zip(uids, lams)):
        want = jten.tenant_factorization(js, mj._tenants["a"].delta,
                                         lam=lam).solve(Vj[j])
        assert rel(_flat(res[uid].x), want) < SOLVE_TOL, lam
        assert res[uid].damping == (ts.lam0 if lam is None else lam)
    # three λ, three factors: 0.01 is not the fp32 λ₀; groups in λ order
    assert srv.tenants.stats.materializations == 3
    assert srv.tenants._tenants["a"].factor_key[2] == 0.37


def test_tenant_rows_fold_privately(tmp_path):
    js, ts = _states(seed=2)
    srv = _server(ts, tmp_path)
    S0, W0, L0 = ts.S.clone(), ts.W.clone(), ts.L.clone()
    mj = jten.TenantManager(3, spill_dir=tmp_path / "jax")
    v = torch.from_numpy(np.random.default_rng(8).normal(size=M)
                         .astype(np.float32))
    for seed in (3, 4):
        Rj, Rt = _rows(2, seed)
        srv.submit(v, tenant="a", rows=Rt)
        srv.flush()
        mj.fold(js, "a", Rj)
    st = srv.state
    assert st.stats.adapted == 0 and st.slot == 0
    assert torch.equal(st.S, S0) and torch.equal(st.W, W0) and \
        torch.equal(st.L, L0)
    assert srv.adaptation.journal is None or len(srv.adaptation.journal) == 0
    dt, dj = srv.tenants._tenants["a"].delta, mj._tenants["a"].delta
    assert dt.filled == int(dj.filled) == 3 and dt.cursor == int(dj.cursor)
    assert rel(dt.cols, dj.cols) < 1e-5


def test_responses_under_an_evicting_budget_are_bit_for_bit(tmp_path):
    _, ts = _states(seed=3)
    rng = np.random.default_rng(9)
    trace = [(f"t{int(rng.integers(5))}",
              torch.from_numpy(rng.normal(size=M).astype(np.float32)),
              torch.from_numpy((rng.normal(size=(1, M)) / np.sqrt(M))
                               .astype(np.float32))) for _ in range(24)]
    out = {}
    for budget in (None, 600):
        srv = _server(ts, tmp_path / str(budget), budget=budget)
        xs = []
        for b in range(0, len(trace), 4):
            for tid, v, rows in trace[b:b + 4]:
                srv.submit(v, tenant=tid, rows=rows)
            xs += [r.x for r in srv.flush()]
        out[budget] = (xs, srv.tenants.stats.as_dict())
    stats = out[600][1]
    assert stats["evictions"] > 0 and stats["activations"] > 0
    assert out[None][1]["evictions"] == 0
    assert all(torch.equal(a, b) for a, b in zip(out[None][0], out[600][0]))


def test_submit_tenant_without_a_manager_raises():
    _, ts = _states()
    srv = SolveServer(ts)
    with pytest.raises(RuntimeError, match="TenantManager"):
        srv.submit(torch.zeros(M), tenant="a")
    assert len(srv.batcher) == 0 and srv.tenants is None


def test_registry_reaches_a_manager_without_one(tmp_path):
    _, ts = _states()
    reg, own = MetricsRegistry(), MetricsRegistry()
    bare = TenantManager(2, spill_dir=tmp_path / "a")
    kept = TenantManager(2, spill_dir=tmp_path / "b", registry=own)
    assert SolveServer(ts, tenants=bare, registry=reg).tenants.registry is reg
    assert SolveServer(ts, tenants=kept, registry=reg).tenants.registry is own
    srv = SolveServer(ts, tenants=bare, registry=reg)
    srv.submit(torch.ones(M), tenant="z")
    srv.flush()
    snap = reg.snapshot()
    assert snap["counters"]["tenants.materializations"] == 1
    assert snap["gauges"]["tenants.registered"] == 1
    assert "tenants.delta_core_condest" in snap["gauges"]


def test_tracer_and_recorder_carry_the_tenant(tmp_path):
    _, ts = _states(seed=4)
    tracer, rec = Tracer(), FlightRecorder(str(tmp_path / "rec"))
    srv = _server(ts, tmp_path, tracer=tracer, recorder=rec)
    srv.submit(torch.ones(M), tenant="a")
    srv.submit(torch.ones(M))
    srv.flush()
    solves = [e for e in tracer.events() if e["name"] == "device_solve"]
    assert [e["args"]["tenant"] for e in solves] == ["a", None]
    assert [d["tenant"] for d in rec._requests] == ["a", None]
    assert rec._requests[0]["residual"] is None


@pytest.mark.parametrize("budget", [None, 0.5], ids=["unbounded", "budget"])
def test_build_server_attaches_a_tenant_manager(budget, tmp_path,
                                                monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    reg = MetricsRegistry()
    server, _ = build_server(tconfigs.get_smoke("llama3.2-3b"), window=4,
                             seq=8, device="cpu", tenant_rank=2,
                             tenant_budget_mb=budget, registry=reg)
    mgr = server.tenants
    assert isinstance(mgr, TenantManager) and mgr.rank == 2
    assert mgr.budget_bytes == (None if budget is None
                                else int(budget * 2**20))
    assert mgr.registry is reg and mgr.spill_dir.parent == tmp_path
    v = torch.ones(server.state.S.shape[1])
    x = server.solve_one(v, tenant="t0")
    assert x.shape == v.shape and torch.isfinite(x).all()
    plain, _ = build_server(tconfigs.get_smoke("llama3.2-3b"), window=4,
                            seq=8, device="cpu")
    assert plain.tenants is None


def _reference_tenant_ids(tenants, requests=12, window=8, examples=2,
                          seed=0):
    """The reference CLI's draws (``repro/serve/main.py:222-231``)."""
    rng = np.random.default_rng(seed)
    ids = []
    for _ in range(requests):
        rng.choice(window, size=examples, replace=False)
        ids.append(f"t{(int(rng.zipf(1.5)) - 1) % tenants}")
    return ids


@pytest.mark.parametrize("tenants", [4, 16])
def test_cli_tenants_line_and_zipf_ids(tenants, tmp_path, monkeypatch,
                                       capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    seen = []
    build = serve_cli.build_server

    def spy(*args, **kw):
        server, h = build(*args, **kw)
        submit = server.submit

        def tagged(*a, **k):
            seen.append(k.get("tenant"))
            return submit(*a, **k)
        server.submit = tagged
        return server, h
    monkeypatch.setattr(serve_cli, "build_server", spy)
    server, losses = serve_cli.serve_main(
        ["--device", "cpu", "--tenants", str(tenants),
         "--tenant-budget-mb", "0.001", "--decode-tokens", "0",
         "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert seen == _reference_tenant_ids(tenants) and len(losses) == 12
    line = [ln for ln in out.splitlines() if ln.startswith("tenants: ")]
    assert len(line) == 1
    assert re.fullmatch(
        r"tenants: \d+ seen, \d+ resident \(\d+ B / 1048 budget\), \d+ "
        r"evictions, \d+ activations, \d+ factor hits / \d+ builds; hot "
        r"\{.*\}", line[0])
    assert "window: adapted 0 rows" in out
    p = server.tenants.packing_stats()
    if tenants == 4:
        assert line[0] == REFERENCE_TENANTS_LINE
    else:
        assert p["evictions"] > 0
    assert server.tenants.spill_dir.parent == tmp_path


def test_profiler_starts_before_the_server_is_built(tmp_path, monkeypatch,
                                                   capsys):
    """C10: the reference starts the profiler before ``build_server``
    (``repro/serve/main.py:177-189``), so the trace holds the model build
    and the window's factorization."""
    order = []
    start, build = ProfileHooks.start, serve_cli.build_server

    def spy_start(self):
        order.append("profile.start")
        return start(self)

    def spy_build(*args, **kw):
        order.append("build_server")
        return build(*args, **kw)
    monkeypatch.setattr(ProfileHooks, "start", spy_start)
    monkeypatch.setattr(serve_cli, "build_server", spy_build)
    serve_cli.serve_main(["--device", "cpu", "--requests", "2", "--window",
                          "4", "--seq", "8", "--decode-tokens", "0",
                          "--burst", "2", "--ckpt-dir", str(tmp_path / "ck"),
                          "--profile-dir", str(tmp_path / "prof")])
    assert order == ["profile.start", "build_server"]
    out = capsys.readouterr().out
    path = re.search(r"profile: torch.profiler trace -> (\S+)", out).group(1)
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("cholesky" in name for name in names)
