"""The port's fleet end to end on the CPU: ``FleetWorker`` replicas
(``device="cpu"``, the plain versions of the kernels) behind the port's
``Dispatcher``, each worker's frame loop in a daemon thread on one end of
a ``socket.socketpair`` — no subprocess. The reference's own fleet gates
(``tests/test_fleet.py``, at its ``n, m, requests, k = 8, 96, 12, 2`` and
its mixed trace):

* every response within 5e-3 of the port's fold-at-admission eager
  server, and after ``reconcile()`` the workers' probes bit for bit;
* the fleet checkpoint's manifest, and its gossip journal loaded by the
  reference's ``FoldJournal.load`` and replayed onto the reference's
  ``init_serve_state``: ``S`` and ``slot`` equal to each port worker's
  checkpoint (read by the reference's ``restore_serve_state``), ``W`` and
  ``L`` within the journal tests' rtol 2e-4 / atol 2e-5;
* gossip off under ``by_adapter``: each worker's responses bit for bit
  those of an eager server fed only its partition;
* async (replicated and a 1d window over the worker's one-position mesh),
  tenant and observed workers, ``build_fleet``'s init frame at SMOKE, the
  ``build`` init mode, and a worker's error reaching the dispatcher.

Every thread is a daemon, joined in a ``finally``; every wait has a
timeout. Files go under ``tmp_path``."""
import contextlib
import socket
import threading

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro_torch import configs  # noqa: E402
from repro_torch.fleet import (Channel, Dispatcher, FleetWorker,  # noqa: E402
                               WorkerHandle)
from repro_torch.launch.trainer import fleet_init_frame  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.serve import (FoldJournal, OnlineAdaptation,  # noqa: E402
                               SolveServer, TokenBudgetBatcher,
                               init_serve_state, restore_serve_state)
from repro_torch.tenants import TenantManager  # noqa: E402


N, M, REQUESTS, LAM = 8, 96, 12, 0.1
GATE = 5e-3
WAIT = 60.0                      # every wait's timeout, seconds
FROZEN = {"refresh_every": 10 ** 6, "drift_frac": None}


def _window(seed, n=N, m=M):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, m)) / np.sqrt(m)).astype(np.float32)


def _mixed_trace(seed, m=M, requests=REQUESTS):
    """The reference's trace: λ 0.3 every fifth request, two fold rows
    every third, adapters user0–4."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(m,)).astype(np.float32),
             0.3 if i % 5 == 4 else None,
             (rng.normal(size=(2, m)) / np.sqrt(m)).astype(np.float32)
             if i % 3 == 2 else None,
             f"user{i % 5}") for i in range(requests)]


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@contextlib.contextmanager
def thread_fleet(n_workers, meta, arrays=None, *, route="round_robin",
                 gossip=True, registry=None):
    """A dispatcher over ``n_workers`` in-thread CPU workers, initialized
    with the frame (``meta``, ``arrays``); shut down (draining) and every
    thread joined on exit."""
    workers, threads, errors, handles = [], [], [], []

    def serve(worker):
        try:
            worker.run()
        except Exception as e:          # surfaced to the test below
            errors.append(e)

    for i in range(n_workers):
        here, there = socket.socketpair()
        worker = FleetWorker(Channel(here), worker_id=i, device="cpu")
        thread = threading.Thread(target=serve, args=(worker,), daemon=True)
        thread.start()
        workers.append(worker)
        threads.append(thread)
        handles.append(WorkerHandle(i, Channel(there)))
    disp = Dispatcher(handles, route=route, gossip=gossip, registry=registry)
    try:
        disp.init_workers(meta, arrays)
        yield disp, workers
    finally:
        disp.shutdown(timeout=WAIT)
        for h in handles:
            h.chan.close()
        for thread in threads:
            thread.join(timeout=WAIT)
            assert not thread.is_alive()
        disp.errors = errors


def _inline(S, **extra):
    return ({"mode": "inline", "damping": LAM, "max_requests": 2,
             **FROZEN, **extra}, {"S0": S})


def _fold_at_admission(S, trace, k=2, window_dtype=None):
    """The port's eager server fed the trace with every request's rows
    folded before its solve (the fleet's gossip order)."""
    srv = SolveServer(init_serve_state(_t(S), LAM, device="cpu",
                                       window_dtype=window_dtype),
                      batcher=TokenBudgetBatcher(max_requests=k),
                      adaptation=OnlineAdaptation(**FROZEN))
    out, sub = {}, {}
    for i, (v, lam, rows, _) in enumerate(trace):
        if rows is not None:
            for r in srv.flush():
                out[sub[r.uid]] = r.x.numpy()
            srv.apply_fold(_t(rows))
        sub[srv.submit(_t(v), damping=lam)] = i
    for r in srv.flush():
        out[sub[r.uid]] = r.x.numpy()
    return out


def _drive(disp, trace, *, tenants=None):
    sub = {}
    for i, (v, lam, rows, adapter) in enumerate(trace):
        tenant = None if tenants is None else tenants[i]
        # a tenant is its own placement key
        sub[disp.submit(v, damping=lam, rows=rows, tenant=tenant,
                        adapter=adapter if tenant is None else None)] = i
    got = {sub[r.uid]: r.x for r in disp.flush(timeout=WAIT)}
    assert sorted(got) == list(range(len(trace)))
    return got, sub


def _worst(got, ref):
    return max(np.linalg.norm(got[i] - ref[i]) / np.linalg.norm(ref[i])
               for i in ref)


def _probe_agrees(disp, v):
    disp.reconcile(timeout=WAIT)
    xs = list(disp.probe(v, timeout=WAIT).values())
    assert len(xs) == 2
    np.testing.assert_array_equal(xs[0], xs[1])


def test_responses_within_gate_and_reconciled_probe_bit_for_bit():
    S, trace = _window(3), _mixed_trace(2)
    ref = _fold_at_admission(S, trace)
    with thread_fleet(2, *_inline(S)) as (disp, _):
        got, _ = _drive(disp, trace)
        assert all(x.dtype == np.float32 and x.shape == (M,)
                   for x in got.values())
        assert _worst(got, ref) < GATE
        _probe_agrees(disp, trace[0][0])
        assert disp.log.head == sum(r is not None for _, _, r, _ in trace)
    assert not disp.errors


def test_checkpoint_replays_in_the_reference(tmp_path):
    """The manifest, then the gossip journal replayed by the reference
    onto its own initial state: S and slot exactly each port worker's
    checkpoint, W and L to the journal tests' tolerance. The port's replay
    of the same journal gives the checkpoint bit for bit."""
    from repro.serve import FoldJournal as RefJournal
    from repro.serve import OnlineAdaptation as RefAdaptation
    from repro.serve import init_serve_state as ref_init
    from repro.serve import restore_serve_state as ref_restore

    S, trace = _window(3), _mixed_trace(2)
    with thread_fleet(2, *_inline(S)) as (disp, _):
        _drive(disp, trace)
        disp.reconcile(timeout=WAIT)
        path = disp.checkpoint(tmp_path, 7, timeout=WAIT)
        head = disp.log.head
    import json
    manifest = json.loads(path.read_text())
    assert manifest["route"] == "round_robin" and manifest["gossip"]
    assert manifest["gossip_head"] == head > 0
    assert set(manifest["workers"]) == {"0", "1"}
    assert all(ack["applied"] == head
               for ack in manifest["workers"].values())

    journal = tmp_path / manifest["gossip_journal"]
    ref_state = RefJournal.load(journal).replay(
        ref_init(jnp.asarray(S), LAM), RefAdaptation(**FROZEN))
    port_state = FoldJournal.load(journal).replay(
        init_serve_state(_t(S), LAM, device="cpu"),
        OnlineAdaptation(**FROZEN))
    for wid in (0, 1):
        wstate, meta = ref_restore(tmp_path / f"worker_{wid}", 7,
                                   ref_init(jnp.asarray(S), LAM))
        assert meta["worker_id"] == wid
        np.testing.assert_array_equal(np.asarray(wstate.S),
                                      np.asarray(ref_state.S))
        assert int(wstate.slot) == int(ref_state.slot)
        for name in ("W", "L"):
            np.testing.assert_allclose(np.asarray(getattr(wstate, name)),
                                       np.asarray(getattr(ref_state, name)),
                                       rtol=2e-4, atol=2e-5, err_msg=name)
        mine, _ = restore_serve_state(
            tmp_path / f"worker_{wid}", 7,
            init_serve_state(_t(S), LAM, device="cpu"))
        for name in ("S", "W", "L"):
            assert torch.equal(getattr(mine, name),
                               getattr(port_state, name)), name
        assert mine.slot == port_state.slot


def test_gossip_off_by_adapter_partitions_exactly():
    """Width-1 microbatches pin the batch composition, so each worker's
    responses are bit for bit an eager server's fed only its requests."""
    S, trace = _window(4), _mixed_trace(5)
    meta, arrays = _inline(S, max_requests=1)
    with thread_fleet(2, meta, arrays, route="by_adapter",
                      gossip=False) as (disp, _):
        got, sub = _drive(disp, trace)
        by_worker = {}
        for uid, i in sub.items():
            by_worker.setdefault(disp.assignments[uid], []).append(i)
    assert len(by_worker) == 2
    for wid, idxs in by_worker.items():
        srv = SolveServer(init_serve_state(_t(S), LAM, device="cpu"),
                          batcher=TokenBudgetBatcher(max_requests=1),
                          adaptation=OnlineAdaptation(**FROZEN))
        ssub = {}
        for i in sorted(idxs):
            v, lam, rows, _ = trace[i]
            ssub[srv.submit(_t(v), damping=lam, rows=_t(rows))] = i
        for r in srv.flush():
            np.testing.assert_array_equal(got[ssub[r.uid]], r.x.numpy(),
                                          err_msg=f"w{wid}")


@pytest.mark.parametrize("layout", [None, "1d"])
def test_async_workers(layout):
    """``AsyncSolveServer`` replicas — replicated, and a 1d window over
    the worker's own mesh (one CPU position) — meet the same gates."""
    S, trace = _window(6), _mixed_trace(7)
    ref = _fold_at_admission(S, trace)
    with thread_fleet(2, *_inline(S, **{"async": True, "layout": layout})
                      ) as (disp, workers):
        got, _ = _drive(disp, trace)
        assert _worst(got, ref) < GATE
        _probe_agrees(disp, trace[1][0])
        assert all(type(w.server).__name__ == "AsyncSolveServer"
                   for w in workers)
        assert all((w.server.spec is None) == (layout is None)
                   for w in workers)


def test_tenant_workers():
    """Tenant rows ride the solve frame to the tenant's ring placement,
    never the gossip log: each worker answers bit for bit as an eager
    server with a ``TenantManager`` fed its tenants' requests."""
    S, trace = _window(8), _mixed_trace(9)
    tenants = [f"t{i % 3}" for i in range(REQUESTS)]
    meta, arrays = _inline(S, max_requests=1, tenant_rank=2)
    with thread_fleet(2, meta, arrays, route="by_adapter") as (disp, _):
        got, sub = _drive(disp, trace, tenants=tenants)
        assert disp.log.head == 0                 # nothing gossiped
        reports = disp.heartbeat(timeout=WAIT)
        placed = {}
        for uid, i in sub.items():
            placed.setdefault(tenants[i], set()).add(disp.assignments[uid])
    assert all(len(w) == 1 for w in placed.values())
    assert sum(rep["tenants"]["tenants"] for rep in reports.values()) == 3
    for wid in {w for ws in placed.values() for w in ws}:
        srv = SolveServer(init_serve_state(_t(S), LAM, device="cpu"),
                          batcher=TokenBudgetBatcher(max_requests=1),
                          adaptation=OnlineAdaptation(**FROZEN),
                          tenants=TenantManager(2))
        ssub = {}
        for i in range(REQUESTS):
            if disp.assignments[[u for u, j in sub.items() if j == i][0]] \
                    != wid:
                continue
            v, lam, rows, _ = trace[i]
            ssub[srv.submit(_t(v), damping=lam, rows=_t(rows),
                            tenant=tenants[i])] = i
        for r in srv.flush():
            np.testing.assert_array_equal(got[ssub[r.uid]], r.x.numpy())


def test_observed_workers_merge_metrics_and_stitch_spans(tmp_path):
    """Worker registries ride the pongs and merge with the dispatcher's
    ``fleet.*`` series; worker spans ride the result frames home and
    share their request's trace id with the dispatcher's rpc span."""
    from repro_torch.obs import quantile
    S, trace = _window(6), _mixed_trace(7, requests=8)
    registry = MetricsRegistry()
    with thread_fleet(2, *_inline(S, trace=True, audit_every=2),
                      registry=registry) as (disp, _):
        _drive(disp, trace)
        reports = disp.heartbeat(timeout=WAIT)
        assert all(rep["queue_depth"] == 0 for rep in reports.values())
        snap = disp.fleet_metrics(refresh=False)
        fh = disp.fleet_health(refresh=False)
        events = disp.tracer.events()
        n_spans = disp.tracer.export(str(tmp_path / "fleet_trace.json"))
    assert snap["counters"]["serve.requests"] == 8
    assert snap["counters"]["fleet.requests"] == 8
    counts = [w.metrics["counters"].get("serve.requests", 0)
              for w in disp.workers]
    assert sum(counts) == 8 and all(c > 0 for c in counts)
    h = snap["histograms"]["serve.request_latency_s"]
    assert h["count"] == 8 and 0.0 < quantile(h, 0.5) <= quantile(h, 0.99)
    assert fh["verdict"] == "ok" and fh["members"] == 2
    assert np.isfinite(snap["gauges"]["curvature.condest"])
    by_trace = {}
    for e in events:
        tid = e.get("args", {}).get("trace")
        if tid is not None:
            by_trace.setdefault(tid, set()).add(e["name"])
    assert by_trace and all({"rpc", "request"} <= names
                            for names in by_trace.values())
    assert n_spans == len(events) > 0


def test_build_fleet_init_frame_serves_at_smoke(monkeypatch):
    """``build_fleet``'s frame (``fleet_init_frame``) carries the
    reference's init meta; in-thread workers seeded from it serve the
    front's request, fold its rows everywhere, and the update applies."""
    from repro import configs as ref_configs
    from repro.fleet import wire as ref_wire
    from repro.launch.mesh import make_mesh as ref_mesh
    from repro.launch.trainer import build_fleet as ref_build_fleet

    kw = dict(window=4, seq=8, damping=1e-2, max_requests=2,
              refresh_every=10 ** 6, drift_frac=None)
    sent = {}
    monkeypatch.setattr(ref_wire, "_msgpack", None)
    monkeypatch.setattr(
        "repro.fleet.launch_fleet",
        lambda n, *, init_meta, init_arrays, **_: sent.update(
            meta=init_meta, arrays=init_arrays))
    ref_build_fleet(ref_configs.get_smoke("llama3.2-3b"),
                    mesh=ref_mesh((1, 1), ("data", "model")), **kw)
    h, meta, arrays = fleet_init_frame(configs.get_smoke("llama3.2-3b"),
                                       device="cpu", **kw)
    assert meta == sent["meta"]
    assert arrays["S0"].shape == sent["arrays"]["S0"].shape
    assert arrays["S0"].dtype == np.float32

    with thread_fleet(2, meta, arrays) as (disp, _):
        ex = {key: val[:2] for key, val in h.data.batch_at(1).items()}
        _, v, rows = h.score_grads(h.params, ex)
        uid = disp.submit(v, tokens=16, rows=rows, adapter="userA")
        (res,) = disp.flush(timeout=WAIT)
        assert res.uid == uid and np.isfinite(np.linalg.norm(res.x))
        before = h.params
        h.apply_update(torch.from_numpy(res.x), lr=0.05)
        assert h.params is not before
        disp.reconcile(timeout=WAIT)
        reports = disp.heartbeat(timeout=WAIT)
    assert all(rep["applied"] == 1 for rep in reports.values())


def test_build_mode_workers_agree():
    """``mode: build``: each worker builds its own SMOKE server from the
    same seed, so the windows agree bit for bit from the start and after
    a gossiped fold."""
    h, _, arrays = fleet_init_frame(configs.get_smoke("llama3.2-3b"),
                                    window=4, seq=8, device="cpu")
    meta = {"mode": "build", "arch": "llama3.2-3b", "smoke": True,
            "window": 4, "seq": 8, "damping": 1e-2, "max_requests": 2,
            **FROZEN}
    with thread_fleet(2, meta) as (disp, workers):
        assert disp.log.n == 4
        S0 = workers[0].server.state.S
        np.testing.assert_array_equal(S0.numpy(), arrays["S0"])
        assert torch.equal(workers[1].server.state.S, S0)
        ex = {key: val[:2] for key, val in h.data.batch_at(1).items()}
        _, v, rows = h.score_grads(h.params, ex)
        disp.submit(v, rows=rows)
        disp.flush(timeout=WAIT)
        _probe_agrees(disp, v.numpy())


def test_worker_error_reaches_the_dispatcher():
    """An init frame asking for an integer window fails in the worker;
    its error frame is raised by the dispatcher as a RuntimeError. A
    worker asked for CUDA on a machine without a card refuses to start."""
    with pytest.raises(RuntimeError, match="real float dtype"):
        with thread_fleet(1, *_inline(_window(0), window_dtype="int32")):
            pass
    if not torch.cuda.is_available():
        a, b = socket.socketpair()
        try:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                FleetWorker(Channel(a))
        finally:
            a.close()
            b.close()
