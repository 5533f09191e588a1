"""The port's ``AsyncSolveServer`` (``repro_torch.dist.server``) on the CPU,
every mesh position on the CPU.

This file is the port's one test file that starts threads: the server's
own worker thread (one server a case, always inside ``with`` or followed
by ``shutdown``) and, in two cases, producer threads of the test. Every
wait has a timeout. No JAX server runs here: the port's async server is
held to the port's eager ``SolveServer``, which the other files hold to
the JAX package.

* replicated: bit for bit against the eager server (the reference's
  traces ``tests/test_dist.py:175-215`` at max_requests 1 and 2, rows on
  request 2; the eager server's tenant serving; ``apply_fold``);
* sharded (1d, 2d, blocked, a bf16 window, windows padded to the mesh in
  columns and, in 2d, in samples through a FIFO wrap): within 5e-3 of the
  eager replicated server with the same window dtype (relative norm,
  ``benchmarks/serve.py``'s gate and ``tests/test_dist.py``'s);
* responses depend only on the order of the calls: a producer that
  sleeps at seeded random points gives the same responses bit for bit as
  one that does not; more producer threads than cores give serial
  submission's responses to rtol 1e-5 (only the microbatches'
  composition differs);
* lifecycle: drain and cancel at shutdown, ``flush`` leaving claimed
  results to their ``result()`` caller, the caller's adaptation left
  unbound, worker errors surfaced, the shutdown handlers, a sharded
  checkpoint restored into a new server."""
import os
import random
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import BlockedScores
from repro_torch.dist import (AsyncSolveServer, DistSpec,
                              init_sharded_serve_state,
                              restore_sharded_serve_state,
                              save_sharded_serve_state)
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve import (OnlineAdaptation, SolveServer,
                               TokenBudgetBatcher, init_serve_state)
from repro_torch.tenants import TenantManager

torch.set_num_threads(1)

N, M, LAM = 12, 160, 0.1
GATE = 5e-3
WAIT = 60.0                    # every wait's timeout, seconds
WIDTHS = (64, 48, 48)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _window(seed=0, n=N, m=M):
    return _t(_rng(seed).normal(size=(n, m)) / np.sqrt(m))


def _adapt(**kw):
    return OnlineAdaptation(refresh_every=kw.pop("refresh_every", 10 ** 6),
                            drift_frac=None, **kw)


def _batcher(max_requests=2):
    return TokenBudgetBatcher(max_requests=max_requests)


def _flat(x):
    return torch.cat(x) if isinstance(x, (tuple, list)) else x


def _drive(server, vs, *, lams=None, rows=None):
    sub = {}
    for i, v in enumerate(vs):
        sub[server.submit(v, damping=None if lams is None else lams[i],
                          rows=None if rows is None else rows.get(i))] = i
    kw = {"timeout": WAIT} if isinstance(server, AsyncSolveServer) else {}
    return {sub[r.uid]: _flat(r.x) for r in server.flush(**kw)}


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


# ---------------------------------------------------------------------------
# replicated: bit for bit against the eager server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_requests", [1, 2])
def test_replicated_bit_identical_to_eager(max_requests):
    S = _window(3)
    rng = _rng(3)
    vs = [_t(rng.normal(size=(M,))) for _ in range(6)]
    rows = {2: _t(rng.normal(size=(2, M)) / np.sqrt(M))}
    lams = [None, None, None, 0.3, None, None]

    def mk():
        return (init_serve_state(S, LAM, device="cpu"),
                _batcher(max_requests), _adapt(refresh_every=3))

    st, b, a = mk()
    ref = _drive(SolveServer(st, batcher=b, adaptation=a), vs, lams=lams,
                 rows=rows)
    st, b, a = mk()
    with AsyncSolveServer(st, batcher=b, adaptation=a) as srv:
        got = _drive(srv, vs, lams=lams, rows=rows)
        stats = srv.stats
    assert sorted(got) == sorted(ref)
    for i in ref:
        assert torch.equal(got[i], ref[i]), i
    assert stats.microbatches == (6 if max_requests == 1 else 3)
    assert stats.adapted == 2 and stats.refreshes >= 1


def test_apply_fold_bit_identical_to_eager():
    """Folds queued by ``apply_fold`` apply at their place among the calls
    (after the request before them, before the one after), as the eager
    server's immediate ``apply_fold`` between two flushes."""
    S = _window(9)
    rng = _rng(9)
    fold_rows = [_t(rng.normal(size=(2, M)) / 12.0) for _ in range(3)]
    v1, v2 = (_t(rng.normal(size=(M,))) for _ in range(2))
    eager = SolveServer(init_serve_state(S, LAM, device="cpu"),
                        adaptation=_adapt())
    x1 = eager.solve_one(v1)
    for r in fold_rows:
        eager.apply_fold(r)
    x2 = eager.solve_one(v2)
    with AsyncSolveServer(init_serve_state(S, LAM, device="cpu"),
                          adaptation=_adapt()) as srv:
        u1 = srv.submit(v1)
        for r in fold_rows:
            srv.apply_fold(r)
        u2 = srv.submit(v2)
        res = {r.uid: r.x for r in srv.flush(timeout=WAIT)}
        assert srv.stats.adapted == 6 and srv.stats.microbatches == 2
    assert torch.equal(res[u1], x1) and torch.equal(res[u2], x2)


@pytest.mark.parametrize("layout", ["replicated", "1d"])
def test_tenants_vs_eager(layout, tmp_path):
    """Tenant microbatches (the tenant's L_t swapped in, private folds
    projected through the window — slab by slab when it is sharded — a
    mixed-λ tenant microbatch) through the async worker: the eager
    server's tenant serving bit for bit when replicated, within the gate
    on a 1d window of 4 positions."""
    S = _window(4)
    rng = _rng(4)
    reqs = [(_t(rng.normal(size=(M,))), t, lam,
             _t(rng.normal(size=(2, M)) / np.sqrt(M)) if i % 2 else None)
            for i, (t, lam) in enumerate([("a", None), ("b", None),
                                          ("a", 0.3), (None, None),
                                          ("a", None), ("b", 0.3)])]

    def run(cls, where):
        st = init_serve_state(S, LAM, device="cpu")
        if cls is AsyncSolveServer and layout == "1d":
            st = init_sharded_serve_state(S, LAM, device="cpu", spec=DistSpec(
                make_mesh((4,), ("model",), device="cpu"), "1d"))
        srv = cls(st,
                  batcher=_batcher(4), adaptation=_adapt(),
                  tenants=TenantManager(3, spill_dir=tmp_path / where))
        sub = {srv.submit(v, damping=lam, tenant=t, rows=r): i
               for i, (v, t, lam, r) in enumerate(reqs)}
        out = {sub[x.uid]: x.x for x in srv.flush()}
        if cls is AsyncSolveServer:
            srv.shutdown()
        return out, srv.tenants.stats.materializations

    ref, mat_ref = run(SolveServer, "eager")
    got, mat = run(AsyncSolveServer, "async")
    assert mat == mat_ref
    for i in ref:
        if layout == "replicated":
            assert torch.equal(got[i], ref[i]), i
        else:
            assert _rel(got[i], ref[i]) < GATE, i


# ---------------------------------------------------------------------------
# sharded: within the serving gate of the eager replicated server
# ---------------------------------------------------------------------------

SHARDED = ["1d", "2d", "blocked", "bf16_1d", "uneven_1d", "uneven_2d"]


@pytest.mark.parametrize("case", SHARDED)
def test_sharded_within_gate_of_eager(case):
    """Mixed λ, request folds and age refreshes; the uneven windows (m =
    151, and n = 9 over 2 data rows) fold past the logical n, so the
    padded 2d window must keep the logical FIFO modulus."""
    uneven = case.startswith("uneven")
    n, m = (9, 151) if uneven else (N, M)
    S = _window(11, n, m)
    rng = _rng(11)
    vs = [_t(rng.normal(size=(m,))) for _ in range(8)]
    lams = [None, 0.3, None, 0.05, None, None, 0.3, None]
    rows = {i: _t(rng.normal(size=(3, m)) / np.sqrt(m)) for i in (1, 2, 3, 4)}
    blocked = case == "blocked"
    widths = WIDTHS if blocked else None
    dtype = "bfloat16" if case == "bf16_1d" else None

    def as_window(t):
        return BlockedScores.from_dense(t, widths) if blocked else t

    def split(v):
        return BlockedScores.from_dense(v[None, :] if v.ndim == 1 else v,
                                        widths).blocks if blocked else v

    vs_in = [tuple(b[0] for b in split(v)) if blocked else v for v in vs]
    rows_in = {i: tuple(split(r)) if blocked else r for i, r in rows.items()}
    ref = _drive(SolveServer(init_serve_state(as_window(S), LAM,
                                              device="cpu",
                                              window_dtype=dtype),
                             batcher=_batcher(), adaptation=_adapt(
                                 refresh_every=3)),
                 vs_in, lams=lams, rows=rows_in)
    layout = "2d" if case.endswith("2d") else \
        "blocked" if blocked else "1d"
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu") \
        if layout == "2d" else make_mesh((4,), ("model",), device="cpu")
    st = init_sharded_serve_state(
        as_window(S), LAM, spec=DistSpec(mesh, layout), device="cpu",
        window_dtype=dtype)
    assert st.padded == uneven
    assert (st.n_logical == 9) if case == "uneven_2d" else \
        st.n_logical is None
    with AsyncSolveServer(st, batcher=_batcher(), adaptation=_adapt(
            refresh_every=3)) as srv:
        got = _drive(srv, vs_in, lams=lams, rows=rows_in)
        if case == "bf16_1d":
            assert srv.state.S.dtype == torch.bfloat16
        assert srv.stats.refreshes >= 1 and srv.stats.adapted == 12
    for i in ref:
        assert got[i].shape == (m,)
        assert _rel(got[i], ref[i]) < GATE, (case, i)


# ---------------------------------------------------------------------------
# responses depend on the order of the calls only
# ---------------------------------------------------------------------------

def _order_trace(seed):
    rng = _rng(seed)
    vs = [_t(rng.normal(size=(M,))) for _ in range(10)]
    rows = [_t(rng.normal(size=(2, M)) / np.sqrt(M)) for _ in range(10)]
    return vs, rows


def _ordered_run(S, trace, sleeper):
    """Submits with rows, two apply_folds, a result() and two flushes, on
    a 2d-sharded window; ``sleeper()`` runs before every call."""
    vs, rows = trace
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    st = init_sharded_serve_state(S, LAM, spec=DistSpec(mesh, "2d"),
                                  device="cpu")
    out = {}
    with AsyncSolveServer(st, batcher=_batcher(3),
                          adaptation=_adapt(refresh_every=2)) as srv:
        uids = []
        for i, v in enumerate(vs):
            sleeper()
            uids.append(srv.submit(v, rows=rows[i] if i % 3 else None,
                                   damping=0.3 if i == 7 else None))
            if i in (2, 6):
                sleeper()
                srv.apply_fold(rows[9 - i])
            if i == 4:
                sleeper()
                out[uids[3]] = srv.result(uids[3], timeout=WAIT).x
            if i == 5:
                sleeper()
                out.update({r.uid: r.x for r in srv.flush(timeout=WAIT)})
        sleeper()
        out.update({r.uid: r.x for r in srv.flush(timeout=WAIT)})
        fp = srv.sharded_state().fingerprint()
        mbs = srv.stats.microbatches
    return [out[u] for u in uids], fp, mbs


def test_seeded_sleeps_bit_identical():
    """A producer that sleeps up to 20 ms at seeded random points (the
    worker meanwhile finds the batcher half full, or empty) gets the
    responses, the microbatches and the final window of one that never
    sleeps, bit for bit."""
    S = _window(13)
    trace = _order_trace(13)
    fast, fp_fast, mbs_fast = _ordered_run(S, trace, lambda: None)
    pause = random.Random(13)
    slow, fp_slow, mbs_slow = _ordered_run(
        S, trace, lambda: time.sleep(pause.choice((0.0, 0.0, 0.005, 0.02))))
    assert fp_fast == fp_slow and mbs_fast == mbs_slow
    for a, b in zip(fast, slow):
        assert torch.equal(a, b)


def test_concurrent_producers_match_serial():
    """More producer threads than this box has cores, the interpreter
    switching threads every 10 µs: every request is served once, and each
    response equals serial submission's up to the microbatches'
    composition."""
    S = _window(7)
    rng = _rng(7)
    threads_n, per = 4 * max(os.cpu_count() or 1, 2), 2
    vs = [_t(rng.normal(size=(M,))) for _ in range(threads_n * per)]
    serial = SolveServer(init_serve_state(S, LAM, device="cpu"),
                         batcher=_batcher(4))
    sub = {serial.submit(v): i for i, v in enumerate(vs)}
    ref = {sub[r.uid]: r.x for r in serial.flush()}
    uid_to_i, lock = {}, threading.Lock()
    with AsyncSolveServer(init_serve_state(S, LAM, device="cpu"),
                          batcher=TokenBudgetBatcher(max_tokens=10 ** 6,
                                                     max_requests=4)) as srv:
        def producer(t):
            for j in range(per):
                i = t * per + j
                uid = srv.submit(vs[i])
                with lock:
                    uid_to_i[uid] = i

        workers = [threading.Thread(target=producer, args=(t,))
                   for t in range(threads_n)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            for w in workers:
                w.start()
            for w in workers:
                w.join(WAIT)
        finally:
            sys.setswitchinterval(interval)
        assert not any(w.is_alive() for w in workers)
        got = {uid_to_i[r.uid]: r.x for r in srv.flush(timeout=WAIT)}
    assert sorted(got) == sorted(ref)
    for i in ref:
        np.testing.assert_allclose(got[i].numpy(), ref[i].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_calls_close_microbatches():
    """The budget or a later call closes a microbatch: a ``result()``
    closes only the microbatch that holds its request, and a request
    after a ``flush`` never joins the microbatch the flush closed."""
    S = _window(2)
    v = _t(_rng(2).normal(size=(M,)))
    with AsyncSolveServer(init_serve_state(S, LAM, device="cpu"),
                          batcher=TokenBudgetBatcher(max_tokens=8,
                                                     max_requests=3)) as srv:
        a = srv.submit(v, tokens=2)
        srv.result(a, timeout=WAIT)                   # closes [a]
        srv.submit(v, tokens=2)
        srv.submit(v, tokens=2)
        srv.flush(timeout=WAIT)                       # closes [b, c]
        for _ in range(3):                            # the budget: [d, e, f]
            srv.submit(v, tokens=1)
        srv.submit(v, tokens=8)                       # over the budget: [g]
        srv.submit(v, tokens=1, tenant=None)
        srv.flush(timeout=WAIT)
        assert srv.stats.microbatches == 5
        assert srv.stats.served == 8


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def _gate(srv):
    gate = threading.Event()
    orig = srv._dispatch

    def gated(mb):
        gate.wait(WAIT)
        return orig(mb)

    srv._dispatch = gated
    return gate


def test_shutdown_drains_queue():
    S = _window(1)
    srv = AsyncSolveServer(init_serve_state(S, LAM, device="cpu"),
                           batcher=_batcher(2))
    vs = [_t(_rng(i).normal(size=(M,))) for i in range(5)]
    uids = [srv.submit(v) for v in vs]
    srv.shutdown(drain=True, timeout=WAIT)
    assert not srv._worker.is_alive()
    for uid in uids:
        assert torch.isfinite(srv.result(uid, timeout=0).x).all()
    assert srv.metrics.summary()["served"] == 5 and len(srv.batcher) == 0
    with pytest.raises(RuntimeError, match="shut down"):
        srv.submit(vs[0])


def test_shutdown_without_drain_cancels_pending():
    S = _window(1)
    srv = AsyncSolveServer(init_serve_state(S, LAM, device="cpu"),
                           batcher=_batcher(1))
    gate = _gate(srv)
    u1 = srv.submit(torch.ones(M))
    deadline = time.time() + WAIT        # the worker holds u1
    while len(srv.batcher) and time.time() < deadline:
        time.sleep(0.005)
    assert len(srv.batcher) == 0
    u2 = srv.submit(torch.ones(M))
    stopper = threading.Thread(target=lambda: srv.shutdown(drain=False))
    stopper.start()
    time.sleep(0.05)
    gate.set()
    stopper.join(WAIT)
    assert not stopper.is_alive() and not srv._worker.is_alive()
    assert torch.isfinite(srv.result(u1, timeout=WAIT).x).all()
    with pytest.raises(RuntimeError, match="cancelled"):
        srv.result(u2, timeout=WAIT)


def test_flush_does_not_steal_claimed_results():
    S = _window(1)
    with AsyncSolveServer(init_serve_state(S, LAM, device="cpu"),
                          batcher=_batcher(1)) as srv:
        gate = _gate(srv)
        uid = srv.submit(torch.ones(M))
        got = {}
        waiter = threading.Thread(
            target=lambda: got.update(res=srv.result(uid, timeout=WAIT)))
        waiter.start()
        deadline = time.time() + WAIT
        while uid not in srv._claimed and time.time() < deadline:
            time.sleep(0.005)
        gate.set()
        flushed = srv.flush(timeout=WAIT)
        waiter.join(WAIT)
    assert flushed == [] and got["res"].uid == uid


def test_callers_adaptation_not_mutated():
    S = _window(1)
    adapt = _adapt()
    mesh = make_mesh((1,), ("model",), device="cpu")
    with AsyncSolveServer(init_sharded_serve_state(
            S, LAM, spec=DistSpec(mesh, "1d"), device="cpu"),
            adaptation=adapt) as srv:
        assert adapt.dist is None and srv.adaptation is not adapt
        assert srv.adaptation.dist is not None
        assert srv.adaptation._pending_aux is not adapt._pending_aux
    state = adapt.fold(init_serve_state(S, LAM, device="cpu"),
                       torch.zeros(2, M))
    assert state.stats.adapted == 2


def test_worker_error_surfaces():
    S = _window(1)
    srv = AsyncSolveServer(init_serve_state(S, LAM, device="cpu"))

    def boom(mb):
        raise RuntimeError("injected dispatch failure")

    srv._dispatch = boom
    srv.submit(torch.ones(M))
    with pytest.raises(RuntimeError, match="worker failed"):
        srv.flush(timeout=WAIT)
    with pytest.raises(RuntimeError, match="worker failed"):
        srv.submit(torch.ones(M))
    with pytest.raises(RuntimeError, match="worker failed"):
        srv.shutdown(timeout=WAIT)
    assert not srv._worker.is_alive()


def test_shutdown_handlers_drain_then_chain():
    """The installed handler drains the queue, then calls the handler
    installed before it (a test signal, called directly; every handler
    and the exit hook are restored after)."""
    import atexit
    S = _window(1)
    srv = AsyncSolveServer(init_serve_state(S, LAM, device="cpu"),
                           batcher=_batcher(2))
    seen = []
    before = signal.getsignal(signal.SIGUSR1)
    signal.signal(signal.SIGUSR1,
                  lambda s, f: seen.append(srv.metrics.served))
    try:
        srv.install_shutdown_handlers(signals=(signal.SIGUSR1,))
        for _ in range(3):
            srv.submit(torch.ones(M))
        signal.getsignal(signal.SIGUSR1)(signal.SIGUSR1, None)
        assert seen == [3] and not srv._worker.is_alive()
    finally:
        signal.signal(signal.SIGUSR1, before)
        atexit.unregister(srv._shutdown_quietly)
        srv.shutdown(timeout=WAIT)


def test_sharded_checkpoint_restores_the_same_solves(tmp_path):
    S = _window(2, 8, 64)
    rng = _rng(2)
    spec = DistSpec(make_mesh((4,), ("model",), device="cpu"), "1d")
    v2 = _t(rng.normal(size=(64,)))
    with AsyncSolveServer(init_sharded_serve_state(S, 0.2, spec=spec,
                                                   device="cpu"),
                          adaptation=_adapt()) as srv:
        srv.submit(_t(rng.normal(size=(64,))),
                   rows=_t(rng.normal(size=(2, 64)) / 8.0))
        srv.flush(timeout=WAIT)
        evolved = srv.sharded_state()
        save_sharded_serve_state(tmp_path, 5, evolved)
        srv.submit(v2)
        (live,) = srv.flush(timeout=WAIT)
    restored, meta = restore_sharded_serve_state(tmp_path, 5, evolved)
    assert meta["layout"] == "1d"
    assert restored.fingerprint() == evolved.fingerprint()
    with AsyncSolveServer(restored) as srv2:
        srv2.submit(v2)
        (again,) = srv2.flush(timeout=WAIT)
    assert torch.equal(live.x, again.x)
