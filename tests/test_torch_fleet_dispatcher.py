"""The port's ``Dispatcher`` against the reference's, on the same worker
stubs: routing (round robin, sticky ``by_adapter``, least loaded),
placement through a failure, rerouting in flight, a dead fleet, draining
shutdown and the gossip broadcast. Each case drives both dispatchers
through one scenario, each over its own stubs, and holds their
``assignments`` (uid → serving worker) and results to each other.

The stub is the port's own copy of the reference's ``FakeWorker``
(``tests/test_fleet.py``): it answers a solve with ``v + worker_id`` on a
``socket.socketpair`` from a daemon thread, and can hold replies or die
on command. Its end speaks the port's wire; the reference dispatcher's
end is the reference's ``Channel`` with its msgpack codec off, so both
write JSON headers. Every thread is joined in a ``finally`` and every
wait has a timeout."""
import socket
import threading

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.fleet as ref_fleet  # noqa: E402
from repro.fleet import wire as ref_wire  # noqa: E402
import repro_torch.fleet as port_fleet  # noqa: E402
from repro_torch.fleet import wire  # noqa: E402

FLEETS = {"port": port_fleet, "ref": ref_fleet}


@pytest.fixture(autouse=True)
def no_msgpack(monkeypatch):
    monkeypatch.setattr(ref_wire, "_msgpack", None)


class FakeWorker:
    """Protocol-speaking worker stub: answers solves with a worker-id-
    stamped echo, tracks folds, and can hold replies or die on command."""

    def __init__(self, worker_id, fleet, *, n=8, hold=False):
        self.worker_id = worker_id
        self.n = n
        self.received = []          # uids in arrival order
        self.folds = []             # seqs in applied order
        self.hold = threading.Event()
        if not hold:
            self.hold.set()
        self._die = threading.Event()
        here, there = socket.socketpair()
        self.chan = wire.Channel(here, name=f"fake{worker_id}")
        self.peer = fleet.Channel(there, name=f"disp{worker_id}")
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def die(self):
        self._die.set()
        self.hold.set()

    def _run(self):
        try:
            while True:
                msg = self.chan.recv()
                if msg.kind == "init":
                    self.chan.send("init_ok", {"worker_id": self.worker_id,
                                               "n": self.n})
                elif msg.kind == "solve":
                    self.hold.wait(30)
                    if self._die.is_set():
                        self.chan.close()       # swallow request, drop link
                        return
                    self.received.append(msg.meta["uid"])
                    arrays = {}
                    meta = {"uid": msg.meta["uid"],
                            "damping": msg.meta.get("damping") or 0.1,
                            "latency_s": 0.0}
                    wire.put_blocks(arrays, meta, "x",
                                    wire.get_blocks(msg, "v")
                                    + self.worker_id)
                    self.chan.send("result", meta, arrays)
                elif msg.kind == "fold":
                    self.folds.append(msg.meta["seq"])
                elif msg.kind == "ping":
                    self.chan.send("pong", {"worker_id": self.worker_id,
                                            "queued": 0,
                                            "applied": len(self.folds),
                                            "served": len(self.received)})
                elif msg.kind == "drain":
                    self.chan.send("drained", {"worker_id": self.worker_id})
                elif msg.kind == "bye":
                    return
        except wire.WireError:
            return
        finally:
            self.chan.close()


def _fake_fleet(fleet, n_workers, route, *, gossip=True, hold=()):
    fakes = [FakeWorker(i, fleet, hold=i in hold) for i in range(n_workers)]
    disp = fleet.Dispatcher(
        [fleet.WorkerHandle(f.worker_id, f.peer) for f in fakes],
        route=route, gossip=gossip)
    disp.init_workers({"mode": "inline", "damping": 0.1})
    return disp, fakes


def _zeros():
    return np.zeros(4, np.float32)


def round_robin(disp, fakes):
    for i in range(6):
        disp.submit(np.full(4, i, np.float32))
    results = disp.flush(timeout=30)
    assert [r.uid for r in results] == list(range(6))      # FIFO order
    assert [len(f.received) for f in fakes] == [3, 3]
    return [float(r.x[0]) for r in results]


def by_adapter_sticky(disp, fakes):
    for i in range(12):
        disp.submit(_zeros(), adapter=f"user{i % 4}")
    disp.flush(timeout=30)
    for a in range(4):
        assert len({disp.assignments[u] for u in range(a, 12, 4)}) == 1
    assert len({disp.assignments[u] for u in range(12)}) > 1


def placement_survives_failure(disp, fakes):
    adapters = [f"user{i}" for i in range(9)]
    first = {a: disp.submit(_zeros(), adapter=a) for a in adapters}
    disp.flush(timeout=30)
    before = {a: disp.assignments[first[a]] for a in adapters}
    assert len(set(before.values())) == 3
    victim = before[adapters[0]]
    fakes[victim].die()
    second = {a: disp.submit(_zeros(), adapter=a) for a in adapters}
    assert len(disp.flush(timeout=30)) == len(adapters)
    for a in adapters:
        now = disp.assignments[second[a]]
        assert now != victim if before[a] == victim else now == before[a]


def least_loaded(disp, fakes):
    first = disp.submit(_zeros())
    busy = disp.assignments[first]
    other = 1 - busy
    fakes[other].hold.set()          # the other worker serves freely
    for _ in range(5):
        disp.submit(_zeros())
        # wait until only the held request is in flight, so the next
        # routing decision sees the true (1 vs 0) load split
        deadline = disp.clock() + 10
        while disp.pending() > 1 and disp.clock() < deadline:
            disp._pump(0.01)
    fakes[busy].hold.set()
    disp.flush(timeout=30)
    assert all(disp.assignments[u] == other for u in range(1, 6))


def reroute_in_flight(disp, fakes):
    uids = [disp.submit(np.full(4, i, np.float32)) for i in range(6)]
    victim = disp.assignments[uids[0]]
    survivor = 1 - victim
    fakes[victim].die()              # close mid-flight, swallow one
    fakes[survivor].hold.set()
    results = disp.flush(timeout=30)
    assert len(results) == 6
    assert all(disp.assignments[u] == survivor for u in uids)
    assert not disp.workers[victim].alive
    # every result computed by the survivor (x = v + worker_id)
    return [float(r.x[0]) - r.uid for r in results]


def all_dead_raises(disp, fakes):
    disp.submit(_zeros())
    fakes[0].die()
    with pytest.raises(RuntimeError, match="no alive workers"):
        disp.flush(timeout=30)


def drain_shutdown(disp, fakes):
    for _ in range(4):
        disp.submit(_zeros())
    disp.shutdown(drain=True, timeout=30)
    assert disp.metrics.summary()["served"] == 4
    assert all(not w.alive for w in disp.workers)


def gossip_broadcast(disp, fakes):
    rows = np.zeros((2, 4), np.float32)
    disp.submit(_zeros(), rows=rows)
    disp.submit(_zeros(), rows=rows)
    disp.flush(timeout=30)
    disp.reconcile(timeout=30)
    assert [f.folds for f in fakes] == [[0, 1], [0, 1]]
    assert disp.log.head == 2
    return [e.slots for e in disp.log.events]


# scenario: (workers, route, holds, drain at shutdown)
SCENARIOS = {
    round_robin: (2, "round_robin", (), True),
    by_adapter_sticky: (3, "by_adapter", (), True),
    placement_survives_failure: (3, "by_adapter", (), False),
    least_loaded: (2, "least_loaded", (0, 1), True),
    reroute_in_flight: (2, "round_robin", (0, 1), True),
    all_dead_raises: (1, "round_robin", (0,), False),
    drain_shutdown: (2, "round_robin", (), True),
    gossip_broadcast: (2, "round_robin", (), True),
}


def _run(package, scenario):
    n_workers, route, hold, drain = SCENARIOS[scenario]
    disp, fakes = _fake_fleet(FLEETS[package], n_workers, route, hold=hold)
    try:
        seen = scenario(disp, fakes)
        return dict(disp.assignments), seen
    finally:
        disp.shutdown(drain=drain, timeout=10)
        for f in fakes:
            f.die()
            f.peer.close()
            f.thread.join(timeout=10)
            assert not f.thread.is_alive()


@pytest.mark.parametrize("scenario", list(SCENARIOS),
                         ids=[s.__name__ for s in SCENARIOS])
def test_dispatcher_matches_the_reference(scenario):
    port = _run("port", scenario)
    ref = _run("ref", scenario)
    assert port == ref
