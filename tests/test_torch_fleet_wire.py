"""The fleet's protocol half against the reference (``repro.fleet``): the
wire frames, the gossip log and replay buffer, the hash ring and the fleet
manifests. No threads and no subprocess: both ends of a
``socket.socketpair`` live in the test, and every frame fits the socket's
buffer. The reference's msgpack codec is turned off, as its own JSON
fallback test does (``tests/test_fleet.py``), so it writes the JSON
headers the port reads and writes."""
import json
import socket
import struct

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
ml_dtypes = pytest.importorskip("ml_dtypes")

from repro.checkpoint import fleet as ref_manifest  # noqa: E402
from repro.fleet import gossip as ref_gossip  # noqa: E402
from repro.fleet import ring as ref_ring  # noqa: E402
from repro.fleet import wire as ref_wire  # noqa: E402
from repro.serve.journal import FoldJournal as RefJournal  # noqa: E402
from repro_torch.checkpoint import fleet as manifest  # noqa: E402
from repro_torch.fleet import gossip, ring, wire  # noqa: E402
from repro_torch.serve.journal import FoldJournal  # noqa: E402

PACKAGES = {"port": wire, "ref": ref_wire}


@pytest.fixture
def no_msgpack(monkeypatch):
    monkeypatch.setattr(ref_wire, "_msgpack", None)


def _pair(sender, receiver):
    a, b = socket.socketpair()
    return (PACKAGES[sender].Channel(a, name="tx"),
            PACKAGES[receiver].Channel(b, name="rx"))


def _message(mod):
    rng = np.random.default_rng(0)
    v = rng.normal(size=(12,)).astype(np.float32)
    blocks = (rng.normal(size=(2, 3)).astype(np.float32),
              rng.normal(size=(2, 5)))
    arrays, meta = {}, {"uid": 7, "damping": None, "tag": "x",
                        "slots": [3, 4]}
    mod.put_blocks(arrays, meta, "v", v)
    mod.put_blocks(arrays, meta, "rows", blocks)
    return meta, arrays, v, blocks


def _header(raw_sock) -> bytes:
    """The codec byte and header of the next frame, read off the socket."""
    frame_len, header_len = struct.unpack(">II", raw_sock.recv(8))
    header = raw_sock.recv(header_len)
    raw_sock.recv(frame_len - 4 - header_len, socket.MSG_WAITALL)
    return header


@pytest.mark.parametrize("sender,receiver", [("port", "ref"), ("ref", "port")])
def test_wire_round_trip_across_packages(sender, receiver, no_msgpack):
    """Dense and blocked arrays cross bit for bit, meta intact, and both
    packages write the same header bytes for the same message."""
    tx, rx = _pair(sender, receiver)
    try:
        meta, arrays, v, blocks = _message(PACKAGES[sender])
        tx.send("solve", meta, arrays)
        msg = rx.recv(timeout=10)
        assert msg.kind == "solve" and msg.meta == meta
        got_v = PACKAGES[receiver].get_blocks(msg, "v")
        assert got_v.dtype == v.dtype and got_v.tobytes() == v.tobytes()
        got = PACKAGES[receiver].get_blocks(msg, "rows")
        assert isinstance(got, tuple) and len(got) == 2
        for g, b in zip(got, blocks):
            assert g.dtype == b.dtype and g.tobytes() == b.tobytes()
        assert PACKAGES[receiver].get_blocks(msg, "missing") is None
        rx.send("pong", {"queued": 0})          # array-free frame back
        assert tx.recv(timeout=10).kind == "pong"
    finally:
        tx.close()
        rx.close()
    headers = []
    for mod in (wire, ref_wire):
        a, b = socket.socketpair()
        meta, arrays, _, _ = _message(mod)
        mod.Channel(a).send("solve", meta, arrays)
        headers.append(_header(b))
        a.close()
        b.close()
    assert headers[0] == headers[1] and headers[0][:1] == b"J"


def test_msgpack_header_raises_the_reference_message():
    """A reference with msgpack writes ``M`` headers: the port refuses
    them with the reference's own message for a missing msgpack."""
    pytest.importorskip("msgpack")
    tx, rx = _pair("ref", "port")
    try:
        tx.send("ping", {"barrier": True})
        with pytest.raises(wire.WireError, match="msgpack is not installed"):
            rx.recv(timeout=10)
    finally:
        tx.close()
        rx.close()


def test_peer_close_raises_wire_error():
    a, b = socket.socketpair()
    tx, rx = wire.Channel(a), wire.Channel(b)
    tx.close()
    with pytest.raises(wire.WireError, match="peer closed"):
        rx.recv(timeout=10)
    with pytest.raises(wire.WireError):
        tx.send("ping", {})
    rx.close()


def test_bf16_blocks_round_trip(no_msgpack):
    """A bf16 tensor crosses as ``|V2`` records and comes back bf16 bit for
    bit; a reference frame carrying an ``ml_dtypes`` bfloat16 array loads
    as the same bf16 tensor."""
    x = np.random.default_rng(1).normal(size=(3, 17)).astype(np.float32)
    xb = x.astype(ml_dtypes.bfloat16)
    t = torch.from_numpy(xb.view(np.int16).copy()).view(torch.bfloat16)
    for sender, value in (("port", (t, t[:, :5])), ("ref", (xb, xb[:, :5]))):
        tx, rx = _pair(sender, "port")
        try:
            arrays, meta = {}, {"window_dtype": "bfloat16"}
            PACKAGES[sender].put_blocks(arrays, meta, "rows", value)
            tx.send("fold", meta, arrays)
            got = wire.get_blocks(rx.recv(timeout=10), "rows")
            assert all(g.dtype == np.dtype("V2") for g in got)
            back = tuple(wire.tensor_of(g) for g in got)
            assert all(b.dtype == torch.bfloat16 for b in back)
            assert torch.equal(back[0].view(torch.int16), t.view(torch.int16))
            assert torch.equal(back[1], t[:, :5])
        finally:
            tx.close()
            rx.close()


def _fill(log, rng):
    evs = []
    for k in (2, 2, 3, 1, 4, 2):
        evs.append(log.append(rng.normal(size=(k, 4)).astype(np.float32),
                              origin=f"req{len(evs)}"))
    return evs


def test_gossip_log_against_reference(tmp_path):
    """The same admissions give the same slots, sequence and cursor in
    both packages — through the FIFO wrap, a compaction and a log resumed
    from the compacted journal — and the port's journal npz loads in the
    reference with every event's rows bit for bit."""
    logs = (gossip.GossipLog(5), ref_gossip.GossipLog(5))
    evs = [_fill(log, np.random.default_rng(2)) for log in logs]
    assert [(e.seq, e.slots, e.origin) for e in evs[0]] == \
        [(e.seq, e.slots, e.origin) for e in evs[1]]
    for log in logs:
        assert log.compact(3) == 3
    assert [(log.head, log.base, log.slot) for log in logs[:1]] == \
        [(log.head, log.base, log.slot) for log in logs[1:]]
    assert [e.seq for e in logs[0].since(4)] == \
        [e.seq for e in logs[1].since(4)]
    for log in logs:
        with pytest.raises(ValueError):
            log.since(1)
    resumed = (gossip.GossipLog(5, journal=logs[0].journal),
               ref_gossip.GossipLog(5, journal=logs[1].journal))
    rows = np.ones((3, 4), np.float32)
    assert resumed[0].append(rows).slots == resumed[1].append(rows).slots

    path = tmp_path / "gossip.npz"
    logs[0].journal.save(path)
    loaded = RefJournal.load(path)
    assert (loaded.base, loaded.base_k, loaded.head) == \
        (logs[1].journal.base, logs[1].journal.base_k, logs[1].journal.head)
    for a, b in zip(loaded.events, logs[1].journal.events):
        assert (a.seq, a.slots, a.origin) == (b.seq, b.slots, b.origin)
        assert np.asarray(a.rows).tobytes() == np.asarray(b.rows).tobytes()
    back = FoldJournal.load(path)
    assert [e.slots for e in back.events] == \
        [e.slots for e in logs[0].journal.events]


def test_replay_buffer_against_reference():
    """Out-of-order offers, a gap and duplicates release the same runs."""
    log = gossip.GossipLog(6)
    evs = _fill(log, np.random.default_rng(3))
    bufs = (gossip.ReplayBuffer(), ref_gossip.ReplayBuffer())
    order = [2, 1, 4, 0, 1, 3, 5, 5, 0]
    runs = [[[e.seq for e in buf.offer(evs[i])] for i in order]
            for buf in bufs]
    assert runs[0] == runs[1]
    assert runs[0][3] == [0, 1, 2] and runs[0][5] == [3, 4]
    assert [(b.applied, len(b)) for b in bufs] == [(6, 0), (6, 0)]


def test_hash_ring_against_reference():
    """Every key of 1,000 lands on the same member in both packages, and
    removing one member moves only its keys (~1/8 of them) in both."""
    rings = (ring.HashRing(str(i) for i in range(8)),
             ref_ring.HashRing(str(i) for i in range(8)))
    keys = [f"tenant{i}" for i in range(1000)]
    before = [{k: r.lookup(k) for k in keys} for r in rings]
    assert before[0] == before[1]
    for r in rings:
        r.remove("3")
    after = [{k: r.lookup(k) for k in keys} for r in rings]
    assert after[0] == after[1]
    moved = [k for k in keys if before[0][k] != after[0][k]]
    assert moved and all(before[0][k] == "3" for k in moved)
    assert len(moved) < len(keys) * 2.5 / 8
    spill = [{k: r.lookup(k, avoid={"5"}) for k in keys} for r in rings]
    assert spill[0] == spill[1]
    assert all(spill[0][k] == after[0][k] for k in keys
               if after[0][k] != "5")


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_fleet_manifest_across_packages(writer, tmp_path):
    """A manifest written by either package loads in the other, and both
    find the newest step."""
    mods = {"port": manifest, "ref": ref_manifest}
    other = mods["ref" if writer == "port" else "port"]
    body = {"step": 7, "route": "round_robin", "gossip": True,
            "gossip_head": 12, "gossip_base": 0,
            "gossip_journal": "gossip_000000007.npz",
            "workers": {"0": {"applied": 12}, "1": {"applied": 12}},
            "incidents": {}}
    for step in (3, 7):
        path = mods[writer].save_fleet_manifest(tmp_path, step,
                                                {**body, "step": step})
    assert path.name == "fleet_000000007.json"
    assert other.load_fleet_manifest(tmp_path, 7) == body
    assert json.loads(path.read_text()) == body
    assert other.latest_fleet_step(tmp_path) == 7
    assert manifest.latest_fleet_step(tmp_path / "none") is None
