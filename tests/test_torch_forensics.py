"""The flight recorder and incident forensics of the torch port against
the JAX package: the state fingerprint, capture on a verdict escalation,
debounce and pruning, the exit capture, offline replay bit for bit with
the first bad event named, the CLI, and incident bundles written by
either package loaded and analyzed by the other.

The fault injection is the reference's (``tests/test_forensics.py``): a
window whose rows 4:6 dominate the Gram, so the fold that retires them
(seq 2 at k = 2) collapses the downdate margin. Both packages capture at
that fold and name it; after it the reference's fp32 core split leaves
its factor drifted (the residual rule stays active) while the port's
float64 split does not, so verdicts are compared up to the capture. A
replay is bit-identical on the device that recorded the bundle; across
packages a replay is checked for the events it replays and the event it
names, not for bits."""
import atexit
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.serve import OnlineAdaptation as JAdapt
from repro.serve import init_serve_state as j_init
from repro.serve.journal import FoldJournal as JJournal
from repro_torch import obs as tobs
from repro_torch.core import BlockedScores
from repro_torch.obs.forensics import format_postmortem
from repro_torch.obs.forensics import main as forensics_main
from repro_torch.serve import (FoldJournal, OnlineAdaptation, SolveServer,
                               TokenBudgetBatcher, init_serve_state,
                               restore_serve_state, save_serve_state)
from repro_torch.serve.state import (serve_state_arrays,
                                     serve_state_from_arrays)

torch.set_num_threads(1)


def _window(n=8, m=32, seed=0, poisoned=True):
    rng = np.random.default_rng(seed)
    S = rng.normal(size=(n, m)).astype(np.float32)
    if poisoned:
        S[4:6] *= 100.0
    return S


def _drive(record_dir, *, port=True, folds=5, poisoned=True, **rec_kw):
    """Fold a trace with health, audit and recorder on; returns (recorder,
    adaptation, monitor, final state, capture paths by fold, verdicts)."""
    o = tobs if port else jobs
    rng = np.random.default_rng(1)
    reg = o.MetricsRegistry()
    mon = o.HealthMonitor(reg)
    Adapt, Journal = (OnlineAdaptation, FoldJournal) if port \
        else (JAdapt, JJournal)
    ad = Adapt(refresh_every=10 ** 9, drift_tol=None, drift_frac=None,
               journal=Journal(), registry=reg, health=mon, audit_every=1)
    kw = dict(fingerprint_every=1, debounce_s=0.0)
    kw.update(rec_kw)
    rec = o.FlightRecorder(record_dir, **kw)
    S = _window(poisoned=poisoned)
    state = init_serve_state(torch.from_numpy(S), 1e-2, device="cpu") \
        if port else j_init(jnp.asarray(S), 1e-2)
    captured, verdicts = {}, []
    for i in range(folds):
        rows = rng.normal(size=(2, 32)).astype(np.float32)
        state = ad.fold(state, torch.from_numpy(rows) if port
                        else jnp.asarray(rows))
        if not port:
            jax.block_until_ready(state.L)
        state, _ = ad.maybe_refresh(state)
        path = rec.observe(state, adaptation=ad, health=mon, registry=reg)
        if path:
            captured[i] = path
        verdicts.append(mon.verdict())
    return rec, ad, mon, state, captured, verdicts


def test_fingerprint_checkpoint_invariant_and_light_disjoint(tmp_path):
    """A checkpoint round trip and the bundle's array form keep the
    fingerprint; the light (W, L) and full digests never collide; every
    fold moves both."""
    state = init_serve_state(torch.from_numpy(_window(poisoned=False)), 1e-2,
                             device="cpu")
    fp, light = state.fingerprint(), state.fingerprint(full=False)
    assert fp != light
    save_serve_state(tmp_path, 3, state)
    back, _ = restore_serve_state(tmp_path, 3, state)
    assert back.fingerprint() == fp and back.fingerprint(full=False) == light
    assert serve_state_from_arrays(*serve_state_arrays(state),
                                   device="cpu").fingerprint() == fp
    moved = OnlineAdaptation().fold(state, torch.ones(2, 32) / 8)
    assert moved.fingerprint() != fp
    assert moved.fingerprint(full=False) != light
    # the digests are the reference's: the same buffers hash the same
    from repro.serve.state import serve_state_from_arrays as j_from_arrays
    jstate = j_from_arrays(*serve_state_arrays(state))
    assert (jstate.fingerprint(), jstate.fingerprint(full=False)) == \
        (fp, light)


def test_capture_at_the_same_fold_as_jax(tmp_path):
    """Both packages capture one bundle, at fold 2, with the same metadata
    keys and journal span; the port's bundle is what the reference's
    would be."""
    trec, _, _, _, tcap, tverd = _drive(tmp_path / "t")
    jrec, _, _, _, jcap, jverd = _drive(tmp_path / "j", port=False)
    assert list(tcap) == list(jcap) == [2]
    assert tverd[:3] == jverd[:3] == ["ok", "ok", "degraded"]
    tb, jb = tobs.load_bundle(tcap[2], device="cpu"), \
        jobs.load_bundle(jcap[2])
    assert set(tb.meta) == set(jb.meta)
    for key in ("kind", "version", "reason", "verdict", "snap_seq",
                "head_seq", "base_k", "audit_every", "fifo_n"):
        assert tb.meta[key] == jb.meta[key], key
    assert [(e.seq, e.kind, e.slots) for e in tb.journal.events] == \
        [(e.seq, e.kind, e.slots) for e in jb.journal.events]
    assert len(tb.meta["fingerprints"]) == len(jb.meta["fingerprints"])
    assert trec.bundle_paths == [tcap[2]] and jrec.bundle_paths == [jcap[2]]


def test_replay_bit_identical_and_bisects(tmp_path):
    """Offline replay of the port's bundle on the CPU is bit-identical to
    the live state at capture, every fingerprint verifies, and the
    bisection names the fold the reference's names: seq 2, the margin
    rule, below its bound."""
    _, _, _, _, captured, _ = _drive(tmp_path)
    pm = tobs.analyze(tobs.load_bundle(captured[2], device="cpu"))
    assert pm["bit_identical"], pm
    assert pm["fingerprints_ok"] == pm["fingerprints_checked"] >= 2
    assert pm["events_replayed"] == pm["head_seq"] - pm["snap_seq"]
    fb = pm["first_bad"]
    assert (fb["seq"], fb["kind"], fb["rule"], fb["verdict"]) == \
        (2, "fold", "downdate_margin", "degraded")
    assert fb["value"] < fb["bound"] == 1e-3
    assert pm["timeline"][-1]["verdict"] == pm["captured_verdict"]
    text = format_postmortem(pm)
    assert "first bad event: seq=2 kind=fold rule=downdate_margin" in text
    assert "bit_identical=True" in text


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_bundles_load_in_the_other_package(direction, tmp_path):
    """A bundle of one package loads in the other — the same last-good
    state bit for bit, the same journal tail — and the other's analysis
    replays every event and names the same first bad event."""
    port = direction == "port_to_jax"
    _, _, _, _, captured, _ = _drive(tmp_path, port=port)
    path = captured[2]
    tb = tobs.load_bundle(path, device="cpu")
    jb = jobs.load_bundle(path)
    assert tb.state.fingerprint() == jb.state.fingerprint()
    for te, je in zip(tb.journal.events, jb.journal.events):
        assert (te.seq, te.kind, te.slots) == (je.seq, je.kind, je.slots)
        np.testing.assert_array_equal(te.rows.numpy(), np.asarray(je.rows))
    pm = jobs.analyze(jb) if port else tobs.analyze(tb)
    assert pm["events_replayed"] == len(tb.journal.events)
    assert (pm["first_bad"]["seq"], pm["first_bad"]["rule"]) == \
        (2, "downdate_margin")


def test_forensics_cli_and_tampered_tail(tmp_path, capsys):
    """``python -m repro_torch.obs.forensics --device cpu`` (the plain
    versions): exit 0 on a faithful bundle, the postmortem on stdout,
    ``--json`` the timeline; a perturbed event breaks bit-identity. The
    default device is the card: without one the CLI raises."""
    _, _, _, _, captured, _ = _drive(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            forensics_main([captured[2]])
    out_json = str(tmp_path / "pm.json")
    rc = forensics_main([captured[2], "--device", "cpu", "--json",
                         out_json])
    text = capsys.readouterr().out
    assert rc == 0
    assert "first bad event: seq=2 kind=fold rule=downdate_margin" in text
    with open(out_json) as f:
        pm = json.load(f)
    assert pm["bit_identical"] and len(pm["timeline"]) == 2
    bundle = tobs.load_bundle(captured[2], device="cpu")
    ev = bundle.journal.events[0]
    bundle.journal.events[0] = ev._replace(rows=ev.rows * (1 + 1e-3))
    pm = tobs.analyze(bundle)
    assert not pm["bit_identical"]
    assert pm["fingerprints_ok"] < pm["fingerprints_checked"]


def test_healthy_trace_writes_nothing(tmp_path):
    rec, _, mon, _, captured, verdicts = _drive(tmp_path, poisoned=False)
    assert verdicts == ["ok"] * 5 and captured == {}
    assert rec.bundle_paths == [] and rec._snap is not None
    assert len(rec._fingerprints) == 5
    assert os.listdir(tmp_path) == []


def test_debounce_and_prune(tmp_path):
    now = [1000.0]
    rec, _, _, _, captured, _ = _drive(tmp_path, debounce_s=60.0, keep=2,
                                       clock=lambda: now[0])
    assert len(rec.bundle_paths) == 1
    assert rec.capture("again") is None and rec.debounced == 1
    p2 = rec.capture("forced", force=True)
    now[0] += 61.0
    p3 = rec.capture("later")
    assert rec.bundle_paths == [p2, p3]
    assert os.path.exists(p2) and os.path.exists(p3)
    assert not os.path.exists(captured[2])


def test_exit_capture_writes_only_when_unhealthy(tmp_path):
    """``install_exit_capture`` registers once with ``atexit``; the hook
    writes a bundle only after a non-ok verdict and never raises."""
    rec, _, _, _, _, _ = _drive(tmp_path / "ok", poisoned=False)
    rec.install_exit_capture()
    try:
        rec.install_exit_capture()
        rec._exit_capture()
        assert rec.bundle_paths == []
    finally:
        atexit.unregister(rec._exit_capture)
    # three folds: the process ends on the degraded verdict of fold 2
    bad, _, _, _, _, _ = _drive(tmp_path / "bad", folds=3, debounce_s=1e9)
    bad.install_exit_capture()
    try:
        bad._exit_capture()
        assert bad.bundle_paths[-1].endswith("_exit_unclean.npz")
        bad.record_dir = str(tmp_path / "f" / "\0")   # unwritable
        bad._exit_capture()                           # swallowed
    finally:
        atexit.unregister(bad._exit_capture)


def test_server_flush_drives_recorder(tmp_path):
    """Through the port's server: a digest a request at the response
    boundary, one observe a flush; a forced bundle of a healthy run
    replays bit for bit with no bad event."""
    rng = np.random.default_rng(11)
    reg = tobs.MetricsRegistry()
    mon = tobs.HealthMonitor(reg)
    rec = tobs.FlightRecorder(tmp_path, fingerprint_every=1)
    srv = SolveServer(
        init_serve_state(torch.from_numpy(_window(poisoned=False)), 1e-2,
                         device="cpu"),
        batcher=TokenBudgetBatcher(max_requests=2),
        adaptation=OnlineAdaptation(refresh_every=10 ** 9, drift_tol=None,
                                    drift_frac=None, journal=FoldJournal(),
                                    audit_every=1),
        monitor_drift=False, registry=reg, health=mon, recorder=rec)
    uids = []
    for _ in range(2):          # two flushes of two requests
        batch = [srv.submit(torch.from_numpy(rng.normal(size=(32,))
                                             .astype(np.float32)),
                            rows=torch.from_numpy(rng.normal(size=(1, 32))
                                                  .astype(np.float32)) / 8)
                 for _ in range(2)]
        assert {r.uid for r in srv.flush()} == set(batch)
        uids += batch
    assert {d["uid"] for d in rec._requests} == set(uids)
    assert all(d["latency_s"] is not None and d["k_rows"] == 1
               for d in rec._requests)
    assert rec.bundle_paths == [] and len(rec._fingerprints) == 2
    # the last-good snapshot is the first flush's end: the tail is the
    # second flush's two folds
    pm = tobs.analyze(tobs.load_bundle(rec.capture("probe", force=True),
                                       device="cpu"))
    assert pm["bit_identical"] and pm["first_bad"] is None
    assert (pm["snap_seq"], pm["head_seq"], pm["events_replayed"]) == \
        (2, 4, 2)


@pytest.mark.parametrize("blocked", [False, True], ids=["dense", "blocked"])
def test_bf16_window_bundle_loads_in_jax(blocked, tmp_path):
    """A bf16 window (dense or blocked) in a forced bundle: its uint16
    arrays and dtype tags rebuild the same state in both packages, and
    its journal rows come back as bf16."""
    S = torch.from_numpy(_window(poisoned=False))
    if blocked:
        S = BlockedScores.from_dense(S, (20, 12), names=("a", "b"))
    ad = OnlineAdaptation(journal=FoldJournal())
    state = init_serve_state(S, 1e-2, window_dtype="bfloat16", device="cpu")
    rows = torch.ones(2, 32) / 8
    state = ad.fold(state, (rows[:, :20], rows[:, 20:]) if blocked else rows)
    rec = tobs.FlightRecorder(tmp_path)
    rec._take_snapshot(init_serve_state(S, 1e-2, window_dtype="bfloat16",
                                        device="cpu"), None)
    rec.observe(state, adaptation=ad)
    path = rec.capture("probe", force=True)
    tb, jb = tobs.load_bundle(path, device="cpu"), jobs.load_bundle(path)
    assert tb.state.fingerprint() == jb.state.fingerprint()
    assert tb.meta["journal"]["events"] == jb.meta["journal"]["events"]
    for te, je in zip(tb.journal.events, jb.journal.events):
        trows = te.rows if blocked else (te.rows,)
        jrows = je.rows if blocked else (je.rows,)
        for t, j in zip(trows, jrows):
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(j, np.float32))
    pm = tobs.analyze(tb)
    assert pm["bit_identical"] and pm["events_replayed"] == 1
