"""The fold journal and the serve-state checkpoints of the torch port
against the JAX package: journal semantics (absolute sequence numbers,
compaction, ordered replay), the port's replay bit for bit against its
own live run, the same fold/refresh trace through both packages, and
journal npz files and serve-state checkpoints written by either package
loaded by the other.

Tolerances: the port against JAX, rtol 2e-4 / atol 2e-5 — the reference's
own serving tests' bound for a served solve against its oracle
(``tests/test_serve.py:61``); the port against itself and every file round
trip, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.operator import BlockedScores as JBlocked
from repro.serve import (OnlineAdaptation as JAdapt,
                         init_serve_state as j_init,
                         restore_serve_state as j_restore,
                         save_serve_state as j_save)
from repro.serve.journal import FoldJournal as JJournal
from repro_torch.core import BlockedScores
from repro_torch.serve import (FoldEvent, FoldJournal, OnlineAdaptation,
                               init_serve_state, restore_serve_state,
                               save_serve_state)

torch.set_num_threads(1)

N, M, LAM = 12, 96, 0.05
WIDTHS = (40, 32, 24)
RTOL, ATOL = 2e-4, 2e-5
KINDS = ["dense", "blocked", "bf16"]


def _data(seed=0, folds=7):
    rng = np.random.default_rng(seed)
    S = (rng.normal(size=(N, M)) / np.sqrt(M)).astype(np.float32)
    rows = [(rng.normal(size=(1 + i % 3, M)) / np.sqrt(M)).astype(np.float32)
            for i in range(folds)]
    return S, rows


def _split(a):
    offs = np.cumsum((0,) + WIDTHS)
    return tuple(np.ascontiguousarray(a[..., offs[i]:offs[i + 1]])
                 for i in range(len(WIDTHS)))


def _port_state(S, kind):
    St = torch.from_numpy(S)
    if kind == "blocked":
        St = BlockedScores.from_dense(St, WIDTHS)
    return init_serve_state(St, LAM, device="cpu",
                            window_dtype="bfloat16" if kind == "bf16"
                            else None)


def _jax_state(S, kind):
    Sj = jnp.asarray(S)
    if kind == "blocked":
        Sj = JBlocked.from_dense(Sj, WIDTHS)
    return j_init(Sj, LAM, window_dtype=jnp.bfloat16 if kind == "bf16"
                  else None)


def _rows(r, kind, port):
    if kind == "blocked":
        parts = _split(r)
        return tuple(torch.from_numpy(p) for p in parts) if port else \
            tuple(jnp.asarray(p) for p in parts)
    return torch.from_numpy(r) if port else jnp.asarray(r)


def _drive(adapt, state, rows, kind, port):
    """Folds with a forced refresh after the 3rd and the 6th."""
    for i, r in enumerate(rows):
        state = adapt.fold(state, _rows(r, kind, port))
        if i % 3 == 2:
            state, _ = adapt.maybe_refresh(state, force=True)
    return state


def _blocks(S):
    return S.blocks if hasattr(S, "blocks") else (S,)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(tstate, jstate):
    for a, b in zip(_blocks(tstate.S), _blocks(jstate.S)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(tstate.W), _np(jstate.W), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(_np(tstate.L), _np(jstate.L), rtol=RTOL,
                               atol=ATOL)
    assert tstate.slot == int(jstate.slot)
    assert tstate.stats.adapted == int(jstate.stats.adapted)
    assert tstate.stats.refreshes == int(jstate.stats.refreshes)


def test_journal_sequence_compaction_and_order():
    """Absolute sequence numbers survive compaction; history below the
    base raises; an externally sequenced event must continue the order —
    as ``repro.serve.journal``."""
    j = FoldJournal()
    j.append_fold((0, 1), torch.zeros(2, 4))
    j.append_refresh()
    j.append_fold((2,), torch.zeros(1, 4), origin="r1")
    assert (j.head, j.total_k, len(j)) == (3, 3, 3)
    assert [e.seq for e in j.events_since(1)] == [1, 2]
    with pytest.raises(ValueError, match="does not continue"):
        j.append_event(FoldEvent(seq=7, kind="refresh", slots=(), rows=None))
    j.append_event(FoldEvent(seq=3, kind="refresh", slots=(), rows=None))
    assert j.compact(2) == 2 and (j.base, j.base_k, j.head) == (2, 2, 4)
    assert j.compact(1) == 0 and j.total_k == 3
    with pytest.raises(ValueError, match="compacted"):
        j.events_since(1)
    assert j.compact(99) == 2 and (j.base, j.head, len(j)) == (4, 4, 0)
    with pytest.raises(ValueError, match="first event seq"):
        FoldJournal([FoldEvent(seq=3, kind="refresh", slots=(), rows=None)])


@pytest.mark.parametrize("kind", KINDS)
def test_replay_and_npz_reload_are_bit_identical(kind, tmp_path):
    """The port's replay from the initial state lands on its live run's
    full fingerprint (window, W and L), from the journal in memory and
    from its npz."""
    S, rows = _data(1)
    init = _port_state(S, kind)
    journal = FoldJournal()
    live = _drive(OnlineAdaptation(journal=journal), init, rows, kind, True)
    assert [e.kind for e in journal.events].count("refresh") == 2
    replayed = journal.replay(init, OnlineAdaptation())
    assert replayed.fingerprint() == live.fingerprint()
    journal.save(tmp_path / "j.npz")
    loaded = FoldJournal.load(tmp_path / "j.npz")
    assert [(e.seq, e.kind, e.slots) for e in loaded.events] == \
        [(e.seq, e.kind, e.slots) for e in journal.events]
    again = loaded.replay(init, OnlineAdaptation())
    assert again.fingerprint() == live.fingerprint()
    assert (again.slot, again.stats) == (live.slot, live.stats)


@pytest.mark.parametrize("kind", KINDS)
def test_journal_trace_matches_jax(kind):
    """One fold/refresh trace through both packages: the same events and
    slots, and the final window, W and L within the serving tolerance."""
    S, rows = _data(2)
    jj, tj = JJournal(), FoldJournal()
    jstate = _drive(JAdapt(journal=jj), _jax_state(S, kind), rows, kind,
                    False)
    tstate = _drive(OnlineAdaptation(journal=tj), _port_state(S, kind),
                    rows, kind, True)
    assert [(e.seq, e.kind, e.slots) for e in tj.events] == \
        [(e.seq, e.kind, e.slots) for e in jj.events]
    _close(tstate, jstate)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_journal_npz_loads_in_the_other_package(direction, tmp_path):
    """A journal written by one package (a compacted one: base and base_k
    ride the manifest) replays in the other onto the same initial window."""
    S, rows = _data(3)
    path = tmp_path / "j.npz"
    jinit, tinit = _jax_state(S, "dense"), _port_state(S, "dense")
    if direction == "jax_to_port":
        jj = JJournal()
        ad = JAdapt(journal=jj)
        mid = _drive(ad, jinit, rows[:3], "dense", False)
        jj.compact(jj.head)
        live = _drive(ad, mid, rows[3:], "dense", False)
        jj.save(path)
        loaded = FoldJournal.load(path)
        assert (loaded.base, loaded.base_k) == (jj.base, jj.base_k)
        start = _drive(OnlineAdaptation(), tinit, rows[:3], "dense", True)
        _close(loaded.replay(start, OnlineAdaptation()), live)
    else:
        tj = FoldJournal()
        ad = OnlineAdaptation(journal=tj)
        mid = _drive(ad, tinit, rows[:3], "dense", True)
        tj.compact(tj.head)
        live = _drive(ad, mid, rows[3:], "dense", True)
        tj.save(path)
        loaded = JJournal.load(path)
        assert (loaded.base, loaded.base_k) == (tj.base, tj.base_k)
        start = _drive(JAdapt(), jinit, rows[:3], "dense", False)
        _close(live, loaded.replay(start, JAdapt()))


def test_replay_out_of_order_raises_and_record_false():
    """Slots are verified against the local cursor; ``record=False`` keeps
    a replayed fold out of the journal and ``on_fold``; ``on_fold`` sees
    every recorded fold."""
    S, rows = _data(4, folds=2)
    seen = []
    journal = FoldJournal()
    ad = OnlineAdaptation(journal=journal, on_fold=seen.append)
    st = _port_state(S, "dense")
    with pytest.raises(ValueError, match="out of order"):
        ad.fold(st, torch.from_numpy(rows[0]), slots=(3,))
    st = ad.fold(st, torch.from_numpy(rows[0]), slots=(0,))
    st = ad.fold(st, torch.from_numpy(rows[1]), record=False)
    assert [e.seq for e in seen] == [0] and journal.head == 1
    assert seen[0] is journal.events[0] and seen[0].slots == (0,)
    cb = []
    OnlineAdaptation(on_fold=cb.append).fold(st, torch.from_numpy(rows[0]))
    assert cb[0].seq == -1 and cb[0].slots == (3,)


@pytest.mark.parametrize("kind", KINDS)
def test_serve_state_checkpoint_round_trip(kind, tmp_path):
    """``save_serve_state`` then ``restore_serve_state`` is bit-equal,
    with the reference's metadata; keep-last-k prunes."""
    S, rows = _data(5, folds=3)
    st = _drive(OnlineAdaptation(), _port_state(S, kind), rows, kind, True)
    st = st._replace(age=5, stats=st.stats._replace(served=9,
                                                    last_residual=0.25))
    for step in (1, 2, 3, 4):
        save_serve_state(tmp_path, step, st, metadata={"note": step})
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_000000002", "step_000000003", "step_000000004"]
    back, meta = restore_serve_state(tmp_path, 4, _port_state(S, kind))
    assert meta == {"kind": "serve_state", "blocked": kind == "blocked",
                    "note": 4}
    assert back.fingerprint() == st.fingerprint()
    assert (back.lam0, back.slot, back.age, back.stats) == \
        (st.lam0, st.slot, st.age, st.stats)
    if kind == "blocked":
        assert back.S.names == st.S.names


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_serve_state_checkpoint_loads_in_the_other_package(direction,
                                                          tmp_path):
    """A serve-state checkpoint of either package restores in the other
    bit for bit (a bf16 window through its uint16 view), scalars and
    counters included."""
    S, rows = _data(6, folds=3)
    if direction == "port_to_jax":
        st = _drive(OnlineAdaptation(), _port_state(S, "bf16"), rows,
                    "bf16", True)
        save_serve_state(tmp_path, 3, st)
        back, meta = j_restore(tmp_path, 3, _jax_state(S, "bf16"))
        port, jx = st, back
    else:
        st = _drive(JAdapt(), _jax_state(S, "bf16"), rows, "bf16", False)
        j_save(tmp_path, 3, st)
        back, meta = restore_serve_state(tmp_path, 3,
                                         _port_state(S, "bf16"))
        port, jx = back, st
    assert meta["kind"] == "serve_state" and meta["blocked"] is False
    assert port.fingerprint() == jx.fingerprint()
    assert (port.lam0, port.slot, port.age) == \
        (float(jx.lam0), int(jx.slot), int(jx.age))
    assert tuple(port.stats) == tuple(
        type(v)(np.asarray(w)) for v, w in zip(port.stats, jx.stats))
    assert port.S.dtype == torch.bfloat16 and jx.S.dtype == jnp.bfloat16
    jax.block_until_ready(jx.L)
