"""The torch port's ``TenantManager`` against ``repro.tenants.TenantManager``
on the same numpy folds over the same base window (CPU, plain versions):

* folds — slots, the journal's dual-sized rows ((k, n), or (k, n + 1) with
  the signs riding along), the deltas and their cursors;
* residency — the LRU evicts the same tenants in the same order under the
  same byte budget, with equal ``resident_bytes``, ``stats`` and
  ``packing_stats``; the exempt tenant alone may exceed the budget;
* evict then activate gives the delta and L_t bit for bit as never
  evicting (a fold that lands while spilled replays from the journal);
* the factor cache: hits, invalidation by a tenant fold, a base fold and
  a λ away from λ₀ (λ₀ rounded to fp32, compared exactly), L_t against
  the reference's;
* the registry's ``tenants.*`` instruments, ``delta_core_condest``
  max-merged;
* spill npz files — fp32 and bf16 — read across the packages both ways,
  and a spill written by one package's manager activated by the other's.

Tolerances: 1e-5 relative for deltas and factors (fp32 on both sides,
``tests/test_torch_tenants.py``'s TOL); bit for bit within the port.
Fixed numpy seeds; every file under ``tmp_path``; no thread, no server.
"""
import tempfile

import ml_dtypes
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from _torch_parity import pair, rel  # noqa: E402
from repro import tenants as jten  # noqa: E402
from repro.checkpoint import fleet as jfleet  # noqa: E402
from repro.obs import MetricsRegistry as JRegistry  # noqa: E402
from repro.serve import init_serve_state as j_init  # noqa: E402
from repro_torch.checkpoint.fleet import (load_tenant_spill,  # noqa: E402
                                          save_tenant_spill)
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.serve import init_serve_state  # noqa: E402
from repro_torch.tenants import (TenantManager, TenantStats,  # noqa: E402
                                 delta_nbytes, init_tenant_delta)

torch.set_num_threads(1)

TOL = 1e-5
N, M, LAM0 = 10, 120, 0.1


def _dt(complex_):
    return "complex64" if complex_ else "float32"


def _draw(rng, shape, complex_):
    a = rng.normal(size=shape) / np.sqrt(M)
    return a + 1j * rng.normal(size=shape) / np.sqrt(M) if complex_ else a


def _states(complex_=False, lam0=LAM0, seed=0):
    Sj, St = pair(_draw(np.random.default_rng(seed), (N, M), complex_),
                  _dt(complex_))
    return j_init(Sj, lam0), init_serve_state(St, lam0, device="cpu")


def _rows(k, seed, complex_=False):
    return pair(_draw(np.random.default_rng(seed), (k, M), complex_),
                _dt(complex_))


def _managers(tmp_path, rank, **kw):
    return (jten.TenantManager(rank, spill_dir=tmp_path / "jax", **kw),
            TenantManager(rank, spill_dir=tmp_path / "port", **kw))


def _fold_both(mj, mt, js, ts, tid, k, seed, complex_=False, signs=None):
    Rj, Rt = _rows(k, seed, complex_)
    return mj.fold(js, tid, Rj, signs=signs), mt.fold(ts, tid, Rt,
                                                      signs=signs)


def _same_delta(dj, dt, tol=TOL):
    assert rel(dt.cols, dj.cols) < tol
    assert np.array_equal(dt.signs.numpy(), np.asarray(dj.signs))
    assert (dt.cursor, dt.age) == (int(dj.cursor), int(dj.age))


def _spy_evictions(mgr):
    order, evict = [], mgr.evict

    def spy(tid):
        order.append(tid)
        return evict(tid)
    mgr.evict = spy
    return order


@pytest.mark.parametrize("signed", [False, True], ids=["plus", "signed"])
@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_fold_slots_journal_and_delta_match_jax(complex_, signed, tmp_path):
    js, ts = _states(complex_)
    mj, mt = _managers(tmp_path, 3)
    for i, k in enumerate((2, 1, 2)):
        signs = [1.0, -1.0][:k] if signed and k == 2 else None
        sj, st = _fold_both(mj, mt, js, ts, "a", k, 10 + i, complex_, signs)
        assert st == sj
    tj, tt = mj._tenants["a"], mt._tenants["a"]
    assert [ev.slots for ev in tt.journal.events] == \
        [ev.slots for ev in tj.journal.events] == [(0, 1), (2,), (0, 1)]
    for ej, et in zip(tj.journal.events, tt.journal.events):
        assert isinstance(et.rows, np.ndarray) and et.origin == "a"
        assert et.rows.shape == np.asarray(ej.rows).shape
        assert rel(et.rows, ej.rows) < TOL
    assert et.rows.shape[1] == N + (1 if signed else 0)
    assert (tt.journal.total_k, tt.applied) == (tj.journal.total_k,
                                                tj.applied) == (5, 3)
    _same_delta(tj.delta, tt.delta)
    assert tt.delta.cols.dtype == ts.L.dtype


@pytest.mark.parametrize("with_factors", [False, True],
                         ids=["deltas", "factors"])
def test_lru_evicts_the_same_tenants_in_the_same_order(with_factors,
                                                       tmp_path):
    js, ts = _states(seed=3)
    per = delta_nbytes(init_tenant_delta(N, 2, device="cpu"))
    # three deltas; or two and one cached n×n fp32 factor
    budget = (2 * per + 4 * N * N if with_factors else 3 * per) + per // 2
    mj, mt = _managers(tmp_path, 2, budget_bytes=budget)
    oj, ot = _spy_evictions(mj), _spy_evictions(mt)
    for seed, i in enumerate((0, 1, 2, 3, 4, 1, 0, 5, 2)):
        _fold_both(mj, mt, js, ts, f"t{i}", 1, seed)
        if with_factors:
            Lj, Lt = mj.factor(js, f"t{i}"), mt.factor(ts, f"t{i}")
            assert rel(Lt, Lj) < TOL
    assert ot == oj and len(ot) >= 3
    assert mt.resident_bytes() == mj.resident_bytes() <= mt.budget_bytes
    assert mt.stats.as_dict() == mj.stats.as_dict()
    assert mt.packing_stats() == mj.packing_stats()
    assert mt.packing_stats(top=2) == mj.packing_stats(top=2)
    assert sorted(mt.tenants()) == sorted(mj.tenants())
    # a fold of a spilled tenant does not wake it, its factor does
    assert mt._tenants["t2"].resident == mj._tenants["t2"].resident \
        == with_factors
    assert {tid: t.resident for tid, t in mt._tenants.items()} == \
        {tid: t.resident for tid, t in mj._tenants.items()}


@pytest.mark.parametrize("signed", [False, True], ids=["plus", "signed"])
def test_evict_then_activate_is_bit_for_bit(signed, tmp_path):
    _, ts = _states(seed=4)
    twin = TenantManager(3, spill_dir=tmp_path / "twin")   # never evicts
    mgr = TenantManager(3, spill_dir=tmp_path / "lru")
    signs = [1.0, -1.0] if signed else None
    for seed in (1, 2):
        for mm in (twin, mgr):
            mm.fold(ts, "a", _rows(2, seed)[1], signs=signs)
    path = mgr.evict("a")
    assert path == tmp_path / "lru" / "tenant_a.npz" and path.exists()
    assert not mgr._tenants["a"].resident
    assert mgr._tenants["a"].journal.base == 2      # compacted below applied
    assert mgr.evict("a") == path                  # already spilled
    for mm in (twin, mgr):                         # lands in the journal only
        mm.fold(ts, "a", _rows(1, 9)[1], signs=[-1.0] if signed else None)
    assert not mgr._tenants["a"].resident and mgr.resident_bytes() == 0
    L_twin = twin.factor(ts, "a")
    L_back = mgr.factor(ts, "a")                   # restore + tail replay
    assert mgr.stats.activations == 1 and mgr.stats.evictions == 1
    assert torch.equal(L_back, L_twin)
    d1, d2 = twin._tenants["a"].delta, mgr._tenants["a"].delta
    assert torch.equal(d1.cols, d2.cols) and torch.equal(d1.signs, d2.signs)
    assert (d1.cursor, d1.age) == (d2.cursor, d2.age) == (2, 3)
    assert mgr._tenants["a"].applied == twin._tenants["a"].applied == 3


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_factor_cache_hits_and_invalidation_match_jax(complex_, tmp_path):
    js, ts = _states(complex_, seed=5)
    mj, mt = _managers(tmp_path, 2)
    keys = []

    def both(**kw):
        Lj, Lt = mj.factor(js, "t", **kw), mt.factor(ts, "t", **kw)
        assert rel(Lt, Lj) < TOL
        assert mt.stats.as_dict() == mj.stats.as_dict()
        keys.append(mt._tenants["t"].factor_key)
        assert keys[-1] == mj._tenants["t"].factor_key
        return Lt

    _fold_both(mj, mt, js, ts, "t", 1, 1, complex_)
    L0 = both()
    assert both() is L0                            # a hit: the cached L_t
    _fold_both(mj, mt, js, ts, "t", 1, 3, complex_)  # a tenant fold
    both()
    both(lam=0.4)                                  # re-damped base
    both(lam=0.4)
    js = js._replace(stats=js.stats._replace(adapted=js.stats.adapted + 1))
    ts = ts._replace(stats=ts.stats._replace(adapted=ts.stats.adapted + 1))
    both(lam=0.4)                                  # a base fold
    assert mt.stats.as_dict() == {"activations": 0, "evictions": 0,
                                  "materializations": 4, "factor_hits": 2}
    assert mt._tenants["t"].served == 6
    assert keys[-1] == (1, 0, 0.4, 2)


def test_lambda_is_compared_with_the_rounded_lam0(tmp_path):
    """λ₀ = 0.01 is held rounded to fp32, so a request's λ = 0.01 differs
    from it: both packages re-damp, and the cache keys hold that λ."""
    js, ts = _states(lam0=0.01, seed=6)
    assert ts.lam0 == float(js.lam0) != 0.01
    mj, mt = _managers(tmp_path, 2)
    _fold_both(mj, mt, js, ts, "t", 2, 7)
    at_lam0 = mt.factor(ts, "t", lam=ts.lam0)
    mj.factor(js, "t", lam=float(js.lam0))
    assert mt._tenants["t"].factor_key[2] == ts.lam0
    Lj, Lt = mj.factor(js, "t", lam=0.01), mt.factor(ts, "t", lam=0.01)
    assert mt._tenants["t"].factor_key == mj._tenants["t"].factor_key
    assert mt._tenants["t"].factor_key[2] == 0.01
    assert mt.stats.materializations == 2 and rel(Lt, Lj) < TOL
    assert rel(Lt, at_lam0) < TOL        # the same matrix once rounded
    mj.factor(js, "t"), mt.factor(ts, "t")      # λ₀ again: a third build
    assert mt.stats.as_dict() == mj.stats.as_dict()
    assert mt.stats.materializations == 3


def test_registry_instruments_match_jax(tmp_path):
    js, ts = _states(seed=8)
    per = delta_nbytes(init_tenant_delta(N, 2, device="cpu"))
    rj, rt = JRegistry(), MetricsRegistry()
    mj = jten.TenantManager(2, budget_bytes=2 * per,
                            spill_dir=tmp_path / "jax", registry=rj)
    mt = TenantManager(2, budget_bytes=2 * per, spill_dir=tmp_path / "port",
                       registry=rt)
    for i, tid in enumerate(("a", "b", "a", "c", "b", "a")):
        _fold_both(mj, mt, js, ts, tid, 2 if i % 2 else 1, 30 + i,
                   signs=[1.0, -1.0] if i == 3 else None)
        mj.factor(js, tid), mt.factor(ts, tid)
    sj, st = rj.snapshot(), rt.snapshot()
    assert st["counters"] == sj["counters"]
    assert st["counters"]["tenants.evictions"] > 0
    assert sorted(st["gauges"]) == sorted(sj["gauges"])
    for name, value in st["gauges"].items():
        assert value == pytest.approx(sj["gauges"][name], rel=1e-4), name
    assert st["gauges"]["tenants.delta_core_condest"] > 1.0
    assert {k: h["count"] for k, h in st["histograms"].items()} == \
        {k: h["count"] for k, h in sj["histograms"].items()}


def test_exempt_tenant_alone_may_exceed_the_budget(tmp_path):
    js, ts = _states(seed=9)
    mj, mt = _managers(tmp_path, 4, budget_bytes=1)
    _fold_both(mj, mt, js, ts, "big", 3, 1)
    mj.factor(js, "big"), mt.factor(ts, "big")
    assert mt._tenants["big"].resident and mj._tenants["big"].resident
    assert mt.resident_bytes() == mj.resident_bytes() > mt.budget_bytes
    _fold_both(mj, mt, js, ts, "next", 1, 2)        # evicts "big"
    assert not mt._tenants["big"].resident
    assert mt.packing_stats() == mj.packing_stats()
    with pytest.raises(KeyError, match="unknown tenant"):
        mt.evict("nobody")
    with pytest.raises(ValueError, match="rank budget"):
        TenantManager(0)
    assert isinstance(mt.stats, TenantStats) and len(mt) == 2
    assert "big" in mt and "nobody" not in mt
    assert mt.delta(ts, "big").filled == 3          # activated on request
    assert mt.stats.activations == 1


def test_spill_dir_defaults_to_a_fresh_temporary_directory(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    mgr = TenantManager(2)
    assert mgr.spill_dir.parent == tmp_path
    assert mgr.spill_dir.name.startswith("tenant_spill_")
    assert mgr.spill_dir.is_dir()
    _, ts = _states(seed=10)
    mgr.fold(ts, "a", _rows(1, 1)[1])
    assert mgr.evict("a").parent == mgr.spill_dir


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_spill_files_load_across_packages(writer, dtype, tmp_path):
    vals = np.random.default_rng(11).normal(size=(6, 3)).astype(np.float32)
    meta = {"tenant": "t7", "applied": 5, "rank": 3}
    path = tmp_path / "t7.npz"
    if dtype == "bfloat16":
        host = vals.astype(ml_dtypes.bfloat16)
        tensor = torch.from_numpy(host.view(np.int16).copy()).view(
            torch.bfloat16)
    else:
        host, tensor = vals, torch.from_numpy(vals.copy())
    signs = np.array([1.0, -1.0, 0.0], np.float32)
    if writer == "jax":
        jfleet.save_tenant_spill(path, {"cols": host, "signs": signs,
                                        "cursor": np.int32(2)}, meta)
        arrays, got = load_tenant_spill(path)
    else:
        save_tenant_spill(path, {"cols": tensor, "signs":
                                 torch.from_numpy(signs),
                                 "cursor": np.asarray(2, np.int32)}, meta)
        arrays, got = jfleet.load_tenant_spill(path)
    assert got == meta and int(arrays["cursor"]) == 2
    assert np.array_equal(arrays["signs"], signs)
    cols = arrays["cols"]
    if dtype == "bfloat16":                # raw two-byte records on disk
        assert cols.dtype == np.dtype("V2")
        assert np.array_equal(cols.view(np.uint16), host.view(np.uint16))
    else:
        assert np.array_equal(cols, vals)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_a_spill_activates_in_the_other_package(direction, tmp_path):
    """One package's manager spills; the other's, holding the same
    journal, activates from that file: the delta is the writer's."""
    js, ts = _states(seed=12)
    mj, mt = _managers(tmp_path, 3)
    for seed in (1, 2):
        _fold_both(mj, mt, js, ts, "a", 2, seed)
    mj.evict("a"), mt.evict("a")
    _fold_both(mj, mt, js, ts, "a", 1, 3)           # the tail to replay
    writer, reader = (mj, mt) if direction == "jax_to_port" else (mt, mj)
    spilled = dict(np.load(writer._tenants["a"].spill_path))
    reader._tenants["a"].spill_path = writer._tenants["a"].spill_path
    Lj, Lt = mj.factor(js, "a"), mt.factor(ts, "a")
    assert rel(Lt, Lj) < TOL
    _same_delta(mj._tenants["a"].delta, mt._tenants["a"].delta)
    cols = reader._tenants["a"].delta.cols
    cols = np.asarray(cols if isinstance(cols, jnp.ndarray) else cols.numpy())
    # slots 0 and 2 come from the spill bit for bit, slot 1 from the replay
    assert np.array_equal(cols[:, [0, 2]], spilled["cols"][:, [0, 2]])
