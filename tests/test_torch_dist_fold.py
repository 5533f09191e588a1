"""The port's sharded window maintenance (``repro_torch.dist.cholupdate``,
``repro_torch.dist.state``) against the JAX package, on the CPU, every
mesh position on the CPU.

* the rank-k update and downdate with their columns sharded over 4
  positions, both methods (composed; the ring of rank-1 sweeps), at k = 3
  (zero-padded to the mesh) and 4, against the JAX ``chol_update`` and
  ``chol_downdate`` within 1e-6 (``tests/test_dist.py:40-70``);
* the sharded fold, through ``OnlineAdaptation(dist=)``, in the 1d, 2d
  and blocked layouts — and a 2d window padded in its sample axis, folding
  at the logical modulus through a wrap — against the JAX
  ``OnlineAdaptation`` folding the replicated window (the window exactly;
  W and L within 2e-6 of the JAX package's: both fp32 — the fold's own
  cancellation puts the two packages' factors ~1e-7 apart);
* the sharded refresh in every layout against the JAX factorization;
* the cross columns of an uneven window, and sharded checkpoints loaded
  across the two packages bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.operator import BlockedScores as JBlocked
from repro.curvature.update import chol_downdate as j_down
from repro.curvature.update import chol_update as j_up
from repro.serve import OnlineAdaptation as JAdapt
from repro.serve import init_serve_state as j_init
from repro.serve import restore_serve_state as j_restore
from repro.serve import save_serve_state as j_save
from repro_torch.core import BlockedScores
from repro_torch.dist import (DistSpec, init_sharded_serve_state,
                              make_sharded_fold, make_sharded_refresh,
                              restore_sharded_serve_state,
                              save_sharded_serve_state, sharded_chol_downdate,
                              sharded_chol_update, sharded_window_cols)
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve import OnlineAdaptation

torch.set_num_threads(1)

LAM = 0.1
WIDTHS = (32, 16, 48)
TOL = 2e-6


def _mesh(layout):
    if layout.startswith("2d"):
        return make_mesh((2, 2), ("data", "model"), device="cpu")
    return make_mesh((4,), ("model",), device="cpu")


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _split(a):
    offs = np.cumsum((0,) + WIDTHS)
    return tuple(np.ascontiguousarray(a[..., offs[i]:offs[i + 1]])
                 for i in range(len(WIDTHS)))


@pytest.mark.parametrize("method,k", [("composed", 3), ("composed", 4),
                                      ("rotations", 3), ("rotations", 4)])
def test_sharded_rank_k_vs_jax(method, k):
    rng = np.random.default_rng(0)
    n = 12
    S = (rng.normal(size=(n, 64)) / 8.0).astype(np.float32)
    L = np.linalg.cholesky(S @ S.T + 0.1 * np.eye(n)).astype(np.float32)
    X = (rng.normal(size=(n, k)) * 0.1).astype(np.float32)
    up_ref = np.asarray(j_up(jnp.asarray(L), jnp.asarray(X)))
    dn_ref = np.asarray(j_down(jnp.asarray(up_ref), jnp.asarray(X)))
    mesh = _mesh("1d")
    up = sharded_chol_update(torch.from_numpy(L), torch.from_numpy(X),
                             mesh=mesh, method=method)
    assert np.abs(_np(up) - up_ref).max() < 1e-6
    dn = sharded_chol_downdate(up, torch.from_numpy(X), mesh=mesh,
                               method=method)
    assert np.abs(_np(dn) - dn_ref).max() < 1e-6
    assert np.abs(_np(dn) - L).max() < 1e-5   # the update undone


def _fold_case(layout):
    rng = np.random.default_rng(1)
    n = 9 if layout == "2d_padded" else 12
    m = 96
    S = (rng.normal(size=(n, m)) / np.sqrt(m)).astype(np.float32)
    rows = [(rng.normal(size=(3, m)) / np.sqrt(m)).astype(np.float32)
            for _ in range(5)]              # 15 rows: the FIFO wraps
    return S, rows


@pytest.mark.parametrize("layout", ["1d", "2d", "blocked", "2d_padded"])
def test_sharded_fold_vs_jax_adaptation(layout):
    S, rows = _fold_case(layout)
    blocked = layout == "blocked"
    spec = DistSpec(_mesh(layout), "2d" if layout.startswith("2d")
                    else layout)
    St = torch.from_numpy(S)
    st = init_sharded_serve_state(
        BlockedScores.from_dense(St, WIDTHS) if blocked else St, LAM,
        spec=spec, device="cpu")
    ad = OnlineAdaptation(refresh_every=10 ** 6, drift_frac=None, dist=spec)
    ad.fifo_n = st.n_logical
    assert (st.n_logical is not None) == (layout == "2d_padded")
    Sj = jnp.asarray(S)
    jst = j_init(JBlocked.from_dense(Sj, WIDTHS) if blocked else Sj, LAM)
    jad = JAdapt(refresh_every=10 ** 6, drift_frac=None)
    state = st.state
    for r in rows:
        rt = tuple(torch.from_numpy(p) for p in _split(r)) if blocked \
            else torch.from_numpy(r)
        state = ad.fold(state, rt)
        jst = jad.fold(jst, tuple(jnp.asarray(p) for p in _split(r))
                       if blocked else jnp.asarray(r))
    n = S.shape[0]
    got = state.S.gather()
    for a, b in zip(got.blocks if blocked else (got,),
                    jst.S.blocks if blocked else (jst.S,)):
        assert np.array_equal(_np(a)[:n], np.asarray(b))
        assert not _np(a)[n:].any()                 # pad rows stay zero
    assert np.abs(_np(state.W)[:n, :n] - np.asarray(jst.W)).max() < TOL
    assert np.abs(_np(state.L)[:n, :n] - np.asarray(jst.L)).max() < TOL
    assert state.slot == int(jst.slot)
    assert state.stats.adapted == int(jst.stats.adapted)


@pytest.mark.parametrize("layout", ["1d", "2d", "blocked"])
def test_sharded_refresh_vs_jax(layout):
    S, rows = _fold_case(layout)
    St = torch.from_numpy(S)
    src = BlockedScores.from_dense(St, WIDTHS) if layout == "blocked" else St
    W, L = make_sharded_refresh(_mesh(layout), layout=layout)(src, LAM)
    jst = j_init(jnp.asarray(S), LAM)
    assert np.abs(_np(W) - np.asarray(jst.W)).max() < TOL
    assert np.abs(_np(L) - np.asarray(jst.L)).max() < TOL
    # the fold callable on a whole window gives a whole window back
    fold = make_sharded_fold(_mesh(layout), layout=layout)
    r = torch.from_numpy(rows[0])
    out = fold(src, W, L, 10, tuple(torch.from_numpy(p)
                                    for p in _split(rows[0]))
               if layout == "blocked" else r)
    assert type(out[0]) is type(src) and out[3] == 1


@pytest.mark.parametrize("layout", ["1d", "2d"])
def test_window_cols_uneven(layout):
    rng = np.random.default_rng(11)
    S = (rng.normal(size=(9, 151)) / np.sqrt(151)).astype(np.float32)
    r = (rng.normal(size=(3, 151)) / np.sqrt(151)).astype(np.float32)
    cols, corner = sharded_window_cols(torch.from_numpy(S),
                                       torch.from_numpy(r),
                                       mesh=_mesh(layout), layout=layout)
    assert cols.shape == (9, 3)
    assert np.abs(_np(cols) - np.asarray(jnp.asarray(S) @ r.T)).max() < 1e-6
    assert np.abs(_np(corner) - r @ r.T).max() < 1e-6


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_sharded_checkpoint_across_packages(direction, tmp_path):
    """The leaves are the reference's (the gathered, padded window, W, L,
    the scalars): a sharded checkpoint of either package restores in the
    other bit for bit."""
    rng = np.random.default_rng(5)
    S = (rng.normal(size=(8, 62)) / 8.0).astype(np.float32)
    spec = DistSpec(_mesh("1d"), "1d")
    st = init_sharded_serve_state(torch.from_numpy(S), 0.2, spec=spec,
                                  device="cpu")
    assert st.padded and st.widths == (62,)
    ad = OnlineAdaptation(refresh_every=10 ** 6, drift_frac=None, dist=spec)
    st = st._replace(**ad.fold(st.state, torch.from_numpy(
        (rng.normal(size=(2, 62)) / 8.0).astype(np.float32)))._asdict())
    padded = np.pad(S, ((0, 0), (0, 2)))
    jlike = j_init(jnp.asarray(padded), 0.2)
    if direction == "port_to_jax":
        save_sharded_serve_state(tmp_path, 3, st)
        back, meta = j_restore(tmp_path, 3, jlike)
        assert meta["layout"] == "1d" and meta["kind"] == "serve_state"
        assert np.array_equal(np.asarray(back.S), _np(st.S.gather()))
        assert np.array_equal(np.asarray(back.L), _np(st.L))
        assert int(back.stats.adapted) == 2 and int(back.slot) == 2
        return
    jst = JAdapt(refresh_every=10 ** 6, drift_frac=None).fold(
        jlike, jnp.asarray((rng.normal(size=(3, 64)) / 8.0)
                           .astype(np.float32)))
    j_save(tmp_path, 4, jst, metadata={"layout": "1d"})
    other = DistSpec(_mesh("2d"), "1d")          # elastic: another mesh
    back, meta = restore_sharded_serve_state(tmp_path, 4, st, spec=other)
    assert back.spec is other and meta["layout"] == "1d"
    assert np.array_equal(_np(back.S.gather()), np.asarray(jst.S))
    assert np.array_equal(_np(back.W), np.asarray(jst.W))
    assert (back.slot, back.stats.adapted) == (3, 3)
