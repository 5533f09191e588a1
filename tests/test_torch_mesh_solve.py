"""The port's mesh, ``DistSpec``/padding and sharded Algorithm 1
(``repro_torch.launch.mesh``, ``repro_torch.dist.state``,
``repro_torch.core.distributed``) against the JAX package, on the CPU.

Every mesh position lies on the CPU (``make_mesh(..., device="cpu")``):
one process drives them all, as the port does on a card. The port's
sharded solver over 4 positions (1d, 2d, blocked, an m that does not
divide the mesh, k right-hand sides) is held to the JAX package's
replicated ``chol_solve``, and at 1 position to the JAX package's own
sharded solvers on a 1-device mesh, in process. The JAX 4-device runs
need a forced device count and so a subprocess; the reference's own
``tests/test_distributed.py`` ties its sharded forms to ``chol_solve``.

Tolerance: rtol 1e-4, atol 1e-5 — ``tests/test_distributed.py``'s for a
sharded solve against the local one."""
import jax
import numpy as np
import pytest
import torch

from repro.core.operator import BlockedScores as JBlocked
from repro.core.distributed import (sharded_blocked_chol_solve as j_blk,
                                    sharded_chol_solve as j_1d,
                                    sharded_chol_solve_2d as j_2d)
from repro.core.solvers import chol_solve as j_chol_solve
from repro.launch.mesh import make_mesh as j_make_mesh
from repro_torch.core import BlockedScores
from repro_torch.core.distributed import (make_sharded_solver,
                                          sharded_blocked_chol_solve,
                                          sharded_chol_solve,
                                          sharded_chol_solve_2d)
from repro_torch.dist import DistSpec, pad_window_to_mesh, shard_window
from repro_torch.launch.mesh import (Mesh, all_gather, dp_axes, make_mesh,
                                     ppermute, psum)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
LAM = 0.05
WIDTHS = (64, 32, 32)


def _data(n=16, m=128, seed=1, k=None):
    rng = np.random.default_rng(seed)
    S = rng.normal(size=(n, m)).astype(np.float32)
    v = rng.normal(size=(m,) if k is None else (m, k)).astype(np.float32)
    return S, v


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------

def test_make_mesh_on_the_cpu():
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    assert isinstance(mesh, Mesh)
    assert mesh.shape == {"data": 2, "model": 4} and mesh.size == 8
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices[1][3] == torch.device("cpu")
    assert dp_axes(mesh) == ("data",)
    assert mesh.axis_devices(("model",), data=1) == [torch.device("cpu")] * 4
    three = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    assert dp_axes(three) == ("pod", "data")
    named = make_mesh((2,), ("model",), devices=["cpu", "meta"])
    assert named.device(model=1) == torch.device("meta")
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data",), device="cpu")
    with pytest.raises(ValueError):
        make_mesh((2,), ("model",), devices=["cpu"])
    with pytest.raises(IndexError):
        mesh.device(model=4)


def test_make_mesh_raises_without_enough_cards():
    """As ``jax.make_mesh`` raises with too few devices, the default
    placement (a card a position) raises with too few cards."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_mesh((have + 1,), ("model",))


def test_collectives_fixed_order():
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
             for _ in range(4)]
    total = psum(parts)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert torch.equal(total, want)                   # position order
    assert torch.equal(psum(parts), total)            # bit-identical repeat
    assert not any(p is total for p in parts)         # a fresh tensor
    assert torch.equal(all_gather(parts, dim=0), torch.cat(parts))
    rolled = ppermute(parts)
    assert [id(p) for p in rolled] == [id(p) for p in parts[-1:] + parts[:-1]]


# ---------------------------------------------------------------------------
# DistSpec and the pad to the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["layout", "2d_no_data", "no_model"])
def test_distspec_errors(case):
    mesh1 = make_mesh((4,), ("model",), device="cpu")
    with pytest.raises(ValueError):
        if case == "layout":
            DistSpec(mesh1, "3d")
        elif case == "2d_no_data":
            DistSpec(mesh1, "2d")
        else:
            DistSpec(make_mesh((4,), ("data",), device="cpu"), "1d")


@pytest.mark.parametrize("layout", ["1d", "2d", "blocked"])
def test_pad_window_to_mesh(layout):
    """Zero columns up to the model axis (per block), zero rows up to the
    data axis in 2d; the logical widths come back; the pieces lay evenly
    and gather back to the padded window bit for bit."""
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    spec = DistSpec(mesh, layout)
    rng = np.random.default_rng(3)
    S = torch.from_numpy(rng.normal(size=(9, 151)).astype(np.float32))
    widths = (33, 71, 47)
    src = BlockedScores.from_dense(S, widths) if layout == "blocked" else S
    P, got = pad_window_to_mesh(src, spec)
    if layout == "blocked":
        assert got == widths
        assert tuple(b.shape for b in P.blocks) == ((9, 36), (9, 72),
                                                    (9, 48))
        for b, o, w in zip(P.blocks, src.blocks, widths):
            assert torch.equal(b[:, :w], o) and not b[:, w:].any()
    else:
        assert got == (151,)
        n_pad = 10 if layout == "2d" else 9
        assert P.shape == (n_pad, 152)
        assert torch.equal(P[:9, :151], S) and not P[9:].any() \
            and not P[:, 151:].any()
    window = shard_window(P, spec)
    assert window.shape == P.shape
    assert len(window.pieces[0]) == (2 if layout == "2d" else 1)
    assert all(len(row) == 4 for blk in window.pieces for row in blk)
    back = window.gather()
    for a, b in zip(back.blocks if layout == "blocked" else (back,),
                    P.blocks if layout == "blocked" else (P,)):
        assert torch.equal(a, b)
    # an even window is returned as it is
    same, _ = pad_window_to_mesh(P, spec)
    assert same is P


# ---------------------------------------------------------------------------
# sharded Algorithm 1: 4 CPU positions against the JAX replicated solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["1d", "2d", "blocked", "uneven_m",
                                  "multi_rhs", "solver_blocked"])
def test_sharded_solve_four_positions_vs_jax(case):
    m = 131 if case == "uneven_m" else 128
    S, v = _data(m=m, k=3 if case == "multi_rhs" else None)
    ref = np.asarray(jax.jit(j_chol_solve)(S, v, LAM))
    mesh1 = make_mesh((4,), ("model",), device="cpu")
    mesh2 = make_mesh((2, 2), ("data", "model"), device="cpu")
    St, vt = torch.from_numpy(S), torch.from_numpy(v)
    if case in ("1d", "uneven_m", "multi_rhs"):
        x = sharded_chol_solve(St, vt, LAM, mesh=mesh1)
    elif case == "2d":
        x = sharded_chol_solve_2d(St, vt, LAM, mesh=mesh2)
    else:
        op = BlockedScores.from_dense(St, WIDTHS)
        solve = sharded_blocked_chol_solve if case == "blocked" \
            else make_sharded_solver(mesh1, layout="blocked")
        kw = {"mesh": mesh1} if case == "blocked" else {}
        xb = solve(op, op.split(vt), LAM, **kw)
        assert [b.shape[0] for b in xb] == list(WIDTHS)
        x = torch.cat(xb)
    assert x.shape == ref.shape and x.dtype == torch.float32
    _close(x, ref)


@pytest.mark.parametrize("layout", ["1d", "2d", "blocked"])
def test_one_position_vs_jax_sharded(layout):
    """At 1 position the port's sharded solvers match the JAX package's on
    a 1-device mesh (the same functions, ``shard_map`` over one device)."""
    S, v = _data(seed=4)
    if layout == "2d":
        jmesh = j_make_mesh((1, 1), ("data", "model"))
        ref = j_2d(S, v, LAM, mesh=jmesh)
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        x = make_sharded_solver(mesh, layout="2d")(
            torch.from_numpy(S), torch.from_numpy(v), LAM)
    elif layout == "blocked":
        jmesh = j_make_mesh((1,), ("model",))
        jop = JBlocked.from_dense(S, WIDTHS)
        ref = np.concatenate([np.asarray(b) for b in j_blk(
            jop, jop.split(v), LAM, mesh=jmesh)])
        mesh = make_mesh((1,), ("model",), device="cpu")
        op = BlockedScores.from_dense(torch.from_numpy(S), WIDTHS)
        x = torch.cat(make_sharded_solver(mesh, layout="blocked")(
            op, op.split(torch.from_numpy(v)), LAM))
    else:
        jmesh = j_make_mesh((1,), ("model",))
        ref = j_1d(S, v, LAM, mesh=jmesh)
        mesh = make_mesh((1,), ("model",), device="cpu")
        x = make_sharded_solver(mesh)(torch.from_numpy(S),
                                      torch.from_numpy(v), LAM)
    _close(x, ref)


def test_solver_rejects_wrong_inputs():
    mesh = make_mesh((2,), ("model",), device="cpu")
    S, v = _data()
    with pytest.raises(ValueError, match="unknown layout"):
        make_sharded_solver(mesh, layout="3d")
    with pytest.raises(TypeError, match="BlockedScores"):
        sharded_blocked_chol_solve(torch.from_numpy(S),
                                   (torch.from_numpy(v),), LAM, mesh=mesh)
    with pytest.raises(TypeError, match="real-only"):
        sharded_chol_solve(torch.from_numpy(S).to(torch.complex64),
                           torch.from_numpy(v).to(torch.complex64), LAM,
                           mesh=mesh)
