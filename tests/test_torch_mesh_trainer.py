"""The port's sharded trainer around the NGD step — the AdamW step over a
mesh, ``build_trainer(mesh=)``, ``train_main --mesh-shape``, the
streaming curvature policy over a mesh, ``place``, ``prefetch``,
``sharded_chol_solve_slabs``/``ShardedScores`` and a solver that is not
Algorithm 1 — against the JAX package, on the CPU, every position on the
CPU. Tolerances: ``tests/test_torch_trainer.py``'s (``_torch_mesh``).
The NGD step in each layout: ``test_torch_mesh_train.py``.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_mesh import (ARCH, ATOL, BATCH, LAM, LOSS_TOL, LR, PARAM_ATOL,
                         PARAM_RTOL, RTOL, SEED, SEQ, STEPS, check,
                         jax_smoke_params)
from repro import configs as jconfigs
from repro.curvature import StreamingCurvature as JStreamingCurvature
from repro.data import place as jplace
from repro.data import prefetch as jprefetch
from repro.launch import train as jtrain
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.launch.shardings import input_shardings
from repro.models.api import get_api as jget_api
from repro.optim import AdamW as JAdamW
from repro.optim import NaturalGradient as JNaturalGradient
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch import configs as tconfigs
from repro_torch.core import BlockedScores, chol_solve
from repro_torch.core.distributed import (ShardedScores, sharded_chol_solve,
                                          sharded_chol_solve_slabs)
from repro_torch.core.pytree import (leaves, params_from_arrays,
                                     params_to_arrays)
from repro_torch.curvature import StreamingCurvature
from repro_torch.data import SyntheticLM, place, prefetch
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.trainer import build_trainer, train_main
from repro_torch.models.api import get_api
from repro_torch.optim import AdamW, NaturalGradient, warmup_cosine

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_params():
    return jax_smoke_params()


def test_adamw_step_over_mesh_matches_jax():
    """``tests/test_distributed.py``'s AdamW step on a (2, 4) mesh, held to
    the single-device step: one step of llama3-8b's SMOKE config."""
    jcfg, tcfg = jconfigs.get_smoke("llama3-8b"), tconfigs.get_smoke(
        "llama3-8b")
    batch = SyntheticLM(tcfg, batch=8, seq=16, seed=4).batch_at(0)
    jp = jget_api(jcfg).init_params(jax.random.key(0))
    jopt = JAdamW(1e-2, weight_decay=0.0)
    jp2, _, jm = jax.jit(jtrain.make_train_step(jget_api(jcfg), jopt))(
        jp, jopt.init(jp), batch)
    opt = AdamW(1e-2, weight_decay=0.0)
    tp = params_from_arrays(jax.device_get(jp), device="cpu")
    step = ttrain.make_train_step(
        get_api(tcfg), opt, mesh=make_mesh((2, 4), ("data", "model"),
                                           device="cpu"))
    tp2, st, tm = step(tp, opt.init(tp), batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_TOL)
    assert st.step == 1
    for a, b in zip(jax.tree.leaves(params_to_arrays(tp2)),
                    jax.tree.leaves(jax.device_get(jp2))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL)


def test_build_trainer_over_mesh_descends():
    """``tests/test_distributed.py``'s sharded NGD trainer on the port:
    12 steps on a (2, 4) mesh, the losses finite and descending."""
    init_state, step_fn, *_ = build_trainer(
        tconfigs.get_smoke(ARCH),
        mesh=make_mesh((2, 4), ("data", "model"), device="cpu"),
        optimizer_name="ngd", lr=0.2, damping=1e-3, batch=8, seq=16,
        total_steps=12)
    state, losses = init_state(), []
    for s in range(12):
        state, m = step_fn(state, s)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)), losses
    assert min(losses[3:]) < losses[0], losses


@pytest.mark.parametrize("optimizer", ["ngd", "adamw"])
def test_train_main_mesh_shape(optimizer, tmp_path):
    """``train_main --mesh-shape 2,2 --device cpu`` trains as the one-device
    CLI does (its default ``--mesh-shape 1,1``): the same losses within
    LOSS_TOL, every step completed."""
    argv = ["--arch", ARCH, "--smoke", "--optimizer", optimizer, "--steps",
            "3", "--batch", "4", "--seq", "16", "--device", "cpu"]
    got, report = train_main(argv + ["--mesh-shape", "2,2", "--ckpt-dir",
                                     str(tmp_path / "mesh")])
    want, _ = train_main(argv + ["--ckpt-dir", str(tmp_path / "one")])
    assert report["completed"] and len(got) == 3
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)


def _batch():
    return SyntheticLM(tconfigs.get_smoke(ARCH), batch=BATCH, seq=SEQ,
                       seed=SEED).batch_at(0)


def test_place_matches_jax():
    """On a (1, 1) mesh the reference's ``place`` with its input shardings
    and the port's give the same arrays; on larger meshes every position
    holds its DP index's rows (``np.split`` over the DP axes, as a
    ``P(("pod", "data"))`` sharding lays them), positions sharing a DP
    index share the tensors, and a batch of 1 and a 0-d leaf are
    replicated."""
    batch = _batch()
    jmesh = jmake_mesh((1, 1), ("data", "model"))
    want = jplace(batch, input_shardings(batch, jmesh))
    got = place(batch, make_mesh((1, 1), ("data", "model"), device="cpu"))
    assert len(got) == 1
    for k in batch:
        np.testing.assert_array_equal(got[0][k].numpy(), np.asarray(want[k]))
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), device="cpu")
    got = place(batch, mesh)
    assert len(got) == 4
    for k, x in batch.items():
        rows = np.split(x, 2)
        for p, c in enumerate(mesh.coords()):
            np.testing.assert_array_equal(got[p][k].numpy(), rows[c["pod"]])
    assert got[0]["inputs"] is got[1]["inputs"]
    one = place({"x": np.ones((1, 3)), "s": np.float32(2.0)},
                make_mesh((2, 2), ("data", "model"), device="cpu"))
    assert all(b["x"].shape == (1, 3) and b["s"].ndim == 0 for b in one)
    with pytest.raises(ValueError, match="does not split"):
        place({"x": np.ones((3, 2))}, mesh)


def test_prefetch_matches_jax():
    """The same batches in the same order, a mesh's placement applied."""
    data = SyntheticLM(tconfigs.get_smoke(ARCH), batch=BATCH, seq=SEQ,
                       seed=SEED)
    items = [data.batch_at(s) for s in range(5)]
    for depth in (1, 2):
        want = list(jprefetch(iter(items), None, depth=depth))
        got = list(prefetch(iter(items), None, depth=depth))
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            assert all(np.array_equal(a[k], b[k]) for k in a)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    placed = list(prefetch(iter(items), mesh))
    assert len(placed) == 5
    for item, pieces in zip(items, placed):
        assert len(pieces) == 4
        np.testing.assert_array_equal(
            np.concatenate([pieces[0]["labels"].numpy(),
                            pieces[2]["labels"].numpy()]), item["labels"])


def test_sharded_solve_slabs_matches_chol_solve():
    """The public per-slab entry: the slabs of ``sharded_chol_solve``'s
    split give its x bit for bit, and blocked slabs give the replicated
    ``chol_solve``'s; a ``ShardedScores`` gathers to S itself."""
    rng = np.random.default_rng(3)
    S = torch.from_numpy(rng.normal(size=(16, 130)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(130,)).astype(np.float32))
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    x = torch.cat(sharded_chol_solve_slabs(
        list(torch.tensor_split(S, 4, dim=1)),
        list(torch.tensor_split(v, 4)), 0.05))
    assert torch.equal(x, sharded_chol_solve(S, v, 0.05, mesh=mesh))
    widths = (70, 60)
    blocks = torch.split(S, widths, dim=1)
    sharded = ShardedScores(
        [[torch.tensor_split(b, 2, dim=1)[p] for b in blocks]
         for p in range(2)], blocked=True)
    assert sharded.block_widths == widths and sharded.shape == (16, 130)
    assert torch.equal(sharded.gather().to_dense(), S)
    xb = chol_solve(sharded, tuple(torch.split(v, widths)), 0.05)
    np.testing.assert_allclose(torch.cat(xb).numpy(),
                               chol_solve(S, v, 0.05).numpy(), rtol=RTOL,
                               atol=ATOL)
    assert isinstance(BlockedScores(blocks).to_dense(), torch.Tensor)


def test_other_solvers_run_on_the_gathered_scores(jax_params):
    """A solver that is not Algorithm 1 (here "eigh") gets S gathered:
    the (2, 2) step equals the one-device step with that solver."""
    data = SyntheticLM(tconfigs.get_smoke(ARCH), batch=BATCH, seq=SEQ,
                       seed=SEED)
    api = get_api(tconfigs.get_smoke(ARCH))
    out = []
    for mesh in (make_mesh((2, 2), ("data", "model"), device="cpu"), None):
        opt = NaturalGradient(LR, damping=LAM, solver="eigh")
        p = params_from_arrays(jax_params, device="cpu")
        p, st, m = ttrain.make_ngd_train_step(api, opt, mesh)(
            p, opt.init(p), data.batch_at(0))
        out.append((float(m["loss"]), leaves(p)))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=LOSS_TOL)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL)


STREAM_CASES = {   # test_torch_trainer.py's streaming cases, and blocked
    "streaming": (0.1, 0.05, {"refresh_every": 3, "drift_tol": None},
                  False),
    "streaming_drift": (1e-3, 0.1, {"refresh_every": 3, "drift_tol": 0.5},
                        False),
    "streaming_blocked": (0.1, 0.05, {"refresh_every": 2, "drift_tol": 0.5},
                          True),
}


def test_streaming_over_mesh_matches_jax(jax_params):
    """The streaming curvature policy over a (2, 2) mesh (a refresh: one
    ``gram_sv`` a slab; a hit: one ``sv_cross`` a slab against the cached
    W) against the reference's policy on its one device, with and
    without the drift guard, dense and blocked: the same losses, params,
    hits and refreshes."""
    for damping, lr, stream, blocked in STREAM_CASES.values():
        kw = {"warmup_steps": max(STEPS // 20, 1), "total_steps": STEPS}
        jopt = JNaturalGradient(jwarmup_cosine(lr, **kw), damping=damping,
                                curvature=JStreamingCurvature(BATCH,
                                                              **stream))
        jstep = jax.jit(jtrain.make_ngd_train_step(
            jget_api(jconfigs.get_smoke(ARCH)), jopt,
            jmake_mesh((1, 1), ("data", "model")), blocked=blocked))
        opt = NaturalGradient(warmup_cosine(lr, **kw), damping=damping,
                              curvature=StreamingCurvature(
                                  BATCH, device="cpu", **stream))
        step = ttrain.make_ngd_train_step(
            get_api(tconfigs.get_smoke(ARCH)), opt,
            make_mesh((2, 2), ("data", "model"), device="cpu"),
            blocked=blocked)
        jp = jax.tree.map(jax.numpy.asarray, jax_params)
        tp = params_from_arrays(jax_params, device="cpu")
        jst, tst, jl, tl = jopt.init(jp), opt.init(tp), [], []
        data = SyntheticLM(tconfigs.get_smoke(ARCH), batch=BATCH, seq=SEQ,
                           seed=SEED)
        for s in range(STEPS):
            jp, jst, jm = jstep(jp, jst, data.batch_at(s))
            tp, tst, tm = step(tp, tst, data.batch_at(s))
            jl.append(float(jm["loss"]))
            tl.append(float(tm["loss"]))
        check((tl, jax.tree.leaves(params_to_arrays(tp))),
               (jl, [np.asarray(x) for x in jax.tree.leaves(
                   jax.device_get(jp))]))
        assert (tm["curvature_hits"], tm["curvature_refreshes"]) == (
            int(jm["curvature_hits"]), int(jm["curvature_refreshes"]))
        assert tm["curvature_hits"] + tm["curvature_refreshes"] == STEPS
        assert tm["curvature_refreshes"] >= 1
