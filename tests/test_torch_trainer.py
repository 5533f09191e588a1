"""The NGD trainer of the torch port against the JAX package: the train
steps (``make_ngd_train_step`` exact dense, exact blocked, streaming with
and without the drift guard; ``make_train_step`` with AdamW over 1 and 2
microbatches), ``build_trainer`` end to end, and the reference's four
trainer behaviours (``tests/test_examples.py``) on the port.

fp32 SMOKE llama3.2-3b, the JAX params carried across as numpy arrays,
the same ``SyntheticLM`` batches (bit for bit). Tolerances:

* losses, 1e-4 relative (``LOSS_TOL``): fp32 sums in another order through
  the two-layer trunk, as the model tests hold the forward;
* params after 3 steps, ``rtol = atol = 5e-3`` (``PARAM_RTOL``,
  ``PARAM_ATOL``): the reference's own solver tests' tolerance
  (``tests/test_solvers.py::test_solver_matches_direct``) — every NGD
  update goes through the dual solve x = (v − Sᵀw)/λ, which cancels
  about two digits of v at λ = 1e-2 and four at λ = 1e-3 in fp32 on
  either package. The exact cases run at λ = 1e-2, where the two
  packages' params stay ≈ 5e-6 apart after 3 steps; the drift-guard case
  keeps the reference's λ = 1e-3, which its refresh-every-step needs.
"""
import numpy as np
import pytest
import torch

import jax
from repro import configs as jconfigs
from repro.curvature import StreamingCurvature as JStreamingCurvature
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import train as jtrain
from repro.launch.mesh import make_mesh
from repro.launch.trainer import build_trainer as jbuild_trainer
from repro.models.api import get_api as jget_api
from repro.optim import AdamW as JAdamW
from repro.optim import NaturalGradient as JNaturalGradient
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch import configs as tconfigs
from repro_torch.core.pytree import params_from_arrays, params_to_arrays
from repro_torch.curvature import StreamingCurvature
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_mesh as make_torch_mesh
from repro_torch.launch.trainer import build_trainer, train_main
from repro_torch.models.api import get_api
from repro_torch.optim import AdamW, NaturalGradient, warmup_cosine

torch.set_num_threads(1)

LOSS_TOL = 1e-4
PARAM_RTOL = PARAM_ATOL = 5e-3
ARCH, BATCH, SEQ, STEPS, SEED = "llama3.2-3b", 4, 16, 3, 0

# name → (damping, lr, blocked, streaming policy kwargs or None); the
# streaming settings are the reference's trainer tests'
NGD_CASES = {
    "exact_dense": (1e-2, 0.1, False, None),
    "exact_blocked": (1e-2, 0.1, True, None),
    "streaming": (0.1, 0.05, False, {"refresh_every": 3, "drift_tol": None}),
    "streaming_drift": (1e-3, 0.1, False,
                        {"refresh_every": 3, "drift_tol": 0.5}),
}


@pytest.fixture(scope="module")
def jax_params():
    """The JAX smoke model's params drawn from ``SEED``, on the host —
    what the reference's ``build_trainer`` starts from."""
    api = jget_api(jconfigs.get_smoke(ARCH))
    return jax.device_get(api.init_params(jax.random.key(SEED)))


def _sched(lr):
    kw = {"warmup_steps": max(STEPS // 20, 1), "total_steps": STEPS}
    return jwarmup_cosine(lr, **kw), warmup_cosine(lr, **kw)


def _run(jstep, jstate, tstep, tstate, jp, tp):
    """STEPS steps of both; returns the losses, last metrics and params."""
    jdata = JSyntheticLM(jconfigs.get_smoke(ARCH), batch=BATCH, seq=SEQ,
                         seed=SEED)
    tdata = SyntheticLM(tconfigs.get_smoke(ARCH), batch=BATCH, seq=SEQ,
                        seed=SEED)
    jl, tl = [], []
    for s in range(STEPS):
        jp, jstate, jm = jstep(jp, jstate, jdata.batch_at(s))
        tp, tstate, tm = tstep(tp, tstate, tdata.batch_at(s))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return (jl, jm, jp, jstate), (tl, tm, tp, tstate)


def _check(j, t):
    (jl, _, jp, _), (tl, _, tp, _) = j, t
    np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL)
    got = jax.tree.leaves(params_to_arrays(tp))
    want = jax.tree.leaves(jax.device_get(jp))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL)


@pytest.mark.parametrize("case", sorted(NGD_CASES))
def test_ngd_train_steps_match_jax(case, jax_params):
    damping, lr, blocked, stream = NGD_CASES[case]
    jsched, tsched = _sched(lr)
    jpolicy = None if stream is None else JStreamingCurvature(BATCH, **stream)
    tpolicy = None if stream is None \
        else StreamingCurvature(BATCH, device="cpu", **stream)
    jopt = JNaturalGradient(jsched, damping=damping, curvature=jpolicy)
    topt = NaturalGradient(tsched, damping=damping, curvature=tpolicy)
    jstep = jax.jit(jtrain.make_ngd_train_step(
        jget_api(jconfigs.get_smoke(ARCH)), jopt,
        make_mesh((1, 1), ("data", "model")), blocked=blocked))
    tstep = ttrain.make_ngd_train_step(get_api(tconfigs.get_smoke(ARCH)),
                                       topt, blocked=blocked)
    jp = jax.tree.map(jax.numpy.asarray, jax_params)
    tp = params_from_arrays(jax_params, device="cpu")
    j, t = _run(jstep, jopt.init(jp), tstep, topt.init(tp), jp, tp)
    _check(j, t)
    jm, tm = j[1], t[1]
    if stream is None:
        assert t[3].curvature is None and "curvature_hits" not in tm
    else:
        assert (tm["curvature_hits"], tm["curvature_refreshes"]) == (
            int(jm["curvature_hits"]), int(jm["curvature_refreshes"]))
        assert tm["curvature_refreshes"] == (1 if stream["drift_tol"] is None
                                             else STEPS)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_adamw_train_step_matches_jax(microbatches, jax_params):
    jsched, tsched = _sched(3e-3)
    jopt, topt = JAdamW(jsched), AdamW(tsched)
    jstep = jax.jit(jtrain.make_train_step(
        jget_api(jconfigs.get_smoke(ARCH)), jopt, microbatches=microbatches))
    tstep = ttrain.make_train_step(get_api(tconfigs.get_smoke(ARCH)), topt,
                                   microbatches=microbatches)
    jp = jax.tree.map(jax.numpy.asarray, jax_params)
    tp = params_from_arrays(jax_params, device="cpu")
    _check(*_run(jstep, jopt.init(jp), tstep, topt.init(tp), jp, tp))


@pytest.mark.parametrize("optimizer", ["ngd", "adamw"])
def test_build_trainer_matches_jax(optimizer, jax_params):
    """The whole trainer — data, schedule, optimizer, train step — from
    the weights the reference's ``build_trainer`` draws from its seed."""
    kw = dict(optimizer_name=optimizer, lr=0.05 if optimizer == "ngd"
              else 3e-3, damping=1e-3, batch=BATCH, seq=SEQ,
              total_steps=STEPS, seed=SEED)
    jinit, jstep, *_ = jbuild_trainer(
        jconfigs.get_smoke(ARCH), mesh=make_mesh((1, 1), ("data", "model")),
        **kw)
    tinit, tstep, *_ = build_trainer(tconfigs.get_smoke(ARCH),
                                     params=jax_params, device="cpu", **kw)
    js, ts = jinit(), tinit()
    for s in range(STEPS):
        js, jm = jstep(js, s)
        ts, tm = tstep(ts, s)
        assert abs(float(tm["loss"]) - float(jm["loss"])) \
            <= LOSS_TOL * abs(float(jm["loss"]))
    for a, b in zip(jax.tree.leaves(params_to_arrays(ts["params"])),
                    jax.tree.leaves(jax.device_get(js["params"]))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL)


def test_trainer_refusals(tmp_path):
    """What one device once refused naming the sharded tier (ROADMAP A7)
    is accepted: a mesh, ``score_sharding="2d"`` and ``flat_scores`` each
    make a step that trains, and ``train_main --mesh-shape 1,2`` runs; an
    unknown curvature mode raises the reference's ValueError."""
    cfg = tconfigs.get_smoke(ARCH)
    api = get_api(cfg)
    batch = SyntheticLM(cfg, batch=BATCH, seq=SEQ).batch_at(0)
    for kw in ({"mesh": make_torch_mesh((1, 2), ("data", "model"),
                                        device="cpu")},
               {"score_sharding": "2d"}, {"flat_scores": True}):
        opt = NaturalGradient(0.1)
        params = api.init_params(torch.Generator().manual_seed(SEED), "cpu")
        _, state, metrics = ttrain.make_ngd_train_step(api, opt, **kw)(
            params, opt.init(params), batch)
        assert state.step == 1 and np.isfinite(float(metrics["loss"]))
    losses, report = train_main(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh-shape", "1,2",
         "--steps", "2", "--batch", "4", "--seq", "16",
         "--ckpt-dir", str(tmp_path)])
    assert report["completed"] and len(losses) == 2
    with pytest.raises(ValueError, match="unknown curvature mode"):
        build_trainer(tconfigs.get_smoke(ARCH), optimizer_name="ngd", lr=0.1,
                      damping=1e-3, batch=4, seq=16, total_steps=2,
                      curvature="cached", device="cpu")


# ---------------------------------------------------------------------------
# the reference's trainer tests (tests/test_examples.py), on the port
# ---------------------------------------------------------------------------

def test_trainer_curvature_default_is_noop_for_existing_callers():
    """``build_trainer`` without a curvature argument and with the explicit
    default must produce bit-identical NGD training trajectories."""
    cfg = tconfigs.get_smoke(ARCH)
    losses = {}
    for tag, kw in [("implicit", {}), ("exact", {"curvature": "exact"})]:
        init_state, step_fn, *_ = build_trainer(
            cfg, optimizer_name="ngd", lr=0.1, damping=1e-3, batch=4,
            seq=16, total_steps=3, device="cpu", **kw)
        state = init_state()
        ls = []
        for s in range(3):
            state, m = step_fn(state, s)
            ls.append(float(m["loss"]))
        losses[tag] = ls
        assert state["opt"].curvature is None
    np.testing.assert_array_equal(losses["implicit"], losses["exact"])


def _run_streaming(damping, lr, drift_tol, steps=6):
    init_state, step_fn, *_ = build_trainer(
        tconfigs.get_smoke(ARCH), optimizer_name="ngd", lr=lr,
        damping=damping, batch=4, seq=16, total_steps=steps,
        curvature="streaming", curvature_refresh=3,
        curvature_drift_tol=drift_tol, device="cpu")
    state = init_state()
    losses, m = [], {}
    for s in range(steps):
        state, m = step_fn(state, s)
        losses.append(float(m["loss"]))
    return losses, state["opt"].curvature.stats, m


def test_trainer_streaming_curvature_trains():
    # moderate damping absorbs the staleness between scheduled refreshes
    losses, cs, m = _run_streaming(damping=0.1, lr=0.05, drift_tol=None)
    assert all(np.isfinite(l) for l in losses), losses
    # 6 steps at refresh_every=3: refreshes at steps 0 and 3
    assert int(cs.refreshes) == 2 and int(cs.hits) == 4
    assert "curvature_refreshes" in m and "curvature_hits" in m


def test_trainer_streaming_rejects_non_chol_solver():
    with pytest.raises(ValueError, match="streaming"):
        build_trainer(tconfigs.get_smoke(ARCH), optimizer_name="ngd", lr=0.1,
                      damping=1e-3, batch=4, seq=16, total_steps=2,
                      solver="eigh", curvature="streaming", device="cpu")


def test_trainer_streaming_drift_guard_catches_nonoverlap():
    """Synthetic batches share no curvature step to step; at tiny λ a stale
    W would blow the solve up. The drift guard must detect that (huge
    residual) and refresh every step — degenerating gracefully to the
    exact method instead of diverging."""
    losses, cs, _ = _run_streaming(damping=1e-3, lr=0.1, drift_tol=0.5)
    assert all(np.isfinite(l) for l in losses), losses
    assert int(cs.refreshes) == 6 and int(cs.hits) == 0
    assert float(cs.last_residual) > 0.5
