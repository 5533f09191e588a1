"""The port's NGD train step over a mesh (``launch.train.
make_ngd_train_step(mesh=, score_sharding=, flat_scores=, blocked=)``)
against the JAX package, on the CPU.

Every mesh position lies on the CPU (``make_mesh(..., device="cpu")``),
one process driving them all, as on a card. Under GSPMD a sharded step
computes the single-device step, so each port step over a mesh is held to
the reference's step on its one CPU device with a (1, 1) mesh, from the
same weights (``params_from_arrays``) and the same ``SyntheticLM``
batches, with ``tests/test_torch_trainer.py``'s tolerances
(``_torch_mesh``). The build, the CLI, the AdamW step, the streaming
policy, ``place`` and ``prefetch``: ``test_torch_mesh_trainer.py``.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_mesh import (ARCH, BATCH, LAM, LOSS_TOL, LR, SEED, SEQ, STEPS,
                         check, jax_smoke_params)
from repro import configs as jconfigs
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import train as jtrain
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.models.api import get_api as jget_api
from repro.optim import NaturalGradient as JNaturalGradient
from repro_torch import configs as tconfigs
from repro_torch.core.pytree import params_from_arrays, params_to_arrays
from repro_torch.data import SyntheticLM, place
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.api import get_api
from repro_torch.optim import NaturalGradient

torch.set_num_threads(1)

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
LAYOUTS = {"1d": {}, "2d": {"score_sharding": "2d"},
           "flat": {"flat_scores": True}, "blocked": {"blocked": True}}


@pytest.fixture(scope="module")
def jax_params():
    return jax_smoke_params()


def _jax_ngd(jax_params, blocked: bool, data):
    """The reference's NGD step on a (1, 1) mesh: losses and params."""
    opt = JNaturalGradient(LR, damping=LAM)
    step = jax.jit(jtrain.make_ngd_train_step(
        jget_api(jconfigs.get_smoke(ARCH)), opt,
        jmake_mesh((1, 1), ("data", "model")), blocked=blocked))
    p = jax.tree.map(jax.numpy.asarray, jax_params)
    st, losses = opt.init(p), []
    for s in range(STEPS):
        p, st, m = step(p, st, data.batch_at(s))
        losses.append(float(m["loss"]))
    return losses, [np.asarray(x) for x in jax.tree.leaves(
        jax.device_get(p))]


@pytest.fixture(scope="module")
def jax_runs(jax_params):
    data = JSyntheticLM(jconfigs.get_smoke(ARCH), batch=BATCH, seq=SEQ,
                        seed=SEED)
    return {b: _jax_ngd(jax_params, b, data) for b in (False, True)}


def _port_ngd(jax_params, mesh, data, **kw):
    opt = NaturalGradient(LR, damping=LAM)
    step = ttrain.make_ngd_train_step(get_api(tconfigs.get_smoke(ARCH)),
                                      opt, mesh, **kw)
    p = params_from_arrays(jax_params, device="cpu")
    st, losses = opt.init(p), []
    for s in range(STEPS):
        p, st, m = step(p, st, data.batch_at(s))
        losses.append(float(m["loss"]))
    return losses, jax.tree.leaves(params_to_arrays(p))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_ngd_step_over_mesh_matches_jax(mesh_name, layout, jax_params,
                                        jax_runs):
    mesh = make_mesh(*MESHES[mesh_name], device="cpu")
    data = SyntheticLM(tconfigs.get_smoke(ARCH), batch=BATCH, seq=SEQ,
                       seed=SEED)
    kw = LAYOUTS[layout]
    check(_port_ngd(jax_params, mesh, data, **kw),
           jax_runs[kw.get("blocked", False)])


class _HalfMasked:
    """``SyntheticLM``'s batches with the first half's rows masked past
    their first quarter: the DP pieces' mask counts differ four to one."""

    def __init__(self, data):
        self.data = data

    def batch_at(self, step):
        b = dict(self.data.batch_at(step))
        b["mask"] = b["mask"].copy()
        b["mask"][:BATCH // 2, SEQ // 4:] = 0.0
        return b


def test_unequal_mask_counts_weight_the_pieces(jax_params):
    """The step's loss and v are the whole batch's masked mean (the
    reference's), which the plain mean of the pieces' means is not: that
    mean lies more than LOSS_TOL from the whole batch's loss."""
    kw = dict(batch=BATCH, seq=SEQ, seed=SEED)
    jdata = _HalfMasked(JSyntheticLM(jconfigs.get_smoke(ARCH), **kw))
    tdata = _HalfMasked(SyntheticLM(tconfigs.get_smoke(ARCH), **kw))
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    check(_port_ngd(jax_params, mesh, tdata), _jax_ngd(jax_params, False,
                                                        jdata))
    api = get_api(tconfigs.get_smoke(ARCH))
    p = params_from_arrays(jax_params, device="cpu")
    batch = tdata.batch_at(0)
    pieces = place(batch, make_mesh((2,), ("data",), device="cpu"))
    counts = [float(b["mask"].sum()) for b in pieces]
    assert 4 * counts[0] <= counts[1], counts
    with torch.no_grad():
        whole = float(api.loss(p, ttrain.batch_to(batch, "cpu"))[0])
        means = [float(api.loss(p, piece)[0]) for piece in pieces]
    assert abs(np.mean(means) - whole) > LOSS_TOL * abs(whole), \
        (means, whole)
