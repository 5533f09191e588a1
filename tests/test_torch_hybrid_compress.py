"""The port's hybrid optimizer and compressed all-reduce
(``repro_torch.optim.hybrid``, ``repro_torch.optim.compress``) against
the JAX package's, on the same numpy inputs, on the CPU.

* ``path_of``, ``partition_params`` and ``merge_params``: the same paths,
  the same leaves selected and the same ``None`` placeholders as
  ``repro.optim.hybrid`` on the SMOKE LM's parameter tree;
* ``HybridNGD.update`` on the logistic problem of
  ``tests/test_optim.py`` against the reference's (rtol 1e-3, atol 1e-5,
  ``tests/test_torch_optim.py``'s for an update), and on the SMOKE LM
  bit for bit against ``NaturalGradient`` on the subset alone plus
  ``AdamW`` on the rest;
* ``bf16_allreduce`` and ``Int8ErrorFeedback.allreduce`` over 4 per-
  position gradients against the reference run under ``jax.vmap(...,
  axis_name="data")`` (its ``psum`` needs no second device): bit for bit,
  the residuals too, over three error-feedback steps; and bf16 within
  2e-2 of the fp32 sum relative to its max (the reference's gate,
  ``tests/test_distributed.py:234``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.api import get_api as jget_api
from repro.optim import AdamW as JAdamW
from repro.optim import NaturalGradient as JNaturalGradient
from repro.optim import per_sample_scores as jper_sample_scores
from repro.optim.compress import Int8ErrorFeedback as JInt8
from repro.optim.compress import bf16_allreduce as jbf16_allreduce
from repro.optim.hybrid import HybridNGD as JHybridNGD
from repro.optim.hybrid import merge_params as jmerge
from repro.optim.hybrid import partition_params as jpartition
from repro.optim.hybrid import path_of as jpath_of
from repro_torch import configs as tconfigs
from repro_torch.core.pytree import (leaves, leaves_with_path,
                                     params_from_arrays, tree_map)
from repro_torch.data import SyntheticLM
from repro_torch.launch.train import batch_to
from repro_torch.models.api import get_api
from repro_torch.optim import (AdamW, HybridNGD, Int8ErrorFeedback,
                               NaturalGradient, bf16_allreduce,
                               merge_params, partition_params, path_of,
                               per_sample_scores)
from repro_torch.optim.scores import grad_and_value

torch.set_num_threads(1)

ARCH = "llama3.2-3b"
POSITIONS = 4
FILTERS = {
    "embed": lambda path: path == "embed",
    "blocks": lambda path: path.startswith("blocks"),
}


@pytest.fixture(scope="module")
def lm_params():
    api = jget_api(jconfigs.get_smoke(ARCH))
    return jax.device_get(api.init_params(jax.random.key(0)))


def _mask_of(tree):
    """The tree's structure with each leaf marked: True for an array, None
    for a placeholder (JAX trees: ``None`` is an empty subtree)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _mask_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_mask_of(v) for v in tree]
    return True


def test_path_of_matches_jax(lm_params):
    want = [jpath_of(kp) for kp, _ in
            jax.tree_util.tree_flatten_with_path(lm_params)[0]]
    got = [path_of(p) for p, _ in
           leaves_with_path(params_from_arrays(lm_params, device="cpu"))]
    assert got == want
    assert "embed" in got and any(p.startswith("blocks/0/") for p in got)


@pytest.mark.parametrize("which", sorted(FILTERS))
def test_partition_and_merge_match_jax(which, lm_params):
    keep = FILTERS[which]
    tparams = params_from_arrays(lm_params, device="cpu")
    jsel, jrest = jpartition(lm_params, keep)
    sel, rest = partition_params(tparams, keep)
    assert _mask_of(sel) == _mask_of(jsel)
    assert _mask_of(rest) == _mask_of(jrest)
    assert 0 < len(leaves(sel)) < len(leaves(tparams))
    assert len(leaves(sel)) + len(leaves(rest)) == len(leaves(tparams))
    merged = merge_params(sel, rest)
    assert _mask_of(merged) == _mask_of(jmerge(jsel, jrest))
    for a, b in zip(leaves(merged), leaves(tparams)):
        assert a is b


def _logreg(n=64, d=10, c=4, seed=0):
    """``tests/test_optim.py``'s logistic problem, as numpy."""
    rng = np.random.default_rng(seed)
    params = {"w": (rng.normal(size=(d, c)) * 0.1).astype(np.float32),
              "b": np.zeros((c,), np.float32)}
    X = rng.normal(size=(n, d)).astype(np.float32)
    Y = rng.integers(0, c, size=(n,))
    return params, X, Y


@pytest.mark.parametrize("prefix", ["w", "b"])
def test_hybrid_update_matches_jax(prefix):
    """Three ``HybridNGD`` steps, NGD on the leaves under ``prefix`` and
    AdamW on the other, from the same weights and data."""
    params, X, Y = _logreg()

    def jlogp(p, ex):
        x, y = ex
        return jax.nn.log_softmax(x @ p["w"] + p["b"])[y]

    def jloss(p):
        return -jnp.mean(jax.vmap(lambda ex: jlogp(p, ex))((X, Y)))

    def tlogp(p, ex):
        x, y = ex
        return torch.log_softmax(x @ p["w"] + p["b"], dim=-1)[y]

    def tloss(p):
        return -torch.func.vmap(lambda x, y: tlogp(p, (x, y)))(tX, tY).mean()

    tX, tY = torch.from_numpy(X), torch.from_numpy(Y)
    keep = (lambda path: path.startswith(prefix))
    jh = JHybridNGD(keep, ngd=JNaturalGradient(0.5, damping=1e-2,
                                               momentum=0.9),
                    adamw=JAdamW(1e-2, weight_decay=0.0))
    th = HybridNGD(keep, ngd=NaturalGradient(0.5, damping=1e-2,
                                             momentum=0.9),
                   adamw=AdamW(1e-2, weight_decay=0.0))
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_arrays(params, device="cpu")
    jst, tst = jh.init(jp), th.init(tp)
    tgrad = grad_and_value(tloss)
    for _ in range(3):
        jsub = {prefix: jp[prefix]}
        jS = jper_sample_scores(lambda pw, ex: jlogp({**jp, **pw}, ex),
                                jsub, (jnp.asarray(X), jnp.asarray(Y)))
        jupd, jst = jh.update(jax.grad(jloss)(jp), jst, jp, scores=jS)
        tsub = {prefix: tp[prefix]}
        tS = per_sample_scores(lambda pw, ex: tlogp({**tp, **pw}, ex),
                               tsub, (tX, tY))
        tupd, tst = th.update(tgrad(tp)[0], tst, tp, scores=tS)
        for k in params:
            np.testing.assert_allclose(tupd[k].numpy(), np.asarray(jupd[k]),
                                       rtol=1e-3, atol=1e-5)
        jp = jax.tree.map(jnp.add, jp, jupd)
        tp = tree_map(torch.add, tp, tupd)
    assert float(np.abs(np.asarray(jupd["w"])).max()) > 0
    assert float(np.abs(np.asarray(jupd["b"])).max()) > 0


def test_hybrid_on_the_lm_is_its_two_parts(lm_params):
    """On the SMOKE LM, NGD on the embedding table and AdamW on the rest:
    the selected half of the update is bit for bit ``NaturalGradient`` on
    the subset alone, the rest bit for bit ``AdamW`` alone."""
    cfg = tconfigs.get_smoke(ARCH)
    api = get_api(cfg)
    keep = FILTERS["embed"]
    params = params_from_arrays(lm_params, device="cpu")
    batch = batch_to(SyntheticLM(cfg, batch=4, seq=16).batch_at(0), "cpu")
    grads, _ = grad_and_value(api.loss, has_aux=True)(params, batch)
    S = per_sample_scores(
        lambda pw, ex: api.sample_logp({**params, **pw}, ex),
        {"embed": params["embed"]}, batch)
    hyb = HybridNGD(keep, ngd=NaturalGradient(0.1, damping=1e-3),
                    adamw=AdamW(3e-3))
    upd, st = hyb.update(grads, hyb.init(params), params, scores=S)
    gsel, grest = partition_params(grads, keep)
    psel, prest = partition_params(params, keep)
    ngd, adamw = NaturalGradient(0.1, damping=1e-3), AdamW(3e-3)
    usel, _ = ngd.update(gsel, ngd.init(psel), psel, scores=S)
    urest, _ = adamw.update(grest, adamw.init(prest), prest)
    want = merge_params(usel, urest)
    assert len(leaves(upd)) == len(leaves(params))
    for a, b in zip(leaves(upd), leaves(want)):
        assert torch.equal(a, b)
    assert st.ngd.step == 1 and st.adamw.step == 1


def _pieces(seed):
    """Per-position gradient trees (numpy, leading position axis): a
    large-scale leaf and a small one, so the scales differ by position."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(POSITIONS, 64, 3)).astype(np.float32),
            "b": (rng.normal(size=(POSITIONS, 7))
                  * np.array([1e-3, 1.0, 10.0, 1e-2])[:, None]
                  ).astype(np.float32)}


def _at(tree, p):
    return {k: torch.from_numpy(np.ascontiguousarray(v[p]))
            for k, v in tree.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_allreduce_matches_jax(seed):
    g = _pieces(seed)
    want = jax.vmap(lambda x: jbf16_allreduce(x, "data"),
                    axis_name="data")(g)
    got = bf16_allreduce([_at(g, p) for p in range(POSITIONS)])
    for k in g:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k][0]))
        exact = g[k].sum(0)
        rel = np.abs(got[k].numpy() - exact).max() / np.abs(exact).max()
        assert rel < 2e-2, rel


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_error_feedback_matches_jax(seed):
    """Three steps, each position carrying its own residual."""
    g = _pieces(seed)
    jcomp, tcomp = JInt8(), Int8ErrorFeedback()

    def jstep(x, r):
        return jcomp.allreduce(x, jcomp.init(x)._replace(residual=r), "data")

    jres = jax.tree.map(jnp.zeros_like, g)
    tst = [tcomp.init(_at(g, p)) for p in range(POSITIONS)]
    for step in range(3):
        gs = {k: v * (1.0 + step) for k, v in g.items()}
        jout, jst = jax.vmap(jstep, axis_name="data")(gs, jres)
        jres = jst.residual
        tout, tst = tcomp.allreduce([_at(gs, p) for p in range(POSITIONS)],
                                    tst)
        for k in g:
            np.testing.assert_array_equal(tout[k].numpy(),
                                          np.asarray(jout[k][0]))
            for p in range(POSITIONS):
                np.testing.assert_array_equal(
                    tst[p].residual[k].numpy(), np.asarray(jres[k][p]))
    assert all(np.isfinite(tout[k].numpy()).all() for k in g)
