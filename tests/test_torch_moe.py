"""The torch port's MoE block and the qwen3-moe family against the JAX
package: ``layers.moe_block`` (output and router aux loss, with and
without dropped slots), the SMOKE qwen3-moe forward / ``lm_loss`` /
``sample_logp``, the per-sample score rows by ``vmap(grad)`` in
``ravel_pytree`` order (with drops too), prefill + decode, and the
parameter tree.

fp32, JAX params carried across as numpy arrays, the JAX side jitted.
Tolerances (max-abs over max-abs), as ``test_torch_models.py``: 1e-5 for
the block, 1e-4 through the trunk; decode against the teacher-forced
forward 2e-3, the reference's own ``test_decode_matches_forward``.
Logits are compared over the real vocabulary (the padding slots hold
``NEG_INF``)."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import rel
from repro_torch import configs as tconfigs
from repro_torch.core.pytree import keystr, leaves_with_path, params_from_arrays
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as ttrain
from repro_torch.models import get_api, layers as tl
from repro_torch.models import lm as tlm

try:
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree
    from repro import configs as jconfigs
    from repro.launch import train as jtrain
    from repro.models import layers as jl
    from repro.models import lm as jlm
    from repro.models.api import get_api as jget_api
except ImportError:     # the GPU machine has no JAX
    jax = None

torch.set_num_threads(1)

LAYER_TOL, TRUNK_TOL, DECODE_TOL = 1e-5, 1e-4, 2e-3
ARCHS = ["qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b"]
# capacity factors: the SMOKE configs' 8.0 never drops a slot; at 0.5 an
# expert holds int(0.5·n_tok·K/E) slots and the rest are dropped
CAPACITY = {"no_drop": None, "drop": 0.5}


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(arch, capacity=None):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    if capacity is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity)
        tcfg = tcfg.scaled(capacity_factor=capacity)
    return jcfg, tcfg


def _models(arch, seed=0, capacity=None):
    """(JAX cfg, port cfg, JAX params, the same params as tensors)."""
    jcfg, tcfg = _cfgs(arch, capacity)
    jp = jlm.init_params(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jp, params_from_arrays(jax.device_get(jp),
                                              device="cpu")


def _expert_params(cfg, rng):
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {"router": rng.normal(size=(D, E)) / np.sqrt(D),
         "w_gate": rng.normal(size=(E, D, Fd)) / np.sqrt(D),
         "w_up": rng.normal(size=(E, D, Fd)) / np.sqrt(D),
         "w_down": rng.normal(size=(E, Fd, D)) / np.sqrt(Fd)}
    return {key: val.astype(np.float32) for key, val in p.items()}


def _kept_slots(cfg, n_tok):
    """An expert's capacity: int(capacity_factor·n_tok·K/E), at least 1."""
    return int(cfg.capacity_factor * n_tok * cfg.top_k / cfg.n_experts) or 1


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CAPACITY) + ["tied_router"])
def test_moe_block_matches_jax(case):
    """Output and aux; "tied_router" gives experts 2k and 2k+1 the same
    router column, so every token's probabilities tie in pairs and the
    top-k must take the lower index first, as ``lax.top_k`` does."""
    jcfg, tcfg = _cfgs(ARCHS[0], CAPACITY.get(case))
    rng = np.random.default_rng((sorted(CAPACITY) + ["tied_router"])
                                .index(case))
    p = _expert_params(tcfg, rng)
    if case == "tied_router":
        p["router"][:, 1::2] = p["router"][:, 0::2]
    x = rng.normal(size=(2, 12, tcfg.d_model)).astype(np.float32)
    y, aux = tl.moe_block(_t(x), {k: _t(v) for k, v in p.items()}, tcfg)
    jy, jaux = jax.jit(lambda x, p: jl.moe_block(x, p, jcfg))(x, p)
    assert y.shape == x.shape
    assert rel(y, jy) < LAYER_TOL
    assert abs(float(aux) - float(jaux)) < LAYER_TOL * abs(float(jaux))
    # the drop case drops: some expert is routed more slots than it holds
    _, idx = jax.lax.top_k(jax.nn.softmax(x.reshape(-1, tcfg.d_model)
                                          @ p["router"]), tcfg.top_k)
    most = np.bincount(np.asarray(idx).ravel(), minlength=tcfg.n_experts).max()
    cap = _kept_slots(tcfg, 24)
    assert (most > cap) == (case == "drop"), (most, cap)


def test_moe_block_drops_in_sorted_order():
    """With cap = 1 each expert keeps its first slot in the stable sort
    by expert (token-major order): the output is the gated expert output
    of exactly those slots, and a token whose slots were all dropped
    gets 0."""
    jcfg, tcfg = _cfgs(ARCHS[0], 0.25)
    rng = np.random.default_rng(7)
    p = _expert_params(tcfg, rng)
    x = rng.normal(size=(1, 12, tcfg.d_model)).astype(np.float32)
    tp = {k: _t(v) for k, v in p.items()}
    y, _ = tl.moe_block(_t(x), tp, tcfg)
    jy, _ = jax.jit(lambda x, p: jl.moe_block(x, p, jcfg))(x, p)
    assert _kept_slots(tcfg, 12) == 1
    assert rel(y, jy) < LAYER_TOL
    xf = _t(x)[0]
    probs = torch.softmax(xf @ tp["router"], -1)
    gate, idx = torch.topk(probs, tcfg.top_k)
    gate = gate / gate.sum(-1, keepdim=True)
    first = {}
    for t in range(12):
        for k in range(tcfg.top_k):
            first.setdefault(int(idx[t, k]), (t, k))
    want = torch.zeros_like(xf)
    for e, (t, k) in first.items():
        h = torch.nn.functional.silu(xf[t] @ tp["w_gate"][e]) \
            * (xf[t] @ tp["w_up"][e])
        want[t] += gate[t, k] * (h @ tp["w_down"][e])
    assert rel(y[0], want) < LAYER_TOL
    assert any(not y[0, t].any() for t in range(12)
               if t not in {tk[0] for tk in first.values()})


# ---------------------------------------------------------------------------
# the qwen3-moe LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_logp_match_jax(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    V = tcfg.vocab
    batch = SyntheticLM(jcfg, batch=2, seq=12, seed=1).batch_at(3)
    logits, aux = tlm.forward(tp, tcfg, _t(batch["inputs"]))
    jlogits, jaux = jax.jit(lambda p, t: jlm.forward(p, jcfg, t))(
        jp, jnp.asarray(batch["inputs"]))
    assert logits.shape == (2, 12, tcfg.padded_vocab)
    assert rel(logits[..., :V], jlogits[..., :V]) < TRUNK_TOL
    assert abs(float(aux) - float(jaux)) < TRUNK_TOL * abs(float(jaux))
    assert float(aux) > 0.0
    tb = ttrain.batch_to(batch, "cpu")
    loss, metrics = tlm.lm_loss(tp, tcfg, tb)
    jloss, jm = jax.jit(lambda p, b: jlm.lm_loss(p, jcfg, b))(jp, batch)
    assert abs(float(loss) - float(jloss)) < TRUNK_TOL * abs(float(jloss))
    # lm_loss adds the aux loss; sample_logp leaves it out
    assert float(loss) == float(metrics["nll"] + metrics["aux"])
    assert abs(float(metrics["aux"]) - float(jm["aux"])) \
        < TRUNK_TOL * abs(float(jm["aux"]))
    ex = {key: val[1] for key, val in tb.items()}
    got = tlm.sample_logp(tp, tcfg, ex)
    want = jax.jit(lambda p, e: jlm.sample_logp(p, jcfg, e))(
        jp, {key: val[1] for key, val in batch.items()})
    assert abs(float(got) - float(want)) < TRUNK_TOL * abs(float(want))


@pytest.mark.parametrize("case", sorted(CAPACITY))
def test_score_rows_match_ravel_pytree(case):
    """``make_score_grads``: loss (with the aux loss), the flat mean
    gradient v and the score rows S by ``vmap(grad)``, columns in
    ``ravel_pytree`` order; at capacity 0.5 every example drops slots."""
    jcfg, tcfg, jp, tp = _models(ARCHS[0], seed=2, capacity=CAPACITY[case])
    batch = SyntheticLM(jcfg, batch=3, seq=8, seed=2).batch_at(3)
    scale = 1.0 / np.sqrt(6)
    loss, v, S = ttrain.make_score_grads(get_api(tcfg), scale=scale)(tp, batch)
    jloss, jv, jS = jax.jit(jtrain.make_score_grads(jget_api(jcfg),
                                                    scale=scale))(jp, batch)
    flat, _ = ravel_pytree(jp)
    assert S.shape == (3, flat.shape[0]) and v.shape == (flat.shape[0],)
    assert abs(float(loss) - float(jloss)) < TRUNK_TOL * abs(float(jloss))
    assert rel(v, jv) < TRUNK_TOL
    assert rel(S, jS) < TRUNK_TOL
    names = [keystr(path) for path, _ in leaves_with_path(tp)]
    jnames = [jax.tree_util.keystr(path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert names == jnames
    assert "['blocks'][0]['router']" in names


def test_prefill_and_decode_match_jax():
    """Prefill of 9 tokens, then 5 teacher-forced decode steps: logits and
    the cache against the JAX model, and the logits against the port's
    own teacher-forced forward (the reference's decode test)."""
    jcfg, tcfg, jp, tp = _models(ARCHS[0], seed=3)
    V, P, T = tcfg.vocab, 9, 14
    tokens = np.random.default_rng(1).integers(0, V, (2, T))
    full, _ = tlm.forward(tp, tcfg, _t(tokens))
    logits, cache, idx = tlm.prefill(tp, tcfg, _t(tokens[:, :P]),
                                     max_len=T + 2)
    jlogits, jcache, jidx = jax.jit(lambda p, t: jlm.prefill(
        p, jcfg, t, max_len=T + 2))(jp, jnp.asarray(tokens[:, :P]))
    jdecode = jax.jit(lambda p, c, i, t: jlm.decode_step(p, jcfg, c, i, t))
    assert idx == int(jidx) == P
    assert rel(logits[..., :V], jlogits[..., :V]) < TRUNK_TOL
    for t in range(P, T):
        step = tokens[:, t:t + 1]
        logits, cache = tlm.decode_step(tp, tcfg, cache, t, _t(step))
        jlogits, jcache = jdecode(jp, jcache, jnp.asarray(t),
                                  jnp.asarray(step))
        assert rel(logits[..., :V], jlogits[..., :V]) < TRUNK_TOL, t
        np.testing.assert_allclose(logits[:, 0, :V].numpy(),
                                   full[:, t, :V].numpy(),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
    for c, jc in zip(cache, jcache):
        for key in ("k", "v"):
            assert rel(c[key], jc[key]) < TRUNK_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_and_dtypes_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jshapes = jax.tree.map(lambda x: (x.shape, str(x.dtype)),
                           jlm.param_specs(jcfg))
    tp = get_api(tcfg).init_params(torch.Generator().manual_seed(0))
    tshapes = jax.tree.map(lambda x: (tuple(x.shape),
                                      str(x.dtype).removeprefix("torch.")),
                           tp)
    assert jax.tree.structure(jshapes) == jax.tree.structure(tshapes)
    assert jax.tree.leaves(jshapes) == jax.tree.leaves(tshapes)
    # the reference's scales: router and experts ~ N(0, 1/fan_in)
    blk = tp["blocks"][0]
    for key, fan_in in (("router", tcfg.d_model), ("w_gate", tcfg.d_model),
                        ("w_down", tcfg.d_ff)):
        assert abs(float(blk[key].std()) * np.sqrt(fan_in) - 1.0) < 0.05
