"""The torch port's Mamba2 block and the mamba2 / jamba families against
the JAX package: ``_causal_conv`` in its train and decode forms,
``_ssd_inner`` on each of its branches (plain, ``ssd_factored``,
``ssd_bf16``) with T ragged against the chunk, ``mamba_block`` for train
and one decode step, ``mamba_prefill_cache``, the SMOKE forward /
``lm_loss`` / ``sample_logp``, the score rows, and prefill + decode of
mamba2 and jamba.

fp32, JAX params carried across as numpy arrays, the JAX side jitted.
Tolerances (max-abs over max-abs), as ``test_torch_models.py``: 1e-5 for
a layer, 1e-4 through the trunk; decode against the teacher-forced
forward 2e-3, the reference's own ``test_decode_matches_forward``.
Logits are compared over the real vocabulary (the padding slots hold
``NEG_INF``). ``ssd_bf16`` rounds intermediates (the decay-weighted
M, the states) to bf16 after fp32 sums that the packages order
differently (XLA's cumsum and exp sit ulps from torch's), so a value at
a rounding boundary lands on the neighbouring bf16 value: those branches
are held at 1e-2, ``test_torch_flash_attention.py``'s bf16 tolerance,
and must differ from the fp32 branch."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import rel
from repro_torch import configs as tconfigs
from repro_torch.core.pytree import params_from_arrays
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as ttrain
from repro_torch.models import get_api, layers as tl
from repro_torch.models import lm as tlm

try:
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.launch import train as jtrain
    from repro.models import layers as jl
    from repro.models import lm as jlm
    from repro.models.api import get_api as jget_api
except ImportError:     # the GPU machine has no JAX
    jax = None

torch.set_num_threads(1)

LAYER_TOL, TRUNK_TOL, DECODE_TOL, BF16_TOL = 1e-5, 1e-4, 2e-3, 1e-2
MAMBA, JAMBA = "mamba2-1.3b", "jamba-v0.1-52b"
# _ssd_inner's branches: (ssd_factored, ssd_bf16)
SSD = {"plain": (False, False), "factored": (True, False),
       "bf16": (False, True), "factored_bf16": (True, True)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(arch, **kw):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    return dataclasses.replace(jcfg, **kw), tcfg.scaled(**kw)


def _models(arch, seed=0):
    """(JAX cfg, port cfg, JAX params, the same params as tensors)."""
    jcfg, tcfg = _cfgs(arch)
    jp = jlm.init_params(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jp, params_from_arrays(jax.device_get(jp),
                                              device="cpu")


def _mamba_params(cfg, rng):
    """One Mamba2 slot's params, with a nonzero dt_bias and norm_g."""
    di, nh, g, ds, K = (cfg.d_inner, cfg.ssm_heads, cfg.ssm_groups,
                        cfg.ssm_state, cfg.ssm_conv)
    D = cfg.d_model
    p = {"in_proj": rng.normal(size=(D, 2 * di + 2 * g * ds + nh)) / np.sqrt(D),
         "conv_w": rng.normal(size=(K, di + 2 * g * ds)) * 0.1,
         "dt_bias": rng.normal(size=(nh,)) * 0.5,
         "A_log": np.log(np.linspace(1.0, 16.0, nh)),
         "D": 1.0 + 0.1 * rng.normal(size=(nh,)),
         "norm_g": 0.1 * rng.normal(size=(di,)),
         "out_proj": rng.normal(size=(di, D)) / np.sqrt(di)}
    return {key: val.astype(np.float32) for key, val in p.items()}


def _ssd_inputs(cfg, T, rng, B=2):
    nh, hp, g, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, \
        cfg.ssm_state
    xh = rng.normal(size=(B, T, nh, hp)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, T, nh)))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, nh).astype(np.float32) / 8
    Bm = rng.normal(size=(B, T, g, ds)).astype(np.float32)
    Cm = rng.normal(size=(B, T, g, ds)).astype(np.float32)
    return xh, dt, A, Bm, Cm


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_causal_conv_both_forms_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 11, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    y, none = tl._causal_conv(_t(x), _t(w))
    jy, _ = jl._causal_conv(x, w)
    assert none is None and rel(y, jy) < LAYER_TOL
    state = rng.normal(size=(2, 3, 24)).astype(np.float32)
    y1, st = tl._causal_conv(_t(x[:, :1]), _t(w), state=_t(state))
    jy1, jst = jl._causal_conv(x[:, :1], w, state=state)
    assert rel(y1, jy1) < LAYER_TOL
    assert st.shape == (2, 3, 24) and np.array_equal(st.numpy(),
                                                     np.asarray(jst))


@pytest.mark.parametrize("branch", sorted(SSD))
def test_ssd_inner_branches_match_jax(branch):
    """T = 21 against chunk 8 (zero-padded tail), an initial state h0:
    y and the final state."""
    factored, bf16 = SSD[branch]
    jcfg, tcfg = _cfgs(MAMBA, ssd_factored=factored, ssd_bf16=bf16)
    rng = np.random.default_rng(sorted(SSD).index(branch))
    xh, dt, A, Bm, Cm = _ssd_inputs(tcfg, 21, rng)
    h0 = rng.normal(size=(2, tcfg.ssm_heads, tcfg.ssm_state,
                          tcfg.ssm_head_dim)).astype(np.float32)
    y, hT = tl._ssd_inner(_t(xh), _t(dt), _t(A), _t(Bm), _t(Cm), tcfg,
                          h0=_t(h0))
    jy, jhT = jax.jit(lambda *a: jl._ssd_inner(*a[:5], jcfg, h0=a[5]))(
        xh, dt, A, Bm, Cm, h0)
    assert y.shape == xh.shape and hT.dtype == torch.float32
    tol = BF16_TOL if bf16 else LAYER_TOL
    assert rel(y, jy) < tol
    assert rel(hT, jhT) < tol
    if bf16:
        y32, _ = tl._ssd_inner(_t(xh), _t(dt), _t(A), _t(Bm), _t(Cm),
                               tcfg.scaled(ssd_bf16=False), h0=_t(h0))
        assert rel(y, y32) > LAYER_TOL


def test_ssd_plain_branch_gradient_is_finite_where_decays_overflow():
    """Mask before exp: with A·dt ≈ −100 a step, the upper triangle's
    exp(cum_i − cum_j) overflows fp32; the gradient stays finite and
    equals the JAX one."""
    jcfg, tcfg = _cfgs(MAMBA)
    rng = np.random.default_rng(5)
    xh, dt, A, Bm, Cm = _ssd_inputs(tcfg, 16, rng)
    A = A * 800.0
    f = lambda dt: tl._ssd_inner(_t(xh), dt, _t(A), _t(Bm), _t(Cm),
                                 tcfg)[0].sum()
    g = torch.func.grad(f)(_t(dt))
    jg = jax.grad(lambda dt: jl._ssd_inner(xh, dt, A, Bm, Cm,
                                           jcfg)[0].sum())(dt)
    assert torch.isfinite(g).all()
    assert rel(g, jg) < LAYER_TOL


def test_mamba_block_train_and_decode_match_jax():
    jcfg, tcfg = _cfgs(MAMBA)
    rng = np.random.default_rng(2)
    p = _mamba_params(tcfg, rng)
    tp = {key: _t(val) for key, val in p.items()}
    x = rng.normal(size=(2, 13, tcfg.d_model)).astype(np.float32)
    y, none = tl.mamba_block(_t(x), tp, tcfg)
    jy, _ = jax.jit(lambda x, p: jl.mamba_block(x, p, jcfg))(x, p)
    assert none is None and rel(y, jy) < LAYER_TOL
    cache = {"conv": rng.normal(size=(2, tcfg.ssm_conv - 1, tcfg.d_inner
                                      + 2 * tcfg.ssm_state)),
             "ssm": rng.normal(size=(2, tcfg.ssm_heads, tcfg.ssm_state,
                                     tcfg.ssm_head_dim))}
    cache = {key: val.astype(np.float32) for key, val in cache.items()}
    y1, new = tl.mamba_block(_t(x[:, :1]), tp, tcfg,
                             cache={k: _t(v) for k, v in cache.items()})
    jy1, jnew = jax.jit(lambda x, p, c: jl.mamba_block(x, p, jcfg, cache=c))(
        x[:, :1], p, cache)
    assert rel(y1, jy1) < LAYER_TOL
    for key in ("conv", "ssm"):
        assert new[key].shape == cache[key].shape
        assert rel(new[key], jnew[key]) < LAYER_TOL


def test_mamba_prefill_cache_matches_jax():
    jcfg, tcfg = _cfgs(MAMBA)
    rng = np.random.default_rng(3)
    p = _mamba_params(tcfg, rng)
    h = rng.normal(size=(2, 19, tcfg.d_model)).astype(np.float32)
    c = tlm.mamba_prefill_cache(_t(h), {k: _t(v) for k, v in p.items()},
                                tcfg)
    jc = jax.jit(lambda h, p: jlm.mamba_prefill_cache(h, p, jcfg))(h, p)
    for key in ("conv", "ssm"):
        assert c[key].dtype == torch.float32
        assert rel(c[key], jc[key]) < LAYER_TOL


# ---------------------------------------------------------------------------
# the mamba2 and jamba LMs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_forward_loss_and_logp_match_jax(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    V = tcfg.vocab
    batch = SyntheticLM(jcfg, batch=2, seq=12, seed=1).batch_at(3)
    logits, aux = tlm.forward(tp, tcfg, _t(batch["inputs"]))
    jlogits, jaux = jax.jit(lambda p, t: jlm.forward(p, jcfg, t))(
        jp, jnp.asarray(batch["inputs"]))
    assert rel(logits[..., :V], jlogits[..., :V]) < TRUNK_TOL
    assert abs(float(aux) - float(jaux)) <= TRUNK_TOL * abs(float(jaux))
    tb = ttrain.batch_to(batch, "cpu")
    loss, _ = tlm.lm_loss(tp, tcfg, tb)
    jloss, _ = jax.jit(lambda p, b: jlm.lm_loss(p, jcfg, b))(jp, batch)
    assert abs(float(loss) - float(jloss)) < TRUNK_TOL * abs(float(jloss))
    ex = {key: val[0] for key, val in tb.items()}
    got = tlm.sample_logp(tp, tcfg, ex)
    want = jax.jit(lambda p, e: jlm.sample_logp(p, jcfg, e))(
        jp, {key: val[0] for key, val in batch.items()})
    assert abs(float(got) - float(want)) < TRUNK_TOL * abs(float(want))


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_score_rows_match_jax(arch):
    jcfg, tcfg, jp, tp = _models(arch, seed=2)
    batch = SyntheticLM(jcfg, batch=3, seq=8, seed=2).batch_at(3)
    loss, v, S = ttrain.make_score_grads(get_api(tcfg))(tp, batch)
    jloss, jv, jS = jax.jit(jtrain.make_score_grads(jget_api(jcfg)))(jp,
                                                                     batch)
    assert abs(float(loss) - float(jloss)) < TRUNK_TOL * abs(float(jloss))
    assert rel(v, jv) < TRUNK_TOL
    assert rel(S, jS) < TRUNK_TOL


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_prefill_and_decode_match_jax(arch):
    """Prefill of 9 tokens, then 5 teacher-forced decode steps: logits and
    the whole cache (conv and SSM states written in place) against the
    JAX model, and the logits against the port's own teacher-forced
    forward (the reference's decode test)."""
    jcfg, tcfg, jp, tp = _models(arch, seed=3)
    V, P, T = tcfg.vocab, 9, 14
    tokens = np.random.default_rng(1).integers(0, V, (2, T))
    full, _ = tlm.forward(tp, tcfg, _t(tokens))
    logits, cache, idx = tlm.prefill(tp, tcfg, _t(tokens[:, :P]),
                                     max_len=T + 2)
    jlogits, jcache, _ = jax.jit(lambda p, t: jlm.prefill(
        p, jcfg, t, max_len=T + 2))(jp, jnp.asarray(tokens[:, :P]))
    jdecode = jax.jit(lambda p, c, i, t: jlm.decode_step(p, jcfg, c, i, t))
    assert idx == P and rel(logits[..., :V], jlogits[..., :V]) < TRUNK_TOL
    ssm = [c["ssm"] for c in cache if "ssm" in c]
    for t in range(P, T):
        step = tokens[:, t:t + 1]
        logits, out = tlm.decode_step(tp, tcfg, cache, t, _t(step))
        jlogits, jcache = jdecode(jp, jcache, jnp.asarray(t),
                                  jnp.asarray(step))
        assert out is cache
        assert rel(logits[..., :V], jlogits[..., :V]) < TRUNK_TOL, t
        np.testing.assert_allclose(logits[:, 0, :V].numpy(),
                                   full[:, t, :V].numpy(),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
    # the states were written into the prefill's tensors
    assert all(a is c["ssm"] for a, c in zip(ssm, [c for c in cache
                                                   if "ssm" in c]))
    assert len(cache) == len(jcache)
    for c, jc in zip(cache, jcache):
        assert sorted(c) == sorted(jc)
        for key in c:
            assert tuple(c[key].shape) == jc[key].shape
            assert rel(c[key], jc[key]) < TRUNK_TOL, key


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_params_and_cache_shapes_match_jax(arch):
    """The parameter tree (a pure-SSM slot has no FFN; jamba's mamba
    slots do, MoE on the odd ones) and the zero decode cache."""
    jcfg, tcfg = _cfgs(arch)
    jshapes = jax.tree.map(lambda x: (x.shape, str(x.dtype)),
                           jlm.param_specs(jcfg))
    tp = get_api(tcfg).init_params(torch.Generator().manual_seed(0))
    tshapes = jax.tree.map(lambda x: (tuple(x.shape),
                                      str(x.dtype).removeprefix("torch.")),
                           tp)
    assert jax.tree.structure(jshapes) == jax.tree.structure(tshapes)
    assert jax.tree.leaves(jshapes) == jax.tree.leaves(tshapes)
    blk = tp["blocks"][0]
    assert ("ffn_norm" in blk) == (arch == JAMBA)
    assert torch.equal(blk["A_log"][0], torch.log(torch.linspace(
        1.0, 16.0, tcfg.ssm_heads)))
    assert not blk["norm_g"].any() and not blk["dt_bias"].any()
    zeros = get_api(tcfg).init_cache(2, 16)
    jzeros = jlm.init_cache(jcfg, 2, 16)
    assert [{k: tuple(t.shape) for k, t in c.items()} for c in zeros] \
        == [{k: t.shape for k, t in c.items()} for c in jzeros]
    bf = tcfg.scaled(dtype="bfloat16")
    assert all(t.dtype == torch.bfloat16 and not t.any()
               for c in get_api(bf).init_cache(1, 4) for t in c.values())
