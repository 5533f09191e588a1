"""The torch port's model zoo (dense attention) against the JAX package:
layers, the LM's forward / ``sample_logp`` / ``lm_loss``, the per-sample
score rows, prefill + decode (gemma2's ring cache included), the
synthetic data, the configs, and every family building (A6 is ported).

Everything runs in fp32 on the SMOKE configs with the JAX params carried
across as numpy arrays. Tolerances (max-abs over max-abs): 1e-5 for a
single layer, 1e-4 for anything through the two- or four-layer trunk
(fp32 sums in another order at every matmul, rope's sin/cos within an
ulp of XLA's)."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import rel
from repro_torch import configs as tconfigs
from repro_torch.core.pytree import keystr, leaves_with_path, params_from_arrays
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as ttrain
from repro_torch.models import ModelConfig, BlockSlot, get_api, layers as tl
from repro_torch.models import lm as tlm

try:
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree
    from repro import configs as jconfigs
    from repro.data import SyntheticLM as JSyntheticLM
    from repro.launch import train as jtrain
    from repro.models import layers as jl
    from repro.models import lm as jlm
    from repro.models.api import get_api as jget_api
except ImportError:     # the GPU machine has no JAX
    jax = None

torch.set_num_threads(1)

LAYER_TOL, TRUNK_TOL = 1e-5, 1e-4
ARCHS = ["llama3.2-3b", "gemma2-2b"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(arch, seed=0):
    """(JAX cfg, port cfg, JAX params, the same params as tensors)."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp = jlm.init_params(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jp, params_from_arrays(jax.device_get(jp),
                                              device="cpu")


def _batch(cfg, n, T, seed):
    return SyntheticLM(cfg, batch=n, seq=T, seed=seed).batch_at(3)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    g = rng.normal(size=(16,)).astype(np.float32) * 0.1
    b = rng.normal(size=(16,)).astype(np.float32)
    assert rel(tl.rms_norm(_t(x), _t(g)), jl.rms_norm(x, g)) < LAYER_TOL
    assert rel(tl.layer_norm(_t(x), _t(g), _t(b)),
               jl.layer_norm(x, g, b)) < LAYER_TOL
    pos = np.broadcast_to(np.arange(7) + 40, (2, 7))
    for theta in (1e4, 5e5):
        assert rel(tl.rope(_t(x), _t(pos), theta=theta),
                   jl.rope(x, jnp.asarray(pos), theta=theta)) < LAYER_TOL


@pytest.mark.parametrize("case", ["softcap", "kv_len", "k_positions",
                                  "bidirectional_bf16_operands"])
def test_blockwise_attention_matches_jax(case):
    rng = np.random.default_rng(["softcap", "kv_len", "k_positions",
                                 "bidirectional_bf16_operands"].index(case))
    B, Tq, Tk, KH, g, hd = 2, 5, 24, 2, 2, 16
    if case == "k_positions" or case == "kv_len":
        Tq = 1
    q = rng.normal(size=(B, Tq, KH * g, hd)).astype(np.float32)
    k = rng.normal(size=(B, Tk, KH, hd)).astype(np.float32)
    v = rng.normal(size=(B, Tk, KH, hd)).astype(np.float32)
    kw = {"kv_block": 8}
    if case == "softcap":
        kw.update(softcap=5.0, window=6)
    elif case == "kv_len":
        kw.update(q_offset=13, kv_len=14)
    elif case == "k_positions":
        kp = np.asarray([20, 21, 22, 23, -1, -1] + list(range(14, 20))
                        + [-1] * 12)
        kw.update(q_offset=23, k_positions=kp, window=8)
    else:
        kw.update(causal=False, bf16_operands=True)
    tkw = {key: (_t(val) if isinstance(val, np.ndarray) else val)
           for key, val in kw.items()}
    jkw = {key: (jnp.asarray(val) if isinstance(val, np.ndarray) else val)
           for key, val in kw.items()}
    got = tl.flash_attention(_t(q), _t(k), _t(v), **tkw)
    want = jl.flash_attention(q, k, v, **jkw)
    assert rel(got, want) < LAYER_TOL


def test_qkv_and_mlp_match_jax():
    rng = np.random.default_rng(3)
    cfg = tconfigs.get_smoke("llama3.2-3b")
    D, H, KH, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    p = {"wq": rng.normal(size=(D, H * hd)), "wk": rng.normal(size=(D, KH * hd)),
         "wv": rng.normal(size=(D, KH * hd)), "w_gate": rng.normal(size=(D, F)),
         "w_up": rng.normal(size=(D, F)), "w_down": rng.normal(size=(F, D))}
    p = {key: (val / np.sqrt(val.shape[0])).astype(np.float32)
         for key, val in p.items()}
    x = rng.normal(size=(2, 6, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6), (2, 6))
    tp = {key: _t(val) for key, val in p.items()}
    for a, b in zip(tl.attn_qkv(_t(x), tp, cfg, positions=_t(pos)),
                    jl.attn_qkv(x, p, jconfigs.get_smoke("llama3.2-3b"),
                                positions=jnp.asarray(pos))):
        assert rel(a, b) < LAYER_TOL
    assert rel(tl.swiglu_mlp(_t(x), tp), jl.swiglu_mlp(x, p)) < LAYER_TOL


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_logp_match_jax(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    batch = _batch(jcfg, 2, 12, seed=1)
    logits, _ = tlm.forward(tp, tcfg, _t(batch["inputs"]))
    jlogits, _ = jax.jit(lambda p, t: jlm.forward(p, jcfg, t))(
        jp, jnp.asarray(batch["inputs"]))
    assert logits.shape == (2, 12, tcfg.padded_vocab)
    assert rel(logits, jlogits) < TRUNK_TOL
    tb = ttrain.batch_to(batch, "cpu")
    loss, metrics = tlm.lm_loss(tp, tcfg, tb)
    jloss, _ = jax.jit(lambda p, b: jlm.lm_loss(p, jcfg, b))(jp, batch)
    assert abs(float(loss) - float(jloss)) < TRUNK_TOL * abs(float(jloss))
    assert float(metrics["nll"]) == float(loss)
    ex = {key: val[1] for key, val in tb.items()}
    got = tlm.sample_logp(tp, tcfg, ex)
    want = jax.jit(lambda p, e: jlm.sample_logp(p, jcfg, e))(
        jp, {key: val[1] for key, val in batch.items()})
    assert abs(float(got) - float(want)) < TRUNK_TOL * abs(float(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_score_rows_match_ravel_pytree(arch):
    """``make_score_grads``: loss, the flat mean gradient v and the score
    rows S, columns in ``ravel_pytree`` order (block names = keystr)."""
    jcfg, tcfg, jp, tp = _models(arch, seed=2)
    batch = _batch(jcfg, 3, 8, seed=2)
    scale = 1.0 / np.sqrt(6)
    loss, v, S = ttrain.make_score_grads(get_api(tcfg), scale=scale)(tp, batch)
    jloss, jv, jS = jax.jit(jtrain.make_score_grads(jget_api(jcfg),
                                                    scale=scale))(jp, batch)
    flat, _ = ravel_pytree(jp)
    assert S.shape == (3, flat.shape[0]) and v.shape == (flat.shape[0],)
    assert abs(float(loss) - float(jloss)) < TRUNK_TOL * abs(float(jloss))
    assert rel(v, jv) < TRUNK_TOL
    assert rel(S, jS) < TRUNK_TOL
    # the score blocks' names and order: the params' flatten order
    names = [keystr(path) for path, _ in leaves_with_path(tp)]
    jnames = [jax.tree_util.keystr(path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert names == jnames and names[0].startswith("['blocks'][0]")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill of 12 tokens (longer than gemma2's smoke window of 8: the
    ring layout) then 4 greedy decode steps: logits and the whole cache."""
    jcfg, tcfg, jp, tp = _models(arch, seed=3)
    prompt = _batch(jcfg, 2, 12, seed=3)["inputs"]
    max_len = 16
    logits, cache, idx = tlm.prefill(tp, tcfg, _t(prompt), max_len=max_len)
    jlogits, jcache, jidx = jax.jit(lambda p, t: jlm.prefill(
        p, jcfg, t, max_len=max_len))(jp, jnp.asarray(prompt))
    jdecode = jax.jit(lambda p, c, i, t: jlm.decode_step(p, jcfg, c, i, t))
    assert idx == int(jidx) == 12
    assert rel(logits, jlogits) < TRUNK_TOL
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    jtok = jnp.argmax(jlogits[:, -1], -1)[:, None]
    assert np.array_equal(tok.numpy(), np.asarray(jtok))
    for t in range(4):
        logits, cache = tlm.decode_step(tp, tcfg, cache, idx + t, tok)
        jlogits, jcache = jdecode(jp, jcache, jidx + t, jtok)
        assert rel(logits, jlogits) < TRUNK_TOL, t
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        jtok = jnp.argmax(jlogits[:, -1], -1)[:, None]
        assert np.array_equal(tok.numpy(), np.asarray(jtok)), t
    assert len(cache) == len(jcache)
    for c, jc in zip(cache, jcache):
        for key in ("k", "v"):
            assert c[key].shape == jc[key].shape
            assert rel(c[key], jc[key]) < TRUNK_TOL
    zeros = get_api(tcfg).init_cache(2, max_len)
    jzeros = jlm.init_cache(jcfg, 2, max_len)
    assert [{k: (tuple(t.shape), t.dtype) for k, t in c.items()} for c in zeros] \
        == [{k: (tuple(t.shape), torch.float32) for k, t in c.items()}
            for c in jzeros]
    assert all(not t.any() for c in zeros for t in c.values())


def test_prefill_takes_the_kernel_route_only_without_softcap(monkeypatch):
    calls = []
    real = tlm.ops.flash_attention

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)
    monkeypatch.setattr(tlm.ops, "flash_attention", spy)
    for arch, expect in (("llama3.2-3b", 2), ("gemma2-2b", 0)):
        cfg = tconfigs.get_smoke(arch)
        p = get_api(cfg).init_params(torch.Generator().manual_seed(0))
        toks = torch.randint(3, cfg.vocab, (1, 10))
        calls.clear()
        tlm.prefill(p, cfg, toks, max_len=12)
        assert len(calls) == expect, arch
        calls.clear()
        tlm.forward(p, cfg, toks)
        assert not calls, arch           # the train pass stays blockwise


def test_init_params_shapes_and_dtypes_match_jax():
    for arch in ARCHS + ["llama3-8b", "gemma2-9b"]:
        jcfg = jconfigs.get_smoke(arch)
        tcfg = tconfigs.get_smoke(arch)
        jshapes = jax.tree.map(lambda x: (x.shape, str(x.dtype)),
                               jlm.param_specs(jcfg))
        tp = get_api(tcfg).init_params(torch.Generator().manual_seed(0))
        tshapes = jax.tree.map(lambda x: (tuple(x.shape),
                                          str(x.dtype).removeprefix("torch.")),
                               tp)
        assert jax.tree.structure(jshapes) == jax.tree.structure(tshapes)
        assert jax.tree.leaves(jshapes) == jax.tree.leaves(tshapes), arch
    # the published configs too, without allocating them
    cfg = tconfigs.get_config("llama3.2-3b")
    assert (cfg.padded_vocab, cfg.head_dim, cfg.param_dtype) == (
        128_256, 128, torch.bfloat16)


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------

def test_configs_equal_the_reference():
    for arch in tconfigs.ARCHS:
        for getter in ("get_config", "get_smoke"):
            t = dataclasses.asdict(getattr(tconfigs, getter)(arch))
            j = dataclasses.asdict(getattr(jconfigs, getter)(arch))
            assert t == j, (arch, getter)
    assert tconfigs.list_archs() == jconfigs.list_archs()
    from repro.configs import shapes as jshapes
    from repro_torch.configs import shapes as tshapes
    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma2-9b"])
def test_synthetic_batches_bit_for_bit(arch):
    for pack in (True, False):
        t = SyntheticLM(tconfigs.get_smoke(arch), batch=3, seq=40, seed=5,
                        pack_documents=pack, mean_doc_len=16)
        j = JSyntheticLM(jconfigs.get_smoke(arch), batch=3, seq=40, seed=5,
                         pack_documents=pack, mean_doc_len=16)
        for step in (0, 1, 7):
            tb, jb = t.batch_at(step), j.batch_at(step)
            assert tb.keys() == jb.keys()
            for key in tb:
                assert tb[key].dtype == jb[key].dtype
                assert np.array_equal(tb[key], jb[key]), (key, step)


def test_families_not_ported_raise():
    """A retired refusal (ROADMAP A6 is ported), under its old name: every
    architecture of the reference builds; the encdec and audio families
    and a cross-attention slot build and run a forward, as do the MoE and
    Mamba2 slots."""
    for arch in tconfigs.list_archs():
        for getter in (tconfigs.get_config, tconfigs.get_smoke,
                       tconfigs.get_tuned):
            assert getter(arch).name == arch
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-2")
    gen = torch.Generator().manual_seed(0)
    audio = tconfigs.get_smoke("whisper-base")
    for cfg in (audio, audio.scaled(family="encdec")):
        api = get_api(cfg)
        p = api.init_params(gen)
        batch = ttrain.batch_to(_batch(cfg, 2, 6, seed=0), "cpu")
        assert batch["frames"].shape == (2, cfg.enc_seq, cfg.enc_d_model)
        loss, _ = api.loss(p, batch)
        assert np.isfinite(float(loss))
    base = tconfigs.get_smoke("llama3.2-3b")
    cross = base.scaled(slots=(BlockSlot(cross_attn=True),))
    p = get_api(cross).init_params(gen)
    assert {"xnorm", "xq", "xk", "xv", "xo"} <= set(p["blocks"][0])
    logits, _ = tlm.forward(p, cross, torch.zeros((1, 5), dtype=torch.long),
                            enc_out=torch.randn((1, 7, cross.d_model),
                                                generator=gen))
    assert torch.isfinite(logits[..., :cross.vocab]).all()
    # the MoE and Mamba2 slots build and run
    for slot in (BlockSlot(kind="mamba"), BlockSlot(moe=True)):
        cfg = base.scaled(slots=(slot,), n_experts=4, top_k=2)
        api = get_api(cfg)
        p = api.init_params(torch.Generator().manual_seed(0))
        logits, aux = tlm.forward(p, cfg, torch.zeros((1, 5), dtype=torch.long))
        assert torch.isfinite(logits[..., :cfg.vocab]).all()
        assert (float(aux) > 0.0) == slot.moe
    with pytest.raises(ValueError):
        ModelConfig(n_layers=3, slots=(BlockSlot(), BlockSlot()))
