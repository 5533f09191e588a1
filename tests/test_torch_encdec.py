"""The encoder-decoder trunk (whisper-base) of the torch port against the
JAX package: the config and ``get_tuned``, ``encoder_cfg`` and
``sinusoidal_pos``, ``encode`` / ``loss`` / its gradient /
``sample_logp``, the score rows in ``ravel_pytree`` order (``dec`` <
``enc_blocks`` < ``enc_final_norm``), prefill (logits and the k, v, ck,
cv caches), decode against the forward and against the JAX decode, the
clamped learned position past 448 (32 at SMOKE), the prefill's attention
routes, one NGD step, one request round of the serving front with decode
off, and the CLI with decode off and on (the reference's ``KeyError:
'frames'``: its serving decode passes no frames).

fp32 SMOKE model, JAX params carried across by ``params_from_arrays``.
Tolerances (max-abs over max-abs): 1e-5 for the encoder, the loss, its
gradient and log P (fp32 sums in another order through 2 + 2 layers);
1e-4 for the score rows, logits and caches (as ``test_torch_models.py``);
the solve x at λ = 1e-2 1e-3; an NGD step's params 5e-3 (the solver
tests'); decode against the teacher-forced forward |a − b| ≤ 2e-3 +
2e-3·|b| (``tests/test_archs.py test_decode_matches_forward``). Logits
are compared over the real vocabulary (the padded slots hold NEG_INF)."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import rel
from repro_torch import configs as tconfigs
from repro_torch.core.pytree import (keystr, leaves, leaves_with_path,
                                     params_from_arrays, params_to_arrays)
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as ttrain
from repro_torch.launch.trainer import build_server
from repro_torch.models import encdec as ted
from repro_torch.models import lm as tlm
from repro_torch.models.api import get_api
from repro_torch.optim import NaturalGradient
from repro_torch.optim.scores import grad_and_value
from repro_torch.serve.main import serve_main, serve_trace

try:
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree
    from repro import configs as jconfigs
    from repro.core.solvers import chol_solve as jchol_solve
    from repro.data import SyntheticLM as JSyntheticLM
    from repro.launch import train as jtrain
    from repro.launch.mesh import make_mesh
    from repro.models import encdec as jed
    from repro.models import lm as jlm
    from repro.models.api import get_api as jget_api
    from repro.optim import NaturalGradient as JNaturalGradient
except ImportError:     # the GPU machine has no JAX
    jax = None

torch.set_num_threads(1)

ARCH = "whisper-base"
ENC_TOL, TOL, SOLVE_TOL, PARAM_TOL, DECODE_TOL = 1e-5, 1e-4, 1e-3, 5e-3, 2e-3
WINDOW, SEQ, ADAPT, LAM, LR = 4, 8, 2, 1e-2, 0.05
# the reference's SMOKE window: m = 183,808 parameters
SMOKE_M = 183_808


def _models(seed=0):
    """(JAX cfg, port cfg, JAX params, the same params as tensors)."""
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    jp = jax.device_get(jed.init_params(jax.random.key(seed), jcfg))
    return jcfg, tcfg, jp, params_from_arrays(jp, device="cpu")


def _batch(n, T, seed, step=0):
    return SyntheticLM(tconfigs.get_smoke(ARCH), batch=n, seq=T,
                       seed=seed).batch_at(step)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol=DECODE_TOL) -> bool:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return bool((np.abs(a - b) <= tol + tol * np.abs(b)).all())


# ---------------------------------------------------------------------------
# configs, encoder
# ---------------------------------------------------------------------------

def test_config_and_get_tuned_equal_the_reference():
    for getter in ("get_config", "get_smoke"):
        assert dataclasses.asdict(getattr(tconfigs, getter)(ARCH)) \
            == dataclasses.asdict(getattr(jconfigs, getter)(ARCH))
    for kind in ("train", "prefill", "decode"):
        t = tconfigs.get_tuned(ARCH, kind=kind)
        assert dataclasses.asdict(t) == dataclasses.asdict(
            jconfigs.get_tuned(ARCH, kind=kind))
        assert t.attn_bf16 and t.attn_seq_shard


def test_encoder_cfg_and_sinusoidal_pos_match_jax():
    for getter in ("get_config", "get_smoke"):
        t = ted.encoder_cfg(getattr(tconfigs, getter)(ARCH))
        j = jed.encoder_cfg(getattr(jconfigs, getter)(ARCH))
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.slots[0].bidirectional and t.pos_embed == "sinusoidal"
        assert t.head_dim == t.d_model // t.n_heads and t.n_kv_heads \
            == t.n_heads
    for T, d in ((16, 64), (7, 6)):
        got = ted.sinusoidal_pos(T, d)
        want = jed.sinusoidal_pos(T, d)
        assert got.shape == (T, d) and rel(got, want) < 1e-6, (T, d)
    # whisper's 1,500 frames: torch's fp32 pow and XLA's differ by an ulp
    # in a few of the 256 powers, which moves an angle of up to 1,499 rad
    # by ≈ 1.2e-4 (its own fp32 ulp): two ulps of the largest angle
    got, want = ted.sinusoidal_pos(1500, 512), jed.sinusoidal_pos(1500, 512)
    assert float((got - _t(want)).abs().max()) < 2.5e-4
    assert ted.sinusoidal_pos(5, 8, torch.bfloat16).dtype == torch.bfloat16


def test_encode_loss_and_logp_match_jax():
    jcfg, tcfg, jp, tp = _models(seed=1)
    batch = _batch(2, 12, seed=1)
    tb = ttrain.batch_to(batch, "cpu")
    got = ted.encode(tp, tcfg, tb["frames"])
    want = jax.jit(lambda p, f: jed.encode(p, jcfg, f))(jp, batch["frames"])
    assert got.shape == (2, tcfg.enc_seq, tcfg.enc_d_model)
    assert rel(got, want) < ENC_TOL
    loss, metrics = get_api(tcfg).loss(tp, tb)
    jloss, jm = jax.jit(lambda p, b: jed.loss(p, jcfg, b))(jp, batch)
    assert abs(float(loss) - float(jloss)) < ENC_TOL * abs(float(jloss))
    assert float(metrics["nll"]) == float(loss)
    for i in range(2):
        ex = {key: val[i] for key, val in tb.items()}
        lp = get_api(tcfg).sample_logp(tp, ex)
        jlp = jax.jit(jget_api(jcfg).sample_logp)(
            jp, {key: val[i] for key, val in batch.items()})
        assert abs(float(lp) - float(jlp)) < ENC_TOL * abs(float(jlp)), i


def test_loss_gradient_matches_jax():
    jcfg, tcfg, jp, tp = _models(seed=2)
    batch = _batch(2, 10, seed=2)
    grads, (loss, _) = grad_and_value(get_api(tcfg).loss, has_aux=True)(
        tp, ttrain.batch_to(batch, "cpu"))
    jgrads = jax.jit(jax.grad(lambda p, b: jed.loss(p, jcfg, b)[0]))(
        jp, batch)
    got, want = leaves(grads), jax.tree.leaves(jgrads)
    assert len(got) == len(want) == 32
    flat = torch.cat([g.reshape(-1) for g in got])
    assert rel(flat, ravel_pytree(jgrads)[0]) < ENC_TOL
    # every leaf moves: the encoder's too (through the cross-attention)
    assert all(float(g.abs().max()) > 0 for g in got)


def test_score_rows_match_ravel_pytree():
    """``make_score_grads``: loss, v and the score rows S, columns in
    ``ravel_pytree`` order: ``dec`` < ``enc_blocks`` < ``enc_final_norm``."""
    jcfg, tcfg, jp, tp = _models(seed=3)
    batch = _batch(3, 8, seed=3)
    scale = 1.0 / np.sqrt(6)
    loss, v, S = ttrain.make_score_grads(get_api(tcfg), scale=scale)(
        tp, batch)
    jloss, jv, jS = jax.jit(jtrain.make_score_grads(jget_api(jcfg),
                                                    scale=scale))(jp, batch)
    assert S.shape == (3, SMOKE_M) and v.shape == (SMOKE_M,)
    assert abs(float(loss) - float(jloss)) < TOL * abs(float(jloss))
    assert rel(v, jv) < TOL and rel(S, jS) < TOL
    names = [keystr(path) for path, _ in leaves_with_path(tp)]
    jnames = [jax.tree_util.keystr(path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert names == jnames
    tops = [n.split("]")[0] + "]" for n in names]
    assert tops.index("['enc_blocks']") > tops.index("['dec']")
    assert tops[-1] == "['enc_final_norm']"


def test_init_params_and_cache_shapes_match_jax():
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    api = get_api(tcfg)
    tp = api.init_params(torch.Generator().manual_seed(0))
    jshapes = jax.tree.map(lambda x: (x.shape, str(x.dtype)),
                           jed.param_specs(jcfg))
    tshapes = jax.tree.map(lambda x: (tuple(x.shape),
                                      str(x.dtype).removeprefix("torch.")),
                           tp)
    assert jax.tree.structure(jshapes) == jax.tree.structure(tshapes)
    assert jax.tree.leaves(jshapes) == jax.tree.leaves(tshapes)
    assert sum(t.numel() for t in leaves(tp)) == SMOKE_M
    cache = api.init_cache(2, 12)
    jcache = jget_api(jcfg).init_cache(2, 12)
    assert [{k: tuple(t.shape) for k, t in c.items()} for c in cache] \
        == [{k: tuple(t.shape) for k, t in c.items()} for c in jcache]
    assert cache[0]["ck"].shape == (tcfg.repeats, 2, tcfg.enc_seq,
                                    tcfg.n_kv_heads, tcfg.head_dim)
    assert all(not t.any() for c in cache for t in c.values())


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

def test_prefill_logits_and_caches_match_jax():
    jcfg, tcfg, jp, tp = _models(seed=4)
    batch = _batch(2, 12, seed=4)
    frames, prompt = batch["frames"], batch["inputs"][:, :9]
    logits, cache, idx = get_api(tcfg).prefill(
        tp, {"frames": _t(frames), "tokens": _t(prompt), "max_len": 14})
    jlogits, jcache, jidx = jax.jit(lambda p, f, t: jget_api(jcfg).prefill(
        p, {"frames": f, "tokens": t, "max_len": 14}))(jp, frames, prompt)
    V = tcfg.vocab
    assert idx == int(jidx) == 9
    assert rel(logits[..., :V], jlogits[..., :V]) < TOL
    for c, jc in zip(cache, jcache):
        assert sorted(c) == sorted(jc) == ["ck", "cv", "k", "v"]
        for key in c:
            assert c[key].shape == jc[key].shape, key
            assert rel(c[key], jc[key]) < TOL, key


def test_decode_matches_the_forward_and_jax():
    """Prefill of 6 tokens, then 6 teacher-forced decode steps: each
    step's logits against the forward's at its position (2e-3 + 2e-3·|b|)
    and against the JAX package's decode (1e-4)."""
    jcfg, tcfg, jp, tp = _models(seed=5)
    batch = _batch(2, 12, seed=5)
    frames, toks = _t(batch["frames"]), _t(batch["inputs"])
    P, T = 6, 12
    enc = ted.encode(tp, tcfg, frames)
    full, _ = tlm.forward(tp["dec"], tcfg, toks, enc_out=enc)
    logits, cache, idx, _ = ted.prefill(tp, tcfg, frames, toks[:, :P],
                                        max_len=T)
    jlogits, jcache, jidx, _ = jax.jit(lambda p, f, t: jed.prefill(
        p, jcfg, f, t, max_len=T))(jp, batch["frames"], batch["inputs"][:, :P])
    jdecode = jax.jit(lambda p, c, i, t: jed.decode_step(p, jcfg, c, i, t))
    V = tcfg.vocab
    assert _close(logits[:, -1, :V], full[:, P - 1, :V])
    for t in range(P, T):
        logits, cache = ted.decode_step(tp, tcfg, cache, t, toks[:, t:t + 1])
        jlogits, jcache = jdecode(jp, jcache, jidx + (t - P),
                                  batch["inputs"][:, t:t + 1])
        assert _close(logits[:, -1, :V], full[:, t, :V]), t
        assert rel(logits[..., :V], jlogits[..., :V]) < TOL, t
    assert idx == P


def test_learned_position_past_the_table_is_clamped_as_in_jax():
    """SMOKE's max_target_positions is 32: decode steps at positions 28 …
    35 read row 31 from position 31 on, as JAX's clamped index does."""
    jcfg, tcfg, jp, tp = _models(seed=6)
    frames = _batch(1, 8, seed=6)["frames"]
    P, T = 28, 36
    toks = np.random.default_rng(6).integers(3, tcfg.vocab, (1, T)).astype(
        np.int32)
    _, cache, idx, _ = ted.prefill(tp, tcfg, _t(frames), _t(toks[:, :P]),
                                   max_len=T)
    _, jcache, jidx, _ = jax.jit(lambda p, f, t: jed.prefill(
        p, jcfg, f, t, max_len=T))(jp, frames, toks[:, :P])
    jdecode = jax.jit(lambda p, c, i, t: jed.decode_step(p, jcfg, c, i, t))
    V = tcfg.vocab
    for t in range(P, T):
        logits, cache = ted.decode_step(tp, tcfg, cache, t,
                                        _t(toks[:, t:t + 1]))
        jlogits, jcache = jdecode(jp, jcache, jnp.asarray(t),
                                  toks[:, t:t + 1])
        assert torch.isfinite(logits[..., :V]).all()
        assert rel(logits[..., :V], jlogits[..., :V]) < TOL, t
    with pytest.raises(ValueError, match="max_len"):
        ted.decode_step(tp, tcfg, cache, T, _t(toks[:, :1]))


@pytest.mark.parametrize("attn_bf16", [False, True])
def test_prefill_attention_routes(attn_bf16, monkeypatch):
    """A prefill takes the flash kernel route for the encoder's
    bidirectional layers, the decoder's self-attention and its
    cross-attention (2 + 2 + 2 at SMOKE); with ``attn_bf16`` on the fp32
    model only the cross-attention (which the reference never rounds)
    stays on it. ``loss`` and ``sample_logp`` stay blockwise."""
    calls = []
    real = tlm.ops.flash_attention

    def spy(q, k, v, **kwargs):
        calls.append((q.shape[1], k.shape[1], kwargs["causal"]))
        return real(q, k, v, **kwargs)
    monkeypatch.setattr(tlm.ops, "flash_attention", spy)
    cfg = tconfigs.get_smoke(ARCH).scaled(attn_bf16=attn_bf16)
    api = get_api(cfg)
    p = api.init_params(torch.Generator().manual_seed(0))
    batch = ttrain.batch_to(_batch(2, 8, seed=7), "cpu")
    api.prefill(p, {"frames": batch["frames"], "tokens": batch["inputs"][:, :5],
                    "max_len": 8})
    Te = cfg.enc_seq
    cross = [(5, Te, False)] * cfg.n_layers
    if attn_bf16:
        assert calls == cross
    else:
        assert calls == [(Te, Te, False)] * cfg.enc_layers \
            + [(5, 5, True), (5, Te, False)] * cfg.n_layers
    calls.clear()
    api.loss(p, batch)
    api.sample_logp(p, {k: v[0] for k, v in batch.items()})
    assert not calls


# ---------------------------------------------------------------------------
# the trainer, the serving front and the CLI
# ---------------------------------------------------------------------------

def test_ngd_train_step_matches_jax():
    """One exact dense NGD step at λ = 1e-2: the loss and every updated
    param, the encoder's included."""
    jcfg, tcfg, jp, tp = _models(seed=8)
    jopt = JNaturalGradient(0.1, damping=1e-2)
    topt = NaturalGradient(0.1, damping=1e-2)
    jstep = jax.jit(jtrain.make_ngd_train_step(
        jget_api(jcfg), jopt, make_mesh((1, 1), ("data", "model"))))
    tstep = ttrain.make_ngd_train_step(get_api(tcfg), topt)
    batch = JSyntheticLM(jcfg, batch=4, seq=8, seed=8).batch_at(0)
    tbatch = _batch(4, 8, seed=8)
    assert sorted(batch) == sorted(tbatch) == ["frames", "inputs", "labels",
                                               "mask"]
    assert all(np.array_equal(batch[k], tbatch[k]) for k in batch)
    jparams = jax.tree.map(jnp.asarray, jp)
    jnew, _, jm = jstep(jparams, jopt.init(jparams), batch)
    tnew, _, tm = tstep(tp, topt.init(tp), tbatch)
    assert abs(float(tm["loss"]) - float(jm["loss"])) \
        < TOL * abs(float(jm["loss"]))
    got = jax.tree.leaves(params_to_arrays(tnew))
    want = jax.tree.leaves(jax.device_get(jnew))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=PARAM_TOL,
                                   atol=PARAM_TOL)
    moved = [not np.array_equal(a, b) for a, b in zip(got, jax.tree.leaves(jp))]
    assert moved[-1] and any(moved[:8])     # enc_final_norm and the decoder


def _jax_round(jp):
    """The round composed from the JAX package, decode off: the seeded
    window, the request's score grads, the dual solve, the update."""
    jcfg = jconfigs.get_smoke(ARCH)
    api = jget_api(jcfg)
    data = JSyntheticLM(jcfg, batch=WINDOW, seq=SEQ, seed=0)
    score = jax.jit(jtrain.make_score_grads(api, scale=1.0 / np.sqrt(WINDOW)))
    S0 = score(jp, data.batch_at(0))[2]
    take = np.sort(np.random.default_rng(0).choice(WINDOW, size=ADAPT,
                                                   replace=False))
    ex = jax.tree.map(lambda x: x[take], data.batch_at(1))
    loss, v, rows = score(jp, ex)
    x = jax.jit(jchol_solve)(S0, v, LAM)
    _, unravel = ravel_pytree(jp)
    params = jax.tree.map(lambda p, d: (p - LR * d.astype(p.dtype)
                                        ).astype(p.dtype), jp, unravel(x))
    loss_after = jax.jit(api.loss)(params, ex)[0]
    return {"loss": float(loss), "x": x, "rows": rows, "S0": S0,
            "params": params, "loss_after": float(loss_after)}


def test_one_request_round_matches_jax():
    jp = jax.device_get(jed.init_params(jax.random.key(9),
                                        jconfigs.get_smoke(ARCH)))
    want = _jax_round(jp)
    server, h = build_server(tconfigs.get_smoke(ARCH), window=WINDOW, seq=SEQ,
                             damping=LAM, max_tokens=64, max_requests=4,
                             refresh_every=16, params=jp, device="cpu")
    assert rel(server.state.S, want["S0"]) < TOL
    seen = {}
    out = serve_trace(server, h, requests=1, window=WINDOW,
                      adapt_examples=ADAPT, seq=SEQ, decode_tokens=0,
                      damping=LAM, lr=LR, burst=1,
                      on_result=lambda rec, res: seen.update(x=res.x.clone()),
                      log=lambda line: None)
    (rec,) = out["records"]
    assert abs(rec["loss"] - want["loss"]) < TOL * abs(want["loss"])
    assert rel(seen["x"], want["x"]) < SOLVE_TOL
    for a, b in zip(jax.tree.leaves(params_to_arrays(h.params)),
                    jax.tree.leaves(want["params"])):
        assert rel(a, b) < TOL
    take = np.sort(np.random.default_rng(0).choice(WINDOW, size=ADAPT,
                                                   replace=False))
    ex = {key: val[take] for key, val in h.data.batch_at(1).items()}
    assert rec["tokens"] == [] and "decode_ms" not in rec
    st = server.state
    assert (st.slot, st.stats.adapted, st.stats.served) == (ADAPT, ADAPT, 1)
    assert rel(st.S[:ADAPT], want["rows"]) < TOL
    assert abs(h.loss(ex) - want["loss_after"]) < TOL * abs(want["loss_after"])


def test_cli_serves_whisper_with_decode_off(capsys, tmp_path):
    """``python -m repro_torch.serve --arch whisper-base --smoke
    --decode-tokens 0`` at the reference's defaults otherwise: 12
    requests on a window of m = 183,808, as the reference serves them."""
    ck = tmp_path / "ck"
    server, losses = serve_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                                 "--decode-tokens", "0", "--ckpt-dir",
                                 str(ck)])
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert server.stats.served == 12 and server.stats.adapted == 24
    out = capsys.readouterr().out
    assert f"n=8 m={SMOKE_M} " in out and "served 12 requests" in out
    assert "health: " in out and "tokens [" not in out
    assert sorted(p.name for p in ck.iterdir()) == ["step_000000004"]


def test_cli_decode_raises_keyerror_frames_as_the_reference(tmp_path):
    """The reference's serving decode passes ``api.prefill`` only the
    tokens and ``max_len`` (``repro/launch/trainer.py:163``), and whisper's
    prefill needs ``batch["frames"]``: both packages raise there."""
    with pytest.raises(KeyError, match="frames"):
        serve_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--requests", "1", "--burst", "1", "--ckpt-dir",
                    str(tmp_path / "ck")])
