"""The VLM (pixtral-12b) of the torch port against the JAX package: the
config and ``get_tuned``, the synthetic batch with its patch prefix, the
forward, ``lm_loss`` and ``sample_logp`` with ``prefix_embeds``, the score
rows in ``ravel_pytree`` order, prefill and decode with a ``max_len``
that counts the prefix (against the forward and the JAX decode), the
port's ``ValueError`` where ``max_len`` leaves the prefix out beside the
reference's wrong logits there, the prefill's kernel route over the
prefix, one NGD step, one request round of the serving front (its decode
without the prefix, as the reference's) and the CLI.

fp32 SMOKE model (8 patches), JAX params carried across by
``params_from_arrays``. Tolerances (max-abs over max-abs) as
``test_torch_models.py``: 1e-4 through the trunk; the solve x at λ =
1e-2 1e-3; an NGD step's params 5e-3; decode against the teacher-forced
forward |a − b| ≤ 2e-3 + 2e-3·|b|. Logits are compared over the real
vocabulary."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import rel
from repro_torch import configs as tconfigs
from repro_torch.core.pytree import (keystr, leaves_with_path,
                                     params_from_arrays, params_to_arrays)
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as ttrain
from repro_torch.launch.trainer import build_server
from repro_torch.models import lm as tlm
from repro_torch.models.api import get_api
from repro_torch.optim import NaturalGradient
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
    from repro.models import lm as jlm
    from repro.models.api import get_api as jget_api
    from repro.optim import NaturalGradient as JNaturalGradient
except ImportError:     # the GPU machine has no JAX
    jax = None

torch.set_num_threads(1)

ARCH = "pixtral-12b"
TOL, SOLVE_TOL, PARAM_TOL, DECODE_TOL = 1e-4, 1e-3, 5e-3, 2e-3
WINDOW, SEQ, ADAPT, NEW, LAM, LR = 4, 8, 2, 3, 1e-2, 0.05


def _models(seed=0):
    """(JAX cfg, port cfg, JAX params, the same params as tensors)."""
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    jp = jax.device_get(jlm.init_params(jax.random.key(seed), jcfg))
    return jcfg, tcfg, jp, params_from_arrays(jp, device="cpu")


def _batch(n, T, seed, step=0):
    return SyntheticLM(tconfigs.get_smoke(ARCH), batch=n, seq=T,
                       seed=seed).batch_at(step)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol=DECODE_TOL) -> bool:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return bool((np.abs(a - b) <= tol + tol * np.abs(b)).all())


def test_config_get_tuned_and_batches_equal_the_reference():
    for getter in ("get_config", "get_smoke"):
        assert dataclasses.asdict(getattr(tconfigs, getter)(ARCH)) \
            == dataclasses.asdict(getattr(jconfigs, getter)(ARCH))
    for kind in ("train", "prefill", "decode"):
        assert dataclasses.asdict(tconfigs.get_tuned(ARCH, kind=kind)) \
            == dataclasses.asdict(jconfigs.get_tuned(ARCH, kind=kind))
    cfg = tconfigs.get_smoke(ARCH)
    for step in (0, 3):
        got = _batch(2, 12, seed=1, step=step)
        want = JSyntheticLM(jconfigs.get_smoke(ARCH), batch=2, seq=12,
                            seed=1).batch_at(step)
        assert sorted(got) == sorted(want) == ["inputs", "labels", "mask",
                                               "prefix_embeds"]
        for key in got:
            assert got[key].dtype == want[key].dtype
            assert np.array_equal(got[key], want[key]), (key, step)
        assert got["prefix_embeds"].shape == (2, cfg.n_patches, cfg.d_model)


def test_forward_loss_and_logp_with_the_prefix_match_jax():
    jcfg, tcfg, jp, tp = _models(seed=1)
    batch = _batch(2, 10, seed=1)
    tb = ttrain.batch_to(batch, "cpu")
    logits, _ = tlm.forward(tp, tcfg, tb["inputs"],
                            prefix_embeds=tb["prefix_embeds"])
    jlogits, _ = jax.jit(lambda p, t, e: jlm.forward(
        p, jcfg, t, prefix_embeds=e))(jp, batch["inputs"],
                                      batch["prefix_embeds"])
    V, P = tcfg.vocab, tcfg.n_patches
    assert logits.shape == (2, P + 10, tcfg.padded_vocab)
    assert rel(logits[..., :V], jlogits[..., :V]) < TOL
    loss, _ = get_api(tcfg).loss(tp, tb)
    jloss, _ = jax.jit(jget_api(jcfg).loss)(jp, batch)
    assert abs(float(loss) - float(jloss)) < TOL * abs(float(jloss))
    # the prefix moves the loss: it is not dropped
    bare, _ = get_api(tcfg).loss(tp, {k: v for k, v in tb.items()
                                      if k != "prefix_embeds"})
    assert abs(float(bare) - float(loss)) > 1e-3
    ex = {key: val[1] for key, val in tb.items()}
    lp = get_api(tcfg).sample_logp(tp, ex)
    jlp = jax.jit(jget_api(jcfg).sample_logp)(
        jp, {key: val[1] for key, val in batch.items()})
    assert abs(float(lp) - float(jlp)) < TOL * abs(float(jlp))


def test_score_rows_with_the_prefix_match_ravel_pytree():
    jcfg, tcfg, jp, tp = _models(seed=2)
    batch = _batch(3, 8, seed=2)
    scale = 1.0 / np.sqrt(6)
    loss, v, S = ttrain.make_score_grads(get_api(tcfg), scale=scale)(
        tp, batch)
    jloss, jv, jS = jax.jit(jtrain.make_score_grads(jget_api(jcfg),
                                                    scale=scale))(jp, batch)
    m = ravel_pytree(jp)[0].shape[0]
    assert S.shape == (3, m) and v.shape == (m,)
    assert abs(float(loss) - float(jloss)) < TOL * abs(float(jloss))
    assert rel(v, jv) < TOL and rel(S, jS) < TOL
    names = [keystr(path) for path, _ in leaves_with_path(tp)]
    jnames = [jax.tree_util.keystr(path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert names == jnames and "['head']" in names


def test_prefill_and_decode_with_the_prefix_match_the_forward_and_jax():
    """A prefix of 8 patches and 6 tokens, ``max_len`` = 8 + 12 + 2, then
    6 teacher-forced decode steps: each step's logits against the
    forward's (2e-3 + 2e-3·|b|) and the JAX decode's (1e-4), and the
    whole cache against JAX's."""
    jcfg, tcfg, jp, tp = _models(seed=3)
    batch = _batch(2, 12, seed=3)
    toks, pre = batch["inputs"], batch["prefix_embeds"]
    P, T0, T = tcfg.n_patches, 6, 12
    max_len = P + T + 2
    full, _ = tlm.forward(tp, tcfg, _t(toks), prefix_embeds=_t(pre))
    logits, cache, idx = get_api(tcfg).prefill(
        tp, {"tokens": _t(toks[:, :T0]), "prefix_embeds": _t(pre),
             "max_len": max_len})
    jlogits, jcache, jidx = jax.jit(lambda p, t, e: jget_api(jcfg).prefill(
        p, {"tokens": t, "prefix_embeds": e, "max_len": max_len}))(
            jp, toks[:, :T0], pre)
    jdecode = jax.jit(lambda p, c, i, t: jlm.decode_step(p, jcfg, c, i, t))
    V = tcfg.vocab
    assert idx == int(jidx) == P + T0
    assert rel(logits[..., :V], jlogits[..., :V]) < TOL
    assert _close(logits[:, -1, :V], full[:, P + T0 - 1, :V])
    for t in range(T0, T):
        logits, cache = tlm.decode_step(tp, tcfg, cache, P + t,
                                        _t(toks[:, t:t + 1]))
        jlogits, jcache = jdecode(jp, jcache, jidx + (t - T0),
                                  toks[:, t:t + 1])
        assert _close(logits[:, -1, :V], full[:, P + t, :V]), t
        assert rel(logits[..., :V], jlogits[..., :V]) < TOL, t
    for c, jc in zip(cache, jcache):
        for key in ("k", "v"):
            assert c[key].shape == jc[key].shape == (
                tcfg.repeats, 2, max_len, tcfg.n_kv_heads, tcfg.head_dim)
            assert rel(c[key], jc[key]) < TOL


def test_max_len_without_the_prefix_raises_where_the_reference_goes_wrong():
    """``api.prefill``'s default ``max_len`` is the tokens + 1, which
    leaves the prefix out. The reference then lays the P + T keys into
    T + 1 slots as a ring, and its decode writes at a clamped position:
    its logits land far from the forward's (max-abs > 0.5 at SMOKE, where
    a counted prefix lands within 1e-4). The port raises instead, naming
    ``max_len`` and the prefix."""
    jcfg, tcfg, jp, tp = _models(seed=4)
    batch = _batch(1, 10, seed=4)
    toks, pre = batch["inputs"], batch["prefix_embeds"]
    P, T0 = tcfg.n_patches, 6
    V = tcfg.vocab
    jfull, _ = jlm.forward(jp, jcfg, toks[:, :T0 + 1], prefix_embeds=pre)
    for max_len, wrong in ((None, True), (P + T0 + 1, False)):
        b = {"tokens": toks[:, :T0], "prefix_embeds": pre}
        if max_len is not None:
            b["max_len"] = max_len
        _, jcache, jidx = jget_api(jcfg).prefill(jp, b)
        jlogits, _ = jlm.decode_step(jp, jcfg, jcache, jidx,
                                     toks[:, T0:T0 + 1])
        err = float(np.abs(np.asarray(jlogits[0, -1, :V])
                           - np.asarray(jfull[0, -1, :V])).max())
        assert (err > 0.5) if wrong else (err < 1e-4), (max_len, err)
    with pytest.raises(ValueError, match="max_len.*prefix"):
        get_api(tcfg).prefill(tp, {"tokens": _t(toks[:, :T0]),
                                   "prefix_embeds": _t(pre)})
    # without a prefix the default fits, as in the reference
    logits, _, idx = get_api(tcfg).prefill(tp, {"tokens": _t(toks[:, :T0])})
    assert idx == T0 and torch.isfinite(logits[..., :V]).all()


def test_prefill_takes_the_kernel_route_over_the_prefix(monkeypatch):
    calls = []
    real = tlm.ops.flash_attention

    def spy(q, k, v, **kwargs):
        calls.append((tuple(q.shape), tuple(k.shape), kwargs["causal"]))
        return real(q, k, v, **kwargs)
    monkeypatch.setattr(tlm.ops, "flash_attention", spy)
    cfg = tconfigs.get_smoke(ARCH)
    api = get_api(cfg)
    p = api.init_params(torch.Generator().manual_seed(0))
    batch = ttrain.batch_to(_batch(2, 8, seed=5), "cpu")
    P, T = cfg.n_patches, 5
    api.prefill(p, {"tokens": batch["inputs"][:, :T],
                    "prefix_embeds": batch["prefix_embeds"],
                    "max_len": P + T + 1})
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    assert calls == [((2, P + T, H, hd), (2, P + T, KH, hd), True)] \
        * cfg.n_layers
    calls.clear()
    api.loss(p, batch)
    assert not calls


def test_ngd_train_step_with_the_prefix_matches_jax():
    jcfg, tcfg, jp, tp = _models(seed=6)
    jopt = JNaturalGradient(0.1, damping=1e-2)
    topt = NaturalGradient(0.1, damping=1e-2)
    jstep = jax.jit(jtrain.make_ngd_train_step(
        jget_api(jcfg), jopt, make_mesh((1, 1), ("data", "model"))))
    tstep = ttrain.make_ngd_train_step(get_api(tcfg), topt)
    batch = _batch(4, 8, seed=6)
    jparams = jax.tree.map(jnp.asarray, jp)
    jnew, _, jm = jstep(jparams, jopt.init(jparams), batch)
    tnew, _, tm = tstep(tp, topt.init(tp), batch)
    assert abs(float(tm["loss"]) - float(jm["loss"])) \
        < TOL * abs(float(jm["loss"]))
    got = jax.tree.leaves(params_to_arrays(tnew))
    for a, b in zip(got, jax.tree.leaves(jax.device_get(jnew))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=PARAM_TOL,
                                   atol=PARAM_TOL)
    assert any(not np.array_equal(a, b) for a, b in
               zip(got, jax.tree.leaves(jp)))


def _jax_round(jp):
    """The round composed from the JAX package: the seeded window, the
    request's score grads (with its prefix), the dual solve, the update,
    greedy prefill + decode of the prompt without the prefix (as the
    reference's ``ServeHandles.decode``)."""
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
    prompt = jnp.asarray(ex["inputs"][:1, :SEQ])
    logits, cache, idx = api.prefill(params, {"tokens": prompt,
                                              "max_len": SEQ + NEW})
    steps, toks = [logits[:, -1]], [int(jnp.argmax(logits[:, -1], -1)[0])]
    for t in range(NEW - 1):
        logits, cache = api.decode_step(params, cache, idx + t,
                                        jnp.asarray([[toks[-1]]], jnp.int32))
        steps.append(logits[:, -1])
        toks.append(int(jnp.argmax(logits[:, -1], -1)[0]))
    return {"loss": float(loss), "x": x, "rows": rows, "params": params,
            "tokens": toks, "logits": jnp.stack(steps, 1)[0]}


def test_one_request_round_matches_jax():
    jp = jax.device_get(jlm.init_params(jax.random.key(7),
                                        jconfigs.get_smoke(ARCH)))
    want = _jax_round(jp)
    cfg = tconfigs.get_smoke(ARCH)
    server, h = build_server(cfg, window=WINDOW, seq=SEQ, damping=LAM,
                             max_tokens=64, max_requests=4, refresh_every=16,
                             params=jp, device="cpu")
    seen = {}
    out = serve_trace(server, h, requests=1, window=WINDOW,
                      adapt_examples=ADAPT, seq=SEQ, decode_tokens=NEW,
                      damping=LAM, lr=LR, burst=1, keep_logits=True,
                      on_result=lambda rec, res: seen.update(x=res.x.clone()),
                      log=lambda line: None)
    (rec,) = out["records"]
    assert abs(rec["loss"] - want["loss"]) < TOL * abs(want["loss"])
    assert rel(seen["x"], want["x"]) < SOLVE_TOL
    for a, b in zip(jax.tree.leaves(params_to_arrays(h.params)),
                    jax.tree.leaves(want["params"])):
        assert rel(a, b) < TOL
    V = cfg.vocab
    assert rel(rec["logits"][..., :V], want["logits"][..., :V]) < TOL
    assert rec["tokens"] == want["tokens"]
    st = server.state
    assert (st.slot, st.stats.adapted, st.stats.served) == (ADAPT, ADAPT, 1)
    assert rel(st.S[:ADAPT], want["rows"]) < TOL


def test_cli_serves_pixtral_on_the_cpu(capsys, tmp_path):
    ck = tmp_path / "ck"
    server, losses = serve_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                                 "--requests", "6", "--burst", "3",
                                 "--ckpt-dir", str(ck)])
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert server.stats.served == 6 and server.stats.adapted == 12
    out = capsys.readouterr().out
    assert "served 6 requests" in out and out.count("tokens [") == 6
    assert "health: " in out
    assert sorted(p.name for p in ck.iterdir()) == ["step_000000002"]
