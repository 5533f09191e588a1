"""The model families this slice ports (qwen3-moe, mamba2, jamba), end to
end against the JAX package: the configs field for field, ``get_tuned``
for every architecture and kind, one request round of the LM serving
front against the same steps composed from the JAX package, one
``make_ngd_train_step`` step, the serving CLI on the CPU, the plain
products' widening of a bf16 window a column chunk at a time, and the
graph-free gradient of the train and score passes.

fp32 SMOKE models, JAX params carried across as numpy arrays. Tolerances
(max-abs over max-abs), as ``test_torch_lm_serve.py`` and
``test_torch_trainer.py``: 1e-4 for losses, scores, logits and updated
params; the solve x = (v − Sᵀw)/λ at λ = 1e-2 cancels about two digits
of v, so 1e-3; params after an NGD step ``rtol = atol = 5e-3`` (the
reference's solver tests). Logits are compared over the real vocabulary
(the padding slots hold ``NEG_INF``)."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import rel
from repro_torch import configs as tconfigs
from repro_torch.core.pytree import params_from_arrays, params_to_arrays
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as ttrain
from repro_torch.launch.trainer import build_server
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

TOL, SOLVE_TOL, PARAM_TOL = 1e-4, 1e-3, 5e-3
NEW_ARCHS = ["qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b", "mamba2-1.3b",
             "jamba-v0.1-52b"]
SERVED = ["mamba2-1.3b", "qwen3-moe-30b-a3b"]
WINDOW, SEQ, ADAPT, NEW, LAM, LR = 4, 8, 2, 3, 1e-2, 0.05


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_equal_the_reference(arch):
    for getter in ("get_config", "get_smoke"):
        t = dataclasses.asdict(getattr(tconfigs, getter)(arch))
        j = dataclasses.asdict(getattr(jconfigs, getter)(arch))
        assert t == j, (arch, getter)
    assert arch in tconfigs.ARCHS and not hasattr(tconfigs, "LATER")
    assert sorted(tconfigs.ARCHS) == jconfigs.list_archs()


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_get_tuned_matches_the_reference(kind):
    """Every architecture of the reference, whisper and pixtral among
    them: the same levers on the same config."""
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for arch in jconfigs.list_archs():
        t = dataclasses.asdict(tconfigs.get_tuned(arch, kind=kind))
        j = dataclasses.asdict(jconfigs.get_tuned(arch, kind=kind))
        assert t == j, (arch, kind)
    ssm = tconfigs.get_tuned("mamba2-1.3b", kind=kind)
    assert ssm.ssd_factored and ssm.ssd_bf16
    assert tconfigs.get_tuned("qwen3-moe-30b-a3b", kind=kind).attn_bf16 \
        == (kind == "train")
    for arch in ("whisper-base", "pixtral-12b"):
        assert tconfigs.get_tuned(arch, kind=kind).attn_bf16


# ---------------------------------------------------------------------------
# the serving front and the trainer
# ---------------------------------------------------------------------------

def _jax_round(arch, jp):
    """The round composed from the JAX package: seeded window, the
    request's score grads, the dual solve against the window, the update,
    greedy prefill + decode."""
    jcfg = jconfigs.get_smoke(arch)
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
    logits, cache, idx = jax.jit(lambda p, t: jlm.prefill(
        p, jcfg, t, max_len=SEQ + NEW))(params, prompt)
    decode = jax.jit(lambda p, c, i, t: jlm.decode_step(p, jcfg, c, i, t))
    steps, toks = [logits[:, -1]], [int(jnp.argmax(logits[:, -1], -1)[0])]
    for t in range(NEW - 1):
        logits, cache = decode(params, cache, idx + t,
                               jnp.asarray([[toks[-1]]], jnp.int32))
        steps.append(logits[:, -1])
        toks.append(int(jnp.argmax(logits[:, -1], -1)[0]))
    return {"loss": float(loss), "x": x, "rows": rows, "params": params,
            "tokens": toks, "logits": jnp.stack(steps, 1)[0]}


@pytest.mark.parametrize("arch", SERVED)
def test_one_request_round_matches_jax(arch):
    jp = jlm.init_params(jax.random.key(4), jconfigs.get_smoke(arch))
    want = _jax_round(arch, jp)
    cfg = tconfigs.get_smoke(arch)
    server, h = build_server(cfg, window=WINDOW, seq=SEQ, damping=LAM,
                             max_tokens=64, max_requests=4, refresh_every=16,
                             params=jax.device_get(jp), device="cpu")
    seen = {}
    out = serve_trace(server, h, requests=1, window=WINDOW,
                      adapt_examples=ADAPT, seq=SEQ, decode_tokens=NEW,
                      damping=LAM, lr=LR, burst=1, keep_logits=True,
                      on_result=lambda rec, res: seen.update(x=res.x.clone()),
                      log=lambda line: None)
    (rec,) = out["records"]
    assert abs(rec["loss"] - want["loss"]) < TOL * abs(want["loss"])
    assert rel(seen["x"], want["x"]) < SOLVE_TOL
    got_p = jax.tree.leaves(params_to_arrays(h.params))
    for a, b in zip(got_p, jax.tree.leaves(want["params"])):
        assert rel(a, b) < TOL
    V = cfg.vocab
    assert rel(rec["logits"][..., :V], want["logits"][..., :V]) < TOL
    assert rec["tokens"] == want["tokens"]
    st = server.state
    assert (st.slot, st.stats.adapted, st.stats.served) == (ADAPT, ADAPT, 1)
    assert rel(st.S[:ADAPT], want["rows"]) < TOL


@pytest.mark.parametrize("arch", SERVED)
def test_ngd_train_step_matches_jax(arch):
    """One exact dense NGD step at λ = 1e-2: the loss (the MoE's with its
    aux loss) and every updated param."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp = jax.device_get(jget_api(jcfg).init_params(jax.random.key(5)))
    jopt = JNaturalGradient(0.1, damping=1e-2)
    topt = NaturalGradient(0.1, damping=1e-2)
    jstep = jax.jit(jtrain.make_ngd_train_step(
        jget_api(jcfg), jopt, make_mesh((1, 1), ("data", "model"))))
    tstep = ttrain.make_ngd_train_step(get_api(tcfg), topt)
    batch = JSyntheticLM(jcfg, batch=4, seq=16, seed=5).batch_at(0)
    tbatch = SyntheticLM(tcfg, batch=4, seq=16, seed=5).batch_at(0)
    assert all(np.array_equal(batch[k], tbatch[k]) for k in batch)
    jparams = jax.tree.map(jnp.asarray, jp)
    jnew, _, jm = jstep(jparams, jopt.init(jparams), batch)
    tp = params_from_arrays(jp, device="cpu")
    tnew, _, tm = tstep(tp, topt.init(tp), tbatch)
    assert abs(float(tm["loss"]) - float(jm["loss"])) \
        < TOL * abs(float(jm["loss"]))
    got = jax.tree.leaves(params_to_arrays(tnew))
    want = jax.tree.leaves(jax.device_get(jnew))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=PARAM_TOL,
                                   atol=PARAM_TOL)
    assert any(not np.array_equal(a, b) for a, b in
               zip(got, jax.tree.leaves(jp)))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-1.3b",
                                  "jamba-v0.1-52b"])
def test_cli_serves_the_family_on_the_cpu(arch, capsys, tmp_path):
    """``python -m repro_torch.serve --arch … --smoke`` at a short trace:
    every request served with a finite loss, the window adapted, the
    health verdict and an exit checkpoint."""
    ck = tmp_path / "ck"
    server, losses = serve_main(["--arch", arch, "--smoke", "--device", "cpu",
                                 "--requests", "3", "--window", "4",
                                 "--seq", "8", "--decode-tokens", "2",
                                 "--burst", "2", "--ckpt-dir", str(ck)])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert server.stats.served == 3 and server.stats.adapted == 6
    out = capsys.readouterr().out
    assert "served 3 requests" in out and out.count("tokens [") == 3
    assert "health: " in out
    assert sorted(p.name for p in ck.iterdir()) == ["step_000000002"]


def test_bf16_window_is_widened_a_column_chunk_at_a_time(monkeypatch):
    """qwen3-moe's 19.94 GB bf16 window must never be copied whole to fp32:
    the plain products (u = S·v, Sᵀw, the fold's cross columns) widen it
    a column chunk at a time, and agree with the one-product results to
    fp32 rounding (the chunks' partial sums are added in order)."""
    from repro_torch.core import chol_factorize, solvers
    from repro_torch.kernels import ref
    rng = np.random.default_rng(9)
    S = torch.from_numpy(rng.normal(size=(6, 1000)).astype(np.float32)
                         ).to(torch.bfloat16)
    V = torch.from_numpy(rng.normal(size=(1000, 3)).astype(np.float32))
    rows = torch.from_numpy(rng.normal(size=(2, 1000)).astype(np.float32)
                            ).to(torch.bfloat16)
    f32 = chol_factorize(S.float(), 1e-2)
    # a resident bf16 window, as SolveServer holds it
    fac = solvers.CholFactorization(S=S, mode="real", W=f32.W, L=f32.L,
                                    lam=f32.lam, jitter=0.0,
                                    take_real_v=False)
    whole_x = fac.solve_batch(V, [1e-2, 4e-2, 1e-2])
    whole_c = ref.fold_cols_ref(S, rows)
    assert solvers._upcast_chunks(S, torch.float32) == [(0, 1000)]
    monkeypatch.setattr(solvers, "UPCAST_CHUNK", 300)
    assert solvers._upcast_chunks(S, torch.float32) == [
        (0, 300), (300, 600), (600, 900), (900, 1000)]
    assert solvers._upcast_chunks(S.float(), torch.float32) == [(0, 1000)]
    x = fac.solve_batch(V, [1e-2, 4e-2, 1e-2])
    cols, corner = ref.fold_cols_ref(S, rows)
    assert rel(x, whole_x) < 1e-5
    assert rel(cols, whole_c[0]) < 1e-6 and rel(corner, whole_c[1]) < 1e-6


def test_graph_free_gradient_matches_torch_func():
    """The train and score passes' gradient (``optim.scores.
    grad_and_value``: a vjp whose backward records no graph) equals
    ``torch.func.grad_and_value``'s to fp32 rounding, for the mean
    gradient of ``lm_loss`` and under ``vmap`` for the score rows, on each
    decoder family."""
    from repro_torch.core.pytree import leaves
    from repro_torch.optim.scores import grad_and_value
    for arch in ["llama3.2-3b"] + NEW_ARCHS[::2]:
        cfg = tconfigs.get_smoke(arch)
        api = get_api(cfg)
        p = api.init_params(torch.Generator().manual_seed(0))
        b = ttrain.batch_to(SyntheticLM(cfg, batch=3, seq=16,
                                        seed=0).batch_at(1), "cpu")
        g, (loss, aux) = grad_and_value(api.loss, has_aux=True)(p, b)
        g0, (loss0, aux0) = torch.func.grad_and_value(api.loss,
                                                      has_aux=True)(p, b)
        assert float(loss) == float(loss0) and aux.keys() == aux0.keys()
        assert all(rel(a, c) < 1e-5 and a.grad_fn is None
                   for a, c in zip(leaves(g), leaves(g0))), arch
        rows = torch.func.vmap(lambda q, ex: grad_and_value(
            api.sample_logp)(q, ex)[0], in_dims=(None, 0))(p, b)
        rows0 = torch.func.vmap(torch.func.grad(api.sample_logp),
                                in_dims=(None, 0))(p, b)
        assert all(rel(a, c) < 1e-5 for a, c in zip(leaves(rows),
                                                    leaves(rows0))), arch
