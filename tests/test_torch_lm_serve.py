"""The LM serving front of the torch port: one request round of the slice
— score grads → the port's ``SolveServer`` → ``apply_update`` → greedy
decode — against the same steps composed from the JAX package's
functions, the CLI on the CPU, and the flags and options that come with
later slices.

fp32 SMOKE model, JAX params carried across as numpy arrays. Tolerances
(max-abs over max-abs): 1e-4 for losses, scores, logits and the updated
params (fp32 sums in another order through a two-layer trunk); the solve
x = (v − Sᵀw)/λ at λ = 1e-2 cancels about two digits of v, so 1e-3."""
import inspect

import numpy as np
import pytest
import torch

from _torch_parity import rel
from repro_torch import configs as tconfigs
from repro_torch.core.pytree import params_to_arrays
from repro_torch.launch import trainer as trainer_mod
from repro_torch.launch.trainer import build_server
from repro_torch.obs import FlightRecorder, HealthMonitor, MetricsRegistry
from repro_torch.serve import OnlineAdaptation, SolveServer, init_serve_state
from repro_torch.serve.main import (_later_flags, _parser, serve_main,
                                    serve_trace)

try:
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree
    from repro import configs as jconfigs
    from repro.core.solvers import chol_solve as jchol_solve
    from repro.data import SyntheticLM as JSyntheticLM
    from repro.launch import train as jtrain
    from repro.models import lm as jlm
    from repro.models.api import get_api as jget_api
except ImportError:     # the GPU machine has no JAX
    jax = None

torch.set_num_threads(1)

TOL, SOLVE_TOL = 1e-4, 1e-3
ARCH, WINDOW, SEQ, ADAPT, NEW, LAM, LR = "llama3.2-3b", 4, 8, 2, 3, 1e-2, 0.05


def _jax_round(jp):
    """The round composed from the JAX package: seeded window, the
    request's score grads, the dual solve against the window, the update,
    greedy prefill + decode."""
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


def test_one_request_round_matches_jax():
    jp = jlm.init_params(jax.random.key(4), jconfigs.get_smoke(ARCH))
    want = _jax_round(jp)
    server, h = build_server(tconfigs.get_smoke(ARCH), window=WINDOW, seq=SEQ,
                             damping=LAM, max_tokens=64, max_requests=4,
                             refresh_every=16, params=jax.device_get(jp),
                             device="cpu")
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
    assert rel(rec["logits"], want["logits"]) < TOL
    assert rec["tokens"] == want["tokens"]
    # the request's rows folded into the window's first FIFO slots
    st = server.state
    assert (st.slot, st.stats.adapted, st.stats.served) == (ADAPT, ADAPT, 1)
    assert rel(st.S[:ADAPT], want["rows"]) < TOL
    for key in ("score_ms", "flush_ms", "apply_ms", "decode_ms", "solve_ms"):
        assert rec[key] >= 0.0


def test_cli_serves_on_the_cpu(capsys, tmp_path):
    ck = tmp_path / "ck"
    server, losses = serve_main(["--arch", "gemma2-2b", "--device", "cpu",
                                 "--requests", "3", "--window", "4",
                                 "--seq", "8", "--decode-tokens", "2",
                                 "--burst", "2", "--ckpt-dir", str(ck)])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert server.stats.served == 3 and server.stats.adapted == 6
    out = capsys.readouterr().out
    assert "served 3 requests" in out and out.count("tokens [") == 3
    # the reference's defaults: the audit every 4 maintenance passes, the
    # health verdict, and an exit checkpoint of the 2 rounds
    assert "health: ok" in out
    assert server.adaptation.audit_every == 4
    assert sorted(p.name for p in ck.iterdir()) == ["step_000000002"]


# the cases keep the ids they had before the checkpoint and observability
# flags left this list; --tenants (flag3) is ported (A5) and checked at
# the parser: it parses and asks for no later slice (the tenant flag since
# A5, the async and mesh flags since A7: tests/test_torch_serve_mesh.py
# serves with them); the fleet's flags still raise, naming A8
@pytest.mark.parametrize("flag", [
    ["--fleet", "2"], ["--async"], ["--mesh", "1d"], ["--tenants", "4"],
    ["--mesh-shape", "1,2"], ["--no-reconcile"]],
    ids=["flag0", "flag1", "flag2", "flag3", "flag12", "flag13"])
def test_later_flags_raise(flag):
    if flag[0] not in ("--fleet", "--no-reconcile"):
        args = _parser().parse_args(flag)
        dest = flag[0].lstrip("-").replace("-", "_")
        got = getattr(args, "async_" if dest == "async" else dest)
        assert str(got) == (flag[1] if len(flag) > 1 else "True")
        assert not any(asked for asked, _ in _later_flags(args).values())
        return
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        serve_main(["--device", "cpu"] + flag)


@pytest.mark.parametrize("flag", [
    ["--ckpt-every", "8"], ["--metrics-port", "0"], ["--trace-out", "t.json"],
    ["--profile-dir", "p"], ["--audit-every", "4"], ["--health-port", "0"],
    ["--record-dir", "r"], ["--metrics-snapshot", "m.json"]])
def test_ported_serve_flags_are_not_refused(flag):
    """The checkpoint and observability flags parse and ask for no later
    slice (checked at the parser: nothing is built or served)."""
    args = _parser().parse_args(flag)
    dest = flag[0].lstrip("-").replace("-", "_")
    assert str(getattr(args, dest)) == flag[1]
    assert not any(asked for asked, _ in _later_flags(args).values())


@pytest.mark.parametrize("option", [
    {"layout": "1d"}, {"async_": True}, {"tenant_rank": 2}])
def test_later_server_options_raise(option):
    """Every option of build_server is ported (tenant_rank since A5,
    layout and async_ since A7; tests/test_torch_tenant_serve.py and
    tests/test_torch_serve_mesh.py build with them): none asks for a
    later slice, and a layout without the async server raises the
    reference's ValueError."""
    assert set(option) <= set(inspect.signature(build_server).parameters)
    assert not hasattr(trainer_mod, "_LATER")
    if "layout" in option:
        with pytest.raises(ValueError, match="async"):
            build_server(tconfigs.get_smoke(ARCH), window=4, seq=8,
                         device="cpu", **option)


def _small_state():
    S = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 32)).astype(np.float32))
    return init_serve_state(S, 0.1, device="cpu")


@pytest.mark.parametrize("option", ["audit_every", "registry", "recorder"])
def test_ported_server_options_construct(option, tmp_path):
    """``build_server``'s audit, registry and recorder options construct
    the reference's objects (nothing is built or served)."""
    if option == "audit_every":
        ad = OnlineAdaptation(audit_every=4)
        assert (ad.audit_every, ad.audit_probes, ad.condest_iters) \
            == (4, 2, 2)
        assert ad.registry is None and ad.health is None
    elif option == "registry":
        reg = MetricsRegistry()
        mon = HealthMonitor(reg)
        srv = SolveServer(_small_state(), adaptation=OnlineAdaptation(),
                          registry=reg, health=mon)
        # propagated to the adaptation, as the reference does
        assert srv.adaptation.registry is reg
        assert srv.adaptation.health is mon
        assert srv.metrics.registry is reg and srv.metrics.prefix == "serve"
    else:
        rec = FlightRecorder(tmp_path)
        assert rec.record_dir == str(tmp_path)
        assert (rec.fingerprint_every, rec.max_tail, rec.debounce_s,
                rec.keep, rec.max_spans) == (4, 1024, 30.0, 8, 512)
        assert rec.bundle_paths == [] and rec.debounced == 0


def test_not_ported_arch_raises_in_the_cli():
    """A retired refusal (ROADMAP A6 is ported), under its old name:
    ``--arch whisper-base`` parses and asks for no later slice."""
    args = _parser().parse_args(["--arch", "whisper-base", "--device", "cpu",
                                 "--decode-tokens", "0"])
    assert args.arch == "whisper-base" and args.decode_tokens == 0
    assert not any(asked for asked, _ in _later_flags(args).values())
    assert tconfigs.get_smoke(args.arch).family == "audio"


def test_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_server(tconfigs.get_smoke(ARCH), window=4, seq=8)
