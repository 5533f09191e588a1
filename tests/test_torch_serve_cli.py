"""The port's serving CLI at the reference's defaults and with each of its
checkpoint and observability flags, on the CPU (SMOKE llama3.2-3b).

With no flags ``python -m repro_torch.serve`` does what ``python -m
repro.serve`` does: every default of the reference's parser, the audit
every 4 maintenance passes, the health verdict, and ServeState + params
checkpointed every 8 rounds and at exit, in a layout the JAX package
restores bit for bit. Every run writes only under ``tmp_path``, binds
its endpoints on ephemeral ports (``serve_main`` closes them) and
unregisters the recorder's exit hook."""
import argparse
import atexit
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_smoke as j_get_smoke
from repro.models import lm as jlm
from repro.serve import init_serve_state as j_init
from repro.serve import main as jmain
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core.pytree import leaves
from repro_torch.obs import FlightRecorder
from repro_torch.serve.main import _parser, serve_main
from repro_torch.serve.state import serve_state_tree

torch.set_num_threads(1)

SMALL = ["--device", "cpu", "--requests", "3", "--window", "4", "--seq", "8",
         "--decode-tokens", "0", "--burst", "2"]


class _Parsed(Exception):
    pass


def _reference_defaults(monkeypatch) -> dict:
    """The reference CLI's parsed defaults, taken from its own parser."""
    parse = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        raise _Parsed(vars(parse(self, args, namespace)))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as got:
        jmain.serve_main([])
    monkeypatch.undo()
    return got.value.args[0]


def test_parser_defaults_are_the_reference_s(monkeypatch):
    ref = _reference_defaults(monkeypatch)
    ours = vars(_parser().parse_args([]))
    assert set(ours) - set(ref) == {"device", "n_layers"}
    assert {k: ours[k] for k in ref} == ref
    assert (ours["ckpt_every"], ours["audit_every"], ours["ckpt_dir"]) == \
        (8, 4, "artifacts/serve_ckpt")


def test_cli_at_its_defaults(tmp_path, capsys, handles):
    """12 requests in bursts of 3: 4 rounds of 2 microbatches, so 8
    maintenance passes, 2 audits and one checkpoint, the exit one; the
    checkpoint restores the live state and params bit for bit."""
    ck = tmp_path / "ck"
    server, losses = serve_main(["--device", "cpu", "--ckpt-dir", str(ck)])
    out = capsys.readouterr().out
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert "health: ok (active: none)" in out
    assert f"checkpointed ServeState+params at round 4 -> {ck}" in out
    assert server.adaptation._audit_step == 2
    snap = server.registry.snapshot()
    assert snap["counters"]["serve.requests"] == 12
    assert snap["counters"]["serve.microbatches"] == 8
    assert "curvature.condest" in snap["gauges"]
    assert ckpt.all_steps(ck) == [4]
    like = {"serve": serve_state_tree(server.state),
            "params": handles[0].params}
    back, meta = ckpt.restore(ck, 4, like)
    assert meta == {"arch": "llama3.2-3b"}
    for a, b in zip(leaves(back), leaves(like)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.fixture
def handles(monkeypatch):
    """The ``ServeHandles`` each CLI run builds (its live params)."""
    from repro_torch.serve import main as tmain
    seen = []
    build = tmain.build_server

    def spy(*args, **kw):
        server, h = build(*args, **kw)
        seen.append(h)
        return server, h

    monkeypatch.setattr(tmain, "build_server", spy)
    return seen


def test_cli_checkpoint_restores_in_the_jax_package(tmp_path, handles):
    """The CLI's exit checkpoint restores into the reference's own tree,
    ``{"serve": ServeState, "params": ...}`` of the JAX SMOKE model, bit
    for bit."""
    ck = tmp_path / "ck"
    server, _ = serve_main(SMALL + ["--ckpt-dir", str(ck)])
    jcfg = j_get_smoke("llama3.2-3b")
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    jlike = {"serve": j_init(jnp.eye(*server.state.S.shape), 1e-2),
             "params": jparams}
    back, meta = jckpt.restore(ck, 2, jlike)
    assert meta == {"arch": "llama3.2-3b"}
    ours = leaves({"serve": serve_state_tree(server.state),
                   "params": handles[0].params})
    theirs = jax.tree_util.tree_leaves(back)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype


def _run(tmp_path, extra, monkeypatch):
    """One small CLI run; returns its (server, losses), the recorders it
    installed an exit hook for and the HTTP servers it started."""
    from repro_torch.serve import main as tmain
    installed, started = [], []
    install, start = FlightRecorder.install_exit_capture, \
        tmain.start_metrics_server

    def spy_install(self):
        installed.append(self)
        install(self)

    def spy_start(*args, **kw):
        srv, port = start(*args, **kw)
        started.append(srv)
        return srv, port

    monkeypatch.setattr(FlightRecorder, "install_exit_capture", spy_install)
    monkeypatch.setattr(tmain, "start_metrics_server", spy_start)
    try:
        return serve_main(SMALL + ["--ckpt-dir", str(tmp_path / "ck")]
                          + extra), installed, started
    finally:
        for rec in installed:
            atexit.unregister(rec._exit_capture)


@pytest.mark.parametrize("flag", [
    "--ckpt-every", "--metrics-port", "--metrics-snapshot", "--trace-out",
    "--profile-dir", "--audit-every", "--health-port", "--record-dir"])
def test_each_ported_flag(flag, tmp_path, monkeypatch, capsys):
    value = {"--ckpt-every": "1", "--metrics-port": "0", "--health-port": "0",
             "--audit-every": "1"}.get(flag, str(tmp_path / "obs"))
    (server, losses), installed, started = _run(tmp_path, [flag, value],
                                               monkeypatch)
    out = capsys.readouterr().out
    assert len(losses) == 3 and "health: ok" in out
    if flag == "--ckpt-every":
        assert ckpt.all_steps(tmp_path / "ck") == [1, 2]
    elif flag in ("--metrics-port", "--health-port"):
        key = "metrics" if flag == "--metrics-port" else "health"
        assert f"{key} endpoint: http://127.0.0.1:" in out
        if flag == "--metrics-port":
            assert "metrics scrape: " in out
            assert "health scrape: verdict=ok active=none" in out
        # one endpoint, closed when serve_main returned
        assert len(started) == 1 and started[0].socket.fileno() == -1
    elif flag == "--metrics-snapshot":
        with open(value) as f:
            doc = json.load(f)
        assert doc["health"]["verdict"] == "ok"
        assert jobs.merge([doc])["counters"]["serve.requests"] == 3
    elif flag == "--trace-out":
        with open(value) as f:
            events = json.load(f)["traceEvents"]
        assert [e["name"] for e in events].count("request") == 3
        jt = jobs.Tracer()
        jt.ingest(events)
        assert len(jt.events()) == len(events)
    elif flag == "--profile-dir":
        (path,) = [ln.split("-> ")[1] for ln in out.splitlines()
                   if ln.startswith("profile: ")]
        with open(path) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert "coalesced_solve#0" in names
    elif flag == "--audit-every":
        # one audit a maintenance pass: one a microbatch
        assert server.adaptation._audit_step == \
            server.stats.microbatches == 2
    else:
        assert len(installed) == 1 and installed[0].record_dir == value
        assert "flight recorder: 0 incident bundle(s)" in out
