"""The serving CLI and ``build_server`` on the sharded tier, on the CPU
(every mesh position on the CPU), and the replay of a padded sharded
window's incident bundle. The file starts no thread of its own: the CLI
and ``build_server`` cases run the port's ``AsyncSolveServer``, whose
worker thread the async CLI needs, and shut it down.

* ``serve_main --device cpu --smoke --mesh 1d --async --mesh-shape 1,4``
  and ``--mesh 2d --mesh-shape 2,2`` (which implies ``--async``): the
  first nine losses within 1e-3 of the eager CLI's (relative to their
  largest), ``chip_smoke.cli_smoke``'s gate — the SMOKE model's loss then
  climbs to ≈ 5e4, where runs that sum in another order part (the
  sharded solves sum their slabs); ``--async`` alone the eager CLI's
  twelve losses exactly, as the async worker runs the eager solve;
* the parser and ``make_serve_mesh`` (the reference's axes);
* ``build_server(layout=, async_=, mesh=)``'s wiring and its
  ``ValueError`` for a layout without the async server
  (``tests/test_dist.py:622-645``);
* a flight-recorder bundle of a 2d window padded in its sample axis
  (``fifo_n`` in its metadata) replayed by ``python -m
  repro_torch.obs.forensics``'s ``analyze`` at the logical FIFO modulus;
* the monitored residual of a bf16 window against the JAX package's
  ``residual`` (a repaired fault: the port multiplied the bf16 window by
  fp32 operands and raised)."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.solvers import residual as j_residual
from repro_torch import configs
from repro_torch import obs as tobs
from repro_torch.core.solvers import residual
from repro_torch.dist import (AsyncSolveServer, DistSpec,
                              init_sharded_serve_state)
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.trainer import build_server
from repro_torch.serve import (FoldJournal, OnlineAdaptation, SolveServer,
                               init_serve_state)
from repro_torch.serve.main import _parser, make_serve_mesh, serve_main

torch.set_num_threads(1)

LOSS_TOL = 1e-3


def _cli(tmp_path, name, *extra):
    _, losses = serve_main(["--device", "cpu", "--decode-tokens", "0",
                            "--ckpt-dir", str(tmp_path / name), *extra])
    return np.asarray(losses)


@pytest.fixture(scope="module")
def eager_losses(tmp_path_factory):
    return _cli(tmp_path_factory.mktemp("eager"), "ck")


@pytest.mark.parametrize("extra", [
    ("--mesh", "1d", "--async", "--mesh-shape", "1,4"),
    ("--mesh", "2d", "--mesh-shape", "2,2"),
    ("--async",)], ids=["1d", "2d", "async"])
def test_cli_sharded_vs_eager(extra, eager_losses, tmp_path, capsys):
    losses = _cli(tmp_path, "ck", *extra)
    out = capsys.readouterr().out
    layout = extra[1] if extra[0] == "--mesh" else "replicated"
    assert f"[async {layout}]" in out
    assert "checkpointed ServeState+params" in out
    assert losses.shape == eager_losses.shape == (12,)
    if layout == "replicated":
        assert np.array_equal(losses, eager_losses)
    else:
        err = np.abs(losses[:9] - eager_losses[:9]).max() / \
            np.abs(eager_losses[:9]).max()
        assert err < LOSS_TOL
    served = re.search(r"served (\d+) requests", out)
    assert served and int(served.group(1)) == 12


def test_parser_and_mesh():
    args = _parser().parse_args(["--mesh", "2d", "--mesh-shape", "2,2"])
    assert (args.mesh, args.mesh_shape, args.async_) == ("2d", "2,2", False)
    assert _parser().parse_args(["--async"]).async_
    mesh = make_serve_mesh("2,2", "cpu")
    assert mesh.axis_names == ("data", "model") and mesh.size == 4
    assert make_serve_mesh("4", "cpu").axis_names == ("data",)
    assert make_serve_mesh("2,2,2", "cpu").axis_names == ("pod", "data",
                                                          "model")


def test_build_server_wiring():
    cfg = configs.get_smoke("llama3.2-3b")
    with pytest.raises(ValueError, match="async"):
        build_server(cfg, window=4, seq=8, layout="1d", device="cpu")
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    for kw in ({"async_": True}, {"async_": True, "layout": "1d",
                                  "mesh": mesh}):
        server, h = build_server(cfg, window=4, seq=8, damping=1e-2,
                                 max_tokens=64, max_requests=2,
                                 device="cpu", **kw)
        assert isinstance(server, AsyncSolveServer)
        assert (server.spec is None) == ("layout" not in kw)
        try:
            ex = {k: v[:2] for k, v in h.data.batch_at(1).items()}
            loss, v, rows = h.score_grads(h.params, ex)
            uid = server.submit(v, tokens=16, rows=rows)
            (res,) = server.flush(timeout=60)
            assert res.uid == uid and torch.isfinite(res.x).all()
            assert server.stats.adapted == 2
        finally:
            server.shutdown(timeout=60)


def test_replay_padded_2d_bundle(tmp_path):
    """A 2d window of n = 9 on 2 data rows stores a zero sample row; the
    recorder keeps ``fifo_n`` = 9 and the replay folds at that modulus (at
    n = 10 the wrap would land on the pad row). The replay is replicated,
    so its sums run in another order than the live run's row pieces: the
    window comes back bit for bit, W and L within 1e-5."""
    rng = np.random.default_rng(8)
    n, m = 9, 40
    S = torch.from_numpy((rng.normal(size=(n, m)) / np.sqrt(m))
                         .astype(np.float32))
    spec = DistSpec(make_mesh((2, 1), ("data", "model"), device="cpu"), "2d")
    live = init_sharded_serve_state(S, 0.1, spec=spec, device="cpu")
    assert live.n_logical == n and live.state.W.shape == (10, 10)
    reg = tobs.MetricsRegistry()
    mon = tobs.HealthMonitor(reg)
    rec = tobs.FlightRecorder(tmp_path / "rec", fingerprint_every=1,
                              debounce_s=0.0)
    ad = OnlineAdaptation(refresh_every=10 ** 6, drift_frac=None,
                          journal=FoldJournal(), registry=reg, health=mon,
                          dist=spec)
    ad.fifo_n = live.n_logical
    state = live.state
    for _ in range(7):                # 7 folds of 2 rows wrap n = 9
        state = ad.fold(state, torch.from_numpy(
            (rng.normal(size=(2, m)) / np.sqrt(m)).astype(np.float32)))
        state, _ = ad.maybe_refresh(state)
        rec.observe(state, adaptation=ad, health=mon, registry=reg)
    path = rec.capture("test", force=True)
    bundle = tobs.load_bundle(path, device="cpu")
    assert bundle.meta["fifo_n"] == n
    pm = tobs.analyze(bundle)
    assert pm["events_replayed"] == len(bundle.journal.events) >= 1
    assert pm["fingerprints_checked"] >= 1
    assert pm["live_fingerprint"] == state.fingerprint()
    replay = OnlineAdaptation(refresh_every=10 ** 6, drift_frac=None)
    replay.fifo_n = bundle.meta["fifo_n"]
    back = bundle.journal.replay(bundle.state, replay)
    assert torch.equal(back.S, state.S.gather())
    assert not back.S[n:].any()                 # the pad row stays zero
    assert (back.W - state.W).abs().max() < 1e-5
    assert (back.L - state.L).abs().max() < 1e-5
    assert back.slot == state.slot


def test_monitored_residual_bf16_window():
    """``residual`` widens a bf16 window as the solve does (it raised on
    the bf16 × fp32 product), so the eager server's monitored path runs
    on a bf16 window; the value is the JAX package's."""
    rng = np.random.default_rng(2)
    S = (rng.normal(size=(8, 64)) / 8.0).astype(np.float32)
    Sb = torch.from_numpy(S).to(torch.bfloat16)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    got = float(residual(Sb, torch.from_numpy(v), torch.from_numpy(x), 0.1))
    want = float(jax.jit(j_residual)(jnp.asarray(S, jnp.bfloat16),
                                     jnp.asarray(v), jnp.asarray(x), 0.1))
    assert abs(got - want) <= 1e-5 * abs(want)
    srv = SolveServer(init_serve_state(torch.from_numpy(S), 0.1,
                                       device="cpu", window_dtype="bfloat16"))
    srv.submit(torch.from_numpy(v[:, 0]))
    (res,) = srv.flush()
    assert torch.isfinite(res.x).all()
    assert 0.0 <= srv.stats.last_residual < 1e-3
