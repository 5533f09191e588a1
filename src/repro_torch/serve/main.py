"""``serve_main`` — the online NGD serving loop of an LM as a CLI (port of
``repro/serve/main.py``'s in-process loop, eager or async).

    PYTHONPATH=src python -m repro_torch.serve --arch llama3.2-3b \\
        --device cpu --requests 6 --window 6 --seq 12 --decode-tokens 2

Synthetic request traffic drives the serving path end to end: each
request carries a handful of fine-tuning examples and a prompt. Per
request ``serve_trace``

1. runs the score-grad pass (``launch.train.make_score_grads``) — the
   mean-gradient RHS v plus per-sample score rows for the window fold;
2. submits v to the token-budget batcher with the request's λ (every
   fifth request asks for 4λ₀) and, under ``--tenants N``, a zipf(1.5)
   tenant id among N (its rows then fold into that tenant's rank-r delta,
   ``--tenant-rank``, under the ``--tenant-budget-mb`` residency budget;
   a ``tenants:`` packing line prints at exit);
3. flushes coalesced microbatches through the ``SolveServer`` (resident
   factor; no Gram on the request path) — or, with ``--async``, the
   ``AsyncSolveServer``, its window sharded over a ``--mesh-shape`` mesh
   with ``--mesh 1d|2d`` (which implies ``--async``; the positions take
   a card each, or all lie on ``--device``), applies the natural-gradient
   updates to the live params, feeds the Levenberg–Marquardt damping
   state with each request's actual against predicted loss reduction
   (the drift threshold's autotune), and lets ``OnlineAdaptation`` fold
   the rows and refresh on age or drift;
4. greedy-decodes the response: prefill (the flash-attention kernel on
   the card) and one-token decode steps.

``ServeState`` and the params checkpoint every ``--ckpt-every`` rounds
and at exit into ``--ckpt-dir`` (``repro_torch.checkpoint``, the
reference's layout), the factor audit runs every ``--audit-every``
maintenance passes, and the health monitor's verdict prints at exit,
after p50/p99 solve latency, requests/sec and the window counters. The
observability flags are the reference's: ``--metrics-port`` /
``--health-port`` (HTTP endpoints, self-scraped at exit),
``--metrics-snapshot``, ``--trace-out`` (a Chrome trace),
``--profile-dir`` (``torch.profiler``, started before the server is
built, so the trace holds the model build and the window's
factorization) and ``--record-dir`` (the flight recorder). ``--smoke``
(the default) serves the architecture's reduced config; ``--full`` its
published widths, ``--n-layers`` cuts the depth.
The fleet comes with a later slice (``repro_torch.roadmap``) and raises
``NotImplementedError`` when asked for.
"""
from __future__ import annotations

import argparse
import json
import time
import urllib.request
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core.damping import LevenbergMarquardtDamping
from repro_torch.dist import AsyncSolveServer
from repro_torch.launch.mesh import mesh_from_shape as make_serve_mesh
from repro_torch.launch.trainer import build_server
from repro_torch.obs import (FlightRecorder, HealthMonitor, MetricsRegistry,
                             ProfileHooks, Tracer, start_metrics_server,
                             write_snapshot)
from repro_torch.roadmap import queue
from repro_torch.serve.state import serve_state_tree

__all__ = ["serve_main", "serve_trace"]


def _sync(device: torch.device) -> float:
    """Host clock after the device has finished its queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def serve_trace(server, h, *, requests: int, window: int, adapt_examples: int,
                seq: int, decode_tokens: int, damping: float, lr: float,
                burst: int, seed: int = 0, tenants: int = 0,
                keep_logits: bool = False,
                on_result: Optional[Callable] = None,
                on_round: Optional[Callable] = None, log=print) -> dict:
    """Serve ``requests`` synthetic requests; the per-request loop of the
    reference's eager ``serve_main``.

    ``tenants`` > 0: each request carries the tenant id
    ``t{(zipf(1.5) − 1) mod tenants}``, drawn from the request loop's rng
    after its λ, as the reference does (no draw without tenants, so the
    stream is unchanged then).

    Returns ``{"records": [...], "damping_state", "rounds"}``, one record
    per served request in completion order: ``request``, ``uid``,
    ``tenant``, ``damping``, ``loss`` (before its update), ``tokens``
    (greedy ids), ``solve_ms`` (the server's submit → solution latency),
    and the wall times ``score_ms`` (score pass), ``flush_ms`` (its
    flush's time over the flush's requests), ``apply_ms`` (update +
    damping feedback) and ``decode_ms`` (prefill + decode), each ended by
    a device sync; with ``keep_logits`` also ``logits``, the
    (decode_tokens, V) fp32 logits of the greedy steps, on the host. ``on_result(record, result)`` sees
    each solve result (``result.x``) before the next request is served;
    ``on_round(rounds)`` runs after each flush that served requests (the
    CLI's checkpoint cadence).
    """
    dev = h.device
    pin = isinstance(server, AsyncSolveServer)
    lm_damping = LevenbergMarquardtDamping(damping)
    dstate = lm_damping.init()
    rng = np.random.default_rng(seed)
    records, pending, rounds = [], {}, 0

    for r in range(requests):
        if pin:
            # the async server judges the microbatches a call closes
            # against the damping state pinned at that call: pin it
            # before submitting, not at flush time
            server.damping_state = dstate
        # one synthetic request: adaptation examples + a prompt
        t0 = _sync(dev)
        full = h.data.batch_at(r + 1)
        take = np.sort(rng.choice(window, size=adapt_examples, replace=False))
        ex = {key: val[take] for key, val in full.items()}
        loss, v, rows = h.score_grads(h.params, ex)
        # per-request λ: occasional requests ask for extra damping
        lam = damping * (4.0 if r % 5 == 4 else 1.0)
        # zipf tenant traffic: a few hot tenants, a long cold tail
        tenant = f"t{(int(rng.zipf(1.5)) - 1) % tenants}" \
            if tenants else None
        uid = server.submit(v, damping=lam, tokens=adapt_examples * seq,
                            rows=rows, tenant=tenant)
        del rows
        rec = {"request": r, "uid": uid, "tenant": tenant, "damping": lam,
               "loss": float(loss), "tokens": [],
               "score_ms": (_sync(dev) - t0) * 1e3}
        pending[uid] = (v, rec, ex)

        if (r + 1) % burst and r != requests - 1:
            continue
        t0 = _sync(dev)
        results = server.flush(damping_state=dstate)
        flush_ms = (_sync(dev) - t0) * 1e3
        for res in results:
            v_req, rec, ex_req = pending.pop(res.uid)
            t0 = time.perf_counter()
            h.apply_update(res.x, lr=lr)
            # trust-region feedback for the drift autotune: actual vs
            # predicted reduction of this request's adaptation loss
            loss_after = h.loss(ex_req)
            predicted = lr * float(torch.dot(v_req, res.x.to(v_req.dtype)))
            dstate = lm_damping.update(
                dstate, actual_reduction=rec["loss"] - loss_after,
                predicted_reduction=max(predicted, 1e-30))
            rec.update(flush_ms=flush_ms / len(results),
                       apply_ms=(_sync(dev) - t0) * 1e3,
                       solve_ms=res.latency_s * 1e3)
            if on_result is not None:
                on_result(rec, res)
            del v_req
            if decode_tokens > 0:
                t0 = _sync(dev)
                ids, logits = h.decode(ex_req["inputs"][:1, :seq],
                                       new_tokens=decode_tokens,
                                       return_logits=True)
                rec["decode_ms"] = (_sync(dev) - t0) * 1e3
                rec["tokens"] = ids[0].tolist()
                if keep_logits:
                    rec["logits"] = logits[0].cpu()
                log(f"req {res.uid:3d} λ={res.damping:.3g} "
                    f"loss {rec['loss']:8.4f} "
                    f"solve {rec['solve_ms']:6.1f} ms "
                    f"tokens {rec['tokens'][:8]}")
            records.append(rec)
        if results:
            rounds += 1
            if on_round is not None:
                on_round(rounds)
    return {"records": records, "damping_state": dstate, "rounds": rounds}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--arch", choices=configs.list_archs(),
                    default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (CPU-runnable); on by default")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the config's depth to this many layers "
                         "(published widths kept)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions of the kernels)")
    ap.add_argument("--requests", type=int, default=12,
                    help="synthetic requests to serve")
    ap.add_argument("--window", type=int, default=8,
                    help="resident curvature window size n (samples)")
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--adapt-examples", type=int, default=2,
                    help="fine-tuning examples per request")
    ap.add_argument("--decode-tokens", type=int, default=4,
                    help="greedy tokens decoded per request (0: skip)")
    ap.add_argument("--damping", type=float, default=1e-2,
                    help="resident λ0; requests may deviate per-request")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--max-tokens", type=int, default=64,
                    help="batcher token budget per microbatch")
    ap.add_argument("--max-requests", type=int, default=4,
                    help="batcher RHS width cap per microbatch")
    ap.add_argument("--burst", type=int, default=3,
                    help="requests submitted before each flush")
    ap.add_argument("--refresh-every", type=int, default=16,
                    help="age bound: full refresh after this many "
                         "microbatches")
    ap.add_argument("--drift-tol", type=float, default=None,
                    help="static drift bound (overrides --drift-frac)")
    ap.add_argument("--drift-frac", type=float, default=0.25,
                    help="autotuned drift bound fraction")
    ap.add_argument("--window-dtype", choices=["fp32", "bf16"],
                    default="fp32",
                    help="resident score-window storage dtype")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-shape", default="1,1",
                    help="device mesh for sharded serving, e.g. 2,2 → "
                         "(data, model); a card a position, or every "
                         "position on --device")
    ap.add_argument("--mesh", choices=["replicated", "1d", "2d"],
                    default="replicated",
                    help="resident window layout: replicated (one "
                         "device) or sharded over the mesh (implies "
                         "--async)")
    ap.add_argument("--async", dest="async_", action="store_true",
                    help="serve through the concurrent AsyncSolveServer "
                         "(a worker thread; responses as the eager "
                         "server's)")
    # the reference's fleet: accepted, refused until its slice
    ap.add_argument("--fleet", type=int, default=0, metavar="N")
    ap.add_argument("--route", choices=["round_robin", "least_loaded",
                                        "by_adapter"], default="round_robin")
    ap.add_argument("--no-reconcile", action="store_true")
    ap.add_argument("--tenants", type=int, default=0, metavar="N",
                    help="multi-tenant trace: requests carry zipf-"
                         "distributed tenant ids over N tenants; each "
                         "tenant's rows fold into its own rank-r delta "
                         "over the shared base factor (0: off)")
    ap.add_argument("--tenant-rank", type=int, default=4,
                    help="per-tenant delta rank budget r (--tenants)")
    ap.add_argument("--tenant-budget-mb", type=float, default=None,
                    help="resident tenant byte budget in MiB; LRU spill "
                         "past it (--tenants; default: unbounded)")
    ap.add_argument("--ckpt-dir", default="artifacts/serve_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=8,
                    help="checkpoint cadence in flush rounds (0: off)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve live metrics over HTTP on this port "
                         "(/metrics Prometheus text, /metrics.json raw "
                         "snapshot, /health; 0: ephemeral port)")
    ap.add_argument("--metrics-snapshot", default=None, metavar="PATH",
                    help="write the metrics snapshot JSON here at "
                         "checkpoint cadence and at exit")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="trace every request's spans and export a "
                         "Chrome-trace JSON here at exit")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the serving "
                         "loop into DIR")
    ap.add_argument("--audit-every", type=int, default=4, metavar="K",
                    help="run the factor audit (condition estimate + "
                         "Hutchinson residual probe) every K maintenance "
                         "passes (0: off)")
    ap.add_argument("--health-port", type=int, default=None, metavar="PORT",
                    help="bind an extra HTTP endpoint serving the health "
                         "report at /health (0: ephemeral port)")
    ap.add_argument("--record-dir", default=None, metavar="DIR",
                    help="run the flight recorder: incident bundles under "
                         "DIR on health-verdict escalations (replay with "
                         "python -m repro_torch.obs.forensics)")
    return ap


# flag → (is it asked for, the key of the roadmap queue that ports it)
def _later_flags(args) -> dict:
    return {
        "--fleet": (args.fleet > 0, "fleet"),
        "--no-reconcile": (args.no_reconcile, "fleet"),
        "--route": (args.route != "round_robin", "fleet"),
    }


def serve_main(argv=None):
    args = _parser().parse_args(argv)
    for flag, (asked, key) in _later_flags(args).items():
        if asked:
            raise NotImplementedError(f"{flag} comes with {queue(key)}")
    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    if args.n_layers is not None:
        cfg = cfg.scaled(n_layers=args.n_layers)
    layout = None if args.mesh == "replicated" else args.mesh
    mesh = None if layout is None \
        else make_serve_mesh(args.mesh_shape, args.device)
    async_ = args.async_ or layout is not None

    registry = MetricsRegistry()
    health = HealthMonitor(registry)
    tracer = Tracer() if args.trace_out else None
    profile = ProfileHooks(args.profile_dir) if args.profile_dir else None
    if profile is not None:
        profile.start()
    recorder = None
    if args.record_dir:
        recorder = FlightRecorder(args.record_dir)
        # a degraded/critical process that dies without flushing still
        # leaves a final bundle behind
        recorder.install_exit_capture()
    endpoints, server = [], None
    try:
        t0 = time.perf_counter()
        server, h = build_server(
            cfg, window=args.window, seq=args.seq, damping=args.damping,
            max_tokens=args.max_tokens, max_requests=args.max_requests,
            refresh_every=args.refresh_every, drift_tol=args.drift_tol,
            drift_frac=args.drift_frac,
            window_dtype=None if args.window_dtype == "fp32" else "bfloat16",
            tenant_rank=args.tenant_rank if args.tenants else None,
            tenant_budget_mb=args.tenant_budget_mb,
            seed=args.seed, audit_every=args.audit_every, registry=registry,
            tracer=tracer, profile=profile, health=health, recorder=recorder,
            device=args.device, mesh=mesh, layout=layout, async_=async_)
        port = _start_endpoint(args, registry, health.report, endpoints)
        kind = f"async {layout or 'replicated'}" if async_ else "eager"
        print(f"resident window factorized: n={args.window} "
              f"m={server.state.S.shape[1]} λ0={args.damping} [{kind}] on "
              f"{h.device} ({(time.perf_counter() - t0) * 1e3:.0f} ms)",
              flush=True)

        def checkpoint(rounds: int) -> None:
            ckpt.save(args.ckpt_dir, rounds,
                      {"serve": serve_state_tree(server.state),
                       "params": h.params},
                      metadata={"arch": cfg.name})

        def on_round(rounds: int) -> None:
            if args.ckpt_every and rounds % args.ckpt_every == 0:
                checkpoint(rounds)
                if args.metrics_snapshot:
                    write_snapshot(args.metrics_snapshot, registry.snapshot(),
                                   health=health.report())

        out = serve_trace(server, h, requests=args.requests,
                          window=args.window,
                          adapt_examples=args.adapt_examples, seq=args.seq,
                          decode_tokens=args.decode_tokens,
                          damping=args.damping, lr=args.lr, burst=args.burst,
                          seed=args.seed, tenants=args.tenants,
                          on_round=on_round,
                          log=lambda line: print(line, flush=True))
        s = server.metrics.summary()
        st = server.stats
        dstate = out["damping_state"]
        print(f"served {s['served']} requests: "
              f"p50 {s['p50_ms']:.1f} ms  p99 {s['p99_ms']:.1f} ms  "
              f"{s['rps']:.1f} req/s  {s['tokens_per_s']:.0f} tok/s")
        rep = health.report()
        print(f"health: {rep['verdict']} "
              f"(active: {sorted(rep['active']) or 'none'})")
        print(f"window: adapted {int(st.adapted)} rows, "
              f"{int(st.refreshes)} full refreshes over "
              f"{int(st.microbatches)} microbatches "
              f"(drift tol now "
              f"{float(server.adaptation.effective_drift_tol(dstate)):.3g}, "
              f"λ now {float(dstate.lam):.3g})")
        if args.tenants and server.tenants is not None:
            p = server.tenants.packing_stats()
            budget = "" if p["budget_bytes"] is None \
                else f" / {p['budget_bytes']} budget"
            print(f"tenants: {p['tenants']} seen, {p['resident']} resident "
                  f"({p['resident_bytes']} B{budget}), "
                  f"{p['evictions']} evictions, {p['activations']} "
                  f"activations, {p['factor_hits']} factor hits / "
                  f"{p['materializations']} builds; hot {p['hot']}")
        rounds = out["rounds"]
        if args.ckpt_every and rounds:
            checkpoint(rounds)
            print(f"checkpointed ServeState+params at round {rounds} "
                  f"-> {args.ckpt_dir}")
        if profile is not None:
            profile.stop()
            print(f"profile: torch.profiler trace -> {profile.trace_path}")
        if recorder is not None:
            nb = len(recorder.bundle_paths)
            print(f"flight recorder: {nb} incident bundle(s)"
                  + (f", last {recorder.bundle_paths[-1]}" if nb else "")
                  + f" ({recorder.debounced} debounced)")
        _finish_obs(args, registry.snapshot(), tracer=tracer, port=port,
                    health_report=health.report())
        if async_:
            server.shutdown()
    finally:
        if isinstance(server, AsyncSolveServer):
            server.shutdown(drain=False)     # a no-op after a clean run
        if profile is not None:
            profile.stop()      # a no-op unless the run raised
        for srv in endpoints:
            srv.shutdown()
            srv.server_close()
    return server, [rec["loss"] for rec in out["records"]]


def _start_endpoint(args, registry, health, endpoints: list):
    """``--metrics-port`` / ``--health-port``: bind the HTTP exposition
    endpoint(s), each also serving ``health()`` at ``/health``; the
    servers are appended to ``endpoints`` for the caller to close.
    Returns the metrics port (None without ``--metrics-port``)."""
    port = None
    if args.metrics_port is not None:
        srv, port = start_metrics_server(registry, port=args.metrics_port,
                                         health=health)
        endpoints.append(srv)
        print(f"metrics endpoint: http://127.0.0.1:{port}/metrics",
              flush=True)
    if args.health_port is not None and args.health_port != port:
        srv, hport = start_metrics_server(registry, port=args.health_port,
                                          health=health)
        endpoints.append(srv)
        print(f"health endpoint: http://127.0.0.1:{hport}/health",
              flush=True)
    return port


def _finish_obs(args, snapshot, *, tracer=None, port=None,
                health_report=None):
    """Exit-time observability: the snapshot file (the health report
    embedded), the Chrome-trace export, and a self-scrape of the live
    endpoint's ``/metrics`` and ``/health``."""
    if args.metrics_snapshot:
        write_snapshot(args.metrics_snapshot, snapshot, health=health_report)
        print(f"metrics snapshot -> {args.metrics_snapshot}")
    if tracer is not None and args.trace_out:
        n = tracer.export(args.trace_out)
        print(f"trace: {n} spans -> {args.trace_out}")
    if port is not None:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        series = [ln for ln in body.splitlines()
                  if ln and not ln.startswith("#")]
        print(f"metrics scrape: {len(series)} series from :{port}")
        rep = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/health", timeout=10).read())
        print(f"health scrape: verdict={rep['verdict']} "
              f"active={sorted(rep.get('active', {})) or 'none'}")


if __name__ == "__main__":
    serve_main()
