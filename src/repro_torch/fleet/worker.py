"""``FleetWorker`` — one serving process behind the wire protocol (torch
port of ``repro/fleet/worker.py``).

A worker owns exactly what a single-process server owns — a resident
``ServeState`` (replicated or sharded), a solve server over it, and an
``OnlineAdaptation`` with a fold journal — and exposes it as a frame
loop: solve requests in, results out, gossiped fold events ingested
strictly in sequence (``ReplayBuffer`` + ``fold(slots=...)`` cursor
verification), heartbeats answered with live load/reconciliation depth.

Two ways to get a replica:

* **inline** — the dispatcher ships the seeded window ``S0`` in the init
  frame and the worker factorizes it locally (``init_serve_state``).
  Identical bytes in ⇒ identical resident factor on every worker of one
  kind of device: the precondition for gossip convergence. This is what
  ``build_fleet`` uses — the model lives with the traffic source;
  workers are pure solver replicas.
* **build** — the init frame names a config and the worker runs
  ``launch.trainer.build_server`` itself (its own seeded window from the
  same seed). For standalone workers that hold their own model copy.

The inner server is the eager ``SolveServer`` by default; ``async``
selects ``repro_torch.dist.AsyncSolveServer`` (device execution overlaps
the socket loop; remote folds ride its ordered maintenance queue), and
``layout`` additionally shards the worker's window over its own mesh:
``torch.cuda.device_count()`` positions on a card each, or one position
on a worker given one device (``cuda:<i>``, ``cpu``). The init frame's
``monitor_drift`` (default True, as the reference's server) switches the
drift residual off, so uniform-λ microbatches take the fused
``serve_solve`` kernels.

Every replica runs on the worker's ``device``: CUDA unless told
otherwise, raising without a GPU — no worker moves to the CPU on its own.
A failure while serving (a kernel that does not build or launch) goes to
the dispatcher as an ``error`` frame, raised there as ``RuntimeError``.

Frames go out from a sender thread, in order: the frame loop never
blocks on a send. Were it to send inline, as the reference's worker does,
a dispatcher blocked sending it a frame larger than the socket's buffers
(a fold's rows at m = 100,000 are 800 KB) while it is blocked sending a
result back would hold both ends for good.

Lifecycle: SIGTERM (or a ``drain`` frame) triggers a draining exit —
pending solves are served and results flushed to the socket before the
process leaves, the contract the dispatcher's rerouting relies on. The
SIGTERM handler is installed by ``main`` only, so a ``FleetWorker`` can
also run in a thread.

    python -m repro_torch.fleet --connect 127.0.0.1:PORT --worker-id 0
"""
from __future__ import annotations

import argparse
import os
import queue
import signal
import threading
from typing import Dict

from repro_torch.core.device import resolve_device
from repro_torch.fleet.gossip import ReplayBuffer
from repro_torch.fleet.wire import (Channel, Message, WireError, connect,
                                    get_blocks, put_blocks, tensor_of)
from repro_torch.serve.journal import FoldEvent, FoldJournal

__all__ = ["FleetWorker", "main"]


class FleetWorker:
    """The frame loop around one serving replica on ``device``."""

    def __init__(self, channel: Channel, *, worker_id: int = 0, device=None):
        self.device = resolve_device(device)
        self.chan = channel
        self.worker_id = int(worker_id)
        self.server = None
        self.journal = FoldJournal()
        self.replay = ReplayBuffer()
        self.gossip = True
        self.tenants = None                   # TenantManager (init frame)
        self.registry = None                  # obs registry (init frame)
        self.tracer = None                    # obs tracer (init "trace")
        self.health = None                    # HealthMonitor (with registry)
        self.profile = None                   # ProfileHooks ("profile_dir")
        self.recorder = None                  # FlightRecorder ("record_dir")
        self._async = False
        self._uid_map: Dict[int, int] = {}    # inner uid -> dispatcher uid
        self._running = True
        self._terminated = False              # SIGTERM seen (final bundle)
        self._outbox: queue.Queue = queue.Queue()   # frames to send, FIFO
        self._sender = None

    def _send(self, kind: str, meta: dict, arrays=None) -> None:
        """Queue one frame for the sender thread."""
        self._outbox.put((kind, meta, arrays))

    def _send_frames(self) -> None:
        """The sender thread: frames in queue order until ``None``; after a
        send fails (the peer went away) the rest are dropped."""
        alive = True
        while True:
            frame = self._outbox.get()
            if frame is None:
                return
            if alive:
                try:
                    self.chan.send(*frame)
                except WireError:
                    alive = False

    def _tensors(self, value):
        """Received arrays (dense or blocks) as tensors on the device."""
        if value is None:
            return None
        if isinstance(value, tuple):
            return tuple(tensor_of(b, self.device) for b in value)
        return tensor_of(value, self.device)

    # -- construction of the replica ---------------------------------------
    def _handle_init(self, msg: Message) -> None:
        from repro_torch.serve import (OnlineAdaptation, SolveServer,
                                       TokenBudgetBatcher, init_serve_state,
                                       restore_serve_state)

        meta = msg.meta
        self.gossip = bool(meta.get("gossip", True))
        self._async = bool(meta.get("async", False))
        # observability: the registry is on by default (snapshots ride
        # heartbeat pongs — the dispatcher's fleet view); span tracing is
        # opt-in ("trace": True) since spans ride every result frame
        if meta.get("obs", True):
            from repro_torch.obs import HealthMonitor, MetricsRegistry
            self.registry = MetricsRegistry()
            # per-process numerical-health verdicts; the report rides the
            # pong next to the metrics snapshot (Dispatcher.fleet_health)
            self.health = HealthMonitor(self.registry)
        if meta.get("trace", False):
            from repro_torch.obs import Tracer
            self.tracer = Tracer()
        if meta.get("profile_dir"):
            from repro_torch.obs import ProfileHooks
            self.profile = ProfileHooks(os.path.join(
                str(meta["profile_dir"]), f"worker{self.worker_id}"))
            self.profile.start()
        if meta.get("record_dir"):
            # per-worker incident capture: bundles land under the worker's
            # own subdirectory; their paths ride heartbeat pongs so
            # Dispatcher.collect_incidents() can gather the fleet's set
            from repro_torch.obs import FlightRecorder
            self.recorder = FlightRecorder(
                os.path.join(str(meta["record_dir"]),
                             f"worker{self.worker_id}"),
                fingerprint_every=int(meta.get("fingerprint_every", 4)),
                debounce_s=float(meta.get("record_debounce_s", 30.0)))
        if meta.get("tenant_rank"):
            from repro_torch.tenants import TenantManager
            budget_mb = meta.get("tenant_budget_mb")
            self.tenants = TenantManager(
                int(meta["tenant_rank"]),
                budget_bytes=None if budget_mb is None
                else int(float(budget_mb) * 2**20),
                spill_dir=meta.get("tenant_spill_dir"),
                registry=self.registry)
        adaptation = OnlineAdaptation(
            refresh_every=int(meta.get("refresh_every", 64)),
            drift_tol=meta.get("drift_tol"),
            drift_frac=meta.get("drift_frac"),
            jitter=float(meta.get("jitter", 0.0)),
            journal=self.journal,
            audit_every=int(meta.get("audit_every", 0)),
            audit_probes=int(meta.get("audit_probes", 2)))
        monitor_drift = bool(meta.get("monitor_drift", True))
        if meta.get("mode", "inline") == "build":
            from repro_torch import configs
            from repro_torch.launch.trainer import build_server
            cfg = configs.get_smoke(meta["arch"]) if meta.get("smoke", True) \
                else configs.get_config(meta["arch"])
            self.server, _ = build_server(
                cfg, mesh=self._mesh(meta.get("mesh_shape", [1, 1])),
                window=int(meta["window"]),
                seq=int(meta["seq"]), damping=float(meta["damping"]),
                max_tokens=int(meta.get("max_tokens", 4096)),
                max_requests=int(meta.get("max_requests", 8)),
                refresh_every=adaptation.refresh_every,
                drift_tol=adaptation.drift_tol,
                drift_frac=adaptation.drift_frac,
                jitter=adaptation.jitter,
                policy=meta.get("policy", "cached"),
                layout=meta.get("layout"), async_=self._async,
                window_dtype=meta.get("window_dtype"),
                seed=int(meta.get("seed", 0)),
                audit_every=adaptation.audit_every,
                audit_probes=adaptation.audit_probes,
                registry=self.registry, tracer=self.tracer,
                profile=self.profile, health=self.health,
                recorder=self.recorder, device=self.device)
            self.server.monitor_drift = monitor_drift
            # share the worker's journal so gossiped replays are recorded
            self.server.adaptation.journal = self.journal
            self.server.tenants = self.tenants
        else:
            S0 = self._tensors(get_blocks(msg, "S0"))
            if S0 is None:
                raise WireError("inline init frame carries no S0 window")
            if isinstance(S0, tuple):
                from repro_torch.core.operator import BlockedScores
                S0 = BlockedScores(S0)
            damping = float(meta["damping"])
            jitter = adaptation.jitter
            window_dtype = meta.get("window_dtype")
            batcher = TokenBudgetBatcher(
                max_tokens=int(meta.get("max_tokens", 4096)),
                max_requests=int(meta.get("max_requests", 8)))
            layout = meta.get("layout")
            kw = dict(batcher=batcher, adaptation=adaptation,
                      policy=meta.get("policy", "cached"),
                      monitor_drift=monitor_drift, jitter=jitter,
                      tenants=self.tenants, registry=self.registry,
                      tracer=self.tracer, profile=self.profile,
                      health=self.health, recorder=self.recorder)
            if layout is not None or self._async:
                from repro_torch.dist import (AsyncSolveServer, DistSpec,
                                              init_sharded_serve_state)
                if layout is not None:
                    state = init_sharded_serve_state(
                        S0, damping,
                        spec=DistSpec(self._mesh(None, ("model",)), layout),
                        jitter=jitter, window_dtype=window_dtype)
                else:
                    state = init_serve_state(S0, damping, jitter=jitter,
                                             window_dtype=window_dtype)
                self.server = AsyncSolveServer(state, **kw)
            else:
                self.server = SolveServer(
                    init_serve_state(S0, damping, jitter=jitter,
                                     window_dtype=window_dtype), **kw)
            del S0
            if meta.get("restore_dir"):
                restored, _ = restore_serve_state(
                    meta["restore_dir"], int(meta["restore_step"]),
                    self.server.state)
                self.server.state = restored
        st = self.server.state
        # report the *logical* window size: a 2d-padded sharded replica
        # still folds (and gossips) over the unpadded FIFO modulus
        n = getattr(self.server, "fifo_n", None) or int(st.W.shape[0])
        self._send("init_ok", {"worker_id": self.worker_id, "n": n,
                               "pid": os.getpid()})

    def _mesh(self, shape, axes=None):
        """The worker's own mesh: ``shape`` (default: one position a card,
        or one position on a worker given one device) named as the
        reference names it."""
        import torch

        from repro_torch.launch.mesh import make_mesh
        whole_cards = self.device.type == "cuda" and self.device.index is None
        if shape is None:
            shape = (torch.cuda.device_count() if whole_cards else 1,)
        shape = tuple(int(x) for x in shape)
        axes = axes or ("data", "model")[:len(shape)]
        return make_mesh(shape, axes,
                         device=None if whole_cards else self.device)

    # -- per-frame handlers -------------------------------------------------
    def _handle_solve(self, msg: Message) -> None:
        v = self._tensors(get_blocks(msg, "v"))
        tenant = msg.meta.get("tenant")
        # tenant rows always ride the frame — they are tenant-private,
        # never gossiped; shared rows ride it only with gossip off
        rows = self._tensors(get_blocks(msg, "rows")) \
            if (tenant is not None or not self.gossip) else None
        inner = self.server.submit(
            v, damping=msg.meta.get("damping"),
            tokens=int(msg.meta.get("tokens", 1)), rows=rows,
            tenant=tenant, trace=msg.meta.get("trace"))
        self._uid_map[inner] = int(msg.meta["uid"])

    def _handle_fold(self, msg: Message) -> None:
        rows = self._tensors(get_blocks(msg, "rows"))
        ev = FoldEvent(seq=int(msg.meta["seq"]), kind="fold",
                       slots=tuple(int(s) for s in msg.meta["slots"]),
                       rows=rows, origin=msg.meta.get("origin"))
        for ready in self.replay.offer(ev):
            # record=True: the worker's journal is its applied history —
            # exactly what the bit-identical replay test replays
            self.server.apply_fold(ready.rows, slots=ready.slots)

    def _handle_ping(self, msg: Message) -> None:
        if msg.meta.get("barrier") and self._async:
            # folds applied (and any straggler results out) before we report
            self._send_results(self.server.flush())
        st = self.server.state
        qs = self.server.batcher.queue_stats(self.server.clock())
        meta = {
            "worker_id": self.worker_id,
            "queued": len(self.server.batcher),
            "oldest_age_s": qs["oldest_age_s"],
            "served": int(st.stats.served),
            "adapted": int(st.stats.adapted),
            "applied": self.replay.applied,
            "buffered": len(self.replay)}
        if self.tenants is not None:
            # hot-tenant packing stats: the dispatcher's placement signal
            meta["tenants"] = self.tenants.packing_stats()
        if self.registry is not None:
            # the mergeable snapshot rides the pong: the dispatcher folds
            # every worker's into one fleet view (Dispatcher.fleet_metrics)
            meta["metrics"] = self.registry.snapshot()
        if self.health is not None:
            # verdict + active rules + recent events: the dispatcher's
            # fleet_health() merge and critical-skip routing feed on this
            meta["health"] = self.health.report()
        if self.recorder is not None:
            # bundle *paths*, not bundles: incident npz files stay on the
            # worker's disk; the dispatcher only gathers where they are
            meta["incidents"] = list(self.recorder.bundle_paths)
        self._send("pong", meta)

    def _handle_ckpt(self, msg: Message) -> None:
        from repro_torch.serve import save_serve_state
        if self._async:
            self._send_results(self.server.flush())
        path = save_serve_state(msg.meta["dir"], int(msg.meta["step"]),
                                self.server.state,
                                metadata={"worker_id": self.worker_id})
        jpath = os.path.join(msg.meta["dir"],
                             f"journal_{int(msg.meta['step']):09d}.npz")
        self.journal.save(jpath)
        # the npz now covers the whole prefix: replay = restore + tail
        self.journal.compact(self.journal.head)
        self._send("ckpt_ok", {"worker_id": self.worker_id,
                               "path": str(path), "journal": jpath,
                               "journal_head": self.journal.head,
                               "applied": self.replay.applied})

    # -- the loop -----------------------------------------------------------
    def _service(self) -> None:
        """Flush the inner server and stream results back."""
        if self.server is None or not self._uid_map:
            return
        self._send_results(self.server.flush())

    def _send_results(self, results) -> None:
        for res in results:
            arrays, meta = {}, {"uid": self._uid_map.pop(res.uid),
                                "damping": res.damping,
                                "latency_s": res.latency_s,
                                "worker_id": self.worker_id}
            if self.tracer is not None:
                # worker-side spans (queue/solve/fold, tagged with the
                # dispatcher's trace ids) ride the result frame home
                spans = self.tracer.drain()
                if spans:
                    meta["spans"] = spans
            put_blocks(arrays, meta, "x", res.x)      # the host copy
            self._send("result", meta, arrays)

    def run(self) -> None:
        """Serve frames until ``bye``/EOF/SIGTERM; always drains."""
        self._sender = threading.Thread(
            target=self._send_frames, daemon=True,
            name=f"fleet-worker{self.worker_id}-sender")
        self._sender.start()
        try:
            while self._running:
                msg = self.chan.recv()
                self._dispatch_msg(msg)
                # batch-drain: coalesce every frame already on the socket
                # before flushing the solver (the batcher does the rest)
                while self._running and self.chan.poll(0.0):
                    self._dispatch_msg(self.chan.recv())
                self._service()
        except (WireError, SystemExit):
            pass                       # peer went away or SIGTERM: drain
        except Exception as e:
            # a poisoned request must surface as an error frame, not a
            # silent death — otherwise the dispatcher reroutes the same
            # request onto each survivor and kills the whole fleet
            self._send("error", {"worker_id": self.worker_id,
                                 "message": repr(e)})
            raise
        finally:
            self._drain_exit()

    def _dispatch_msg(self, msg: Message) -> None:
        if msg.kind == "init":
            self._handle_init(msg)
        elif msg.kind == "solve":
            self._handle_solve(msg)
        elif msg.kind == "fold":
            # pin the trace order: solves admitted before this fold event
            # solve against the pre-fold window, on every worker, under
            # every routing policy — what makes per-request results
            # routing-independent on identical traces
            self._service()
            self._handle_fold(msg)
        elif msg.kind == "ping":
            self._handle_ping(msg)
        elif msg.kind == "ckpt":
            self._handle_ckpt(msg)
        elif msg.kind == "drain":
            self._service()
            self._send("drained", {
                "worker_id": self.worker_id,
                "served": int(self.server.state.stats.served)})
        elif msg.kind == "bye":
            self._running = False
        else:
            raise WireError(f"unknown frame kind {msg.kind!r}")

    def _drain_exit(self) -> None:
        try:
            if self.server is not None:
                self._service()
                if self._async:
                    self.server.shutdown(drain=True)
        except BaseException:
            pass
        if self.recorder is not None and self._terminated:
            # SIGTERM exit: force a final bundle (debounce bypassed) so
            # the recent past survives even a clean-looking teardown
            try:
                self.recorder.capture("sigterm", force=True)
            except BaseException:
                pass
        if self.profile is not None:
            self.profile.stop()
        # every queued frame out before the channel closes
        self._outbox.put(None)
        self._sender.join(timeout=300.0)
        self.chan.close()

    def _sigterm(self, signum, frame) -> None:
        # raising breaks the blocking recv; run() falls through to the
        # draining finally, so queued solves are still served + flushed
        self._running = False
        self._terminated = True
        raise SystemExit(0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="fleet serving worker")
    ap.add_argument("--connect", required=True, metavar="HOST:PORT",
                    help="dispatcher rendezvous address")
    ap.add_argument("--worker-id", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the replica (default: cuda; "
                         "'cpu' runs the plain versions of the kernels)")
    args = ap.parse_args(argv)
    host, port = args.connect.rsplit(":", 1)
    chan = connect(host, int(port), name=f"worker{args.worker_id}")
    chan.send("hello", {"worker_id": args.worker_id, "pid": os.getpid()})
    try:
        worker = FleetWorker(chan, worker_id=args.worker_id,
                             device=args.device)
    except Exception as e:
        # no card: the dispatcher's init wait gets the reason, not EOF
        chan.send("error", {"worker_id": args.worker_id,
                            "message": repr(e)})
        chan.close()
        raise
    signal.signal(signal.SIGTERM, worker._sigterm)
    worker.run()


if __name__ == "__main__":
    main()
