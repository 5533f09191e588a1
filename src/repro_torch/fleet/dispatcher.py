"""``Dispatcher`` — the fleet's front tier. Owns no mesh, just the map
(torch port of ``repro/fleet/dispatcher.py``).

The dispatcher holds three things: the worker channels, the request
ledger (every submitted request, in order, with enough to replay it),
and the ``GossipLog``. Requests route to one worker; fold events
broadcast to all of them; nothing numerical happens here — the front
tier is pure bookkeeping, which is why it needs no accelerator and can
front heterogeneous replicas (eager/async, replicated/sharded).

**Routing policies** (``route=``):

* ``round_robin`` — cycle the alive workers; the embarrassingly-routable
  default.
* ``least_loaded`` — fewest dispatcher-tracked in-flight requests, with
  the worker-reported queue depth (streamed back in heartbeat ``pong``
  frames) as tiebreak.
* ``by_adapter`` — consistent-hash ring over the worker ids
  (``fleet.ring.HashRing``) → sticky worker. Tenant identity defaults
  to the adapter key, so this is the fleet's *tenant placement*:
  membership churn remaps only ~1/N keys, and a dead worker's keys
  spill to its ring successors while every healthy placement stays
  put (a moved tenant pays factor re-materialization + journal-tail
  replay on the new worker, so stability is the point). With gossip
  off, folds then *partition* cleanly: each worker's window sees
  exactly its own adapters' folds, in its own solve order —
  bit-identical to a single eager server serving that sub-trace (at
  matched microbatch composition; width-1 batching pins it, which is
  how the bench/tests assert the exactness).

**Reconciliation** (``gossip=True``): a request's adaptation rows never
travel with the solve — they enter the ``GossipLog`` at admission, which
stamps them with the global FIFO slots, and the event broadcasts to
every worker. Each replica replays the log strictly in order through
``replace_factors`` (cursor-verified), so all windows converge to the
log — ``reconcile()`` is the barrier that waits until every alive
worker's applied-seq reaches the log head, after which the replicas'
resident factors are bit-identical.

**Failure model**: any send/recv error marks the worker dead and every
request in flight on it is re-routed and re-sent from the ledger. Folds
need no replay — the log, not any worker, is their system of record; a
request replayed after its fold was admitted does not fold twice. One
deliberate relaxation: a *replayed* request may solve against a window
that has already applied folds admitted after it (the survivor kept
ingesting the log while the victim died), so the fold-at-admission
ordering guarantee is "exactly the folds admitted before it" on
failure-free runs and "at least those folds" across a replay — the
same bounded-staleness envelope as the age/drift policy, traded for
availability.

``shutdown(drain=True)`` is the draining exit: pending results are
collected, workers get ``drain`` + ``bye``, subprocesses are joined
(then killed past the timeout).

The port's requests may carry torch tensors (the LM front's v and score
rows on the card): ``submit`` copies them to the host once — the one
sync of a submit — and the ledger, the gossip log and every frame hold
numpy from then on. Results carry numpy ``x``, as the reference's do.
``launch_fleet(device=)`` names the workers' device (default: CUDA);
before it spawns CUDA workers it builds the kernels once, here, so the
workers load the libraries instead of each running ``nvcc``. A frame
that goes to every worker (init, fold) is encoded once.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import select
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

from repro_torch.fleet.gossip import GossipLog
from repro_torch.fleet.ring import HashRing
from repro_torch.fleet.wire import (Channel, WireError, encode_frame,
                                    get_blocks, listen, put_blocks, to_host)
from repro_torch.obs import Tracer
from repro_torch.obs import merge as merge_snapshots
from repro_torch.obs import merge_health
from repro_torch.serve.server import ServerMetrics, SolveResult

__all__ = ["Dispatcher", "WorkerHandle", "launch_fleet", "ROUTES"]

ROUTES = ("round_robin", "least_loaded", "by_adapter")


@dataclasses.dataclass
class _Request:
    """Ledger entry: everything needed to (re)send one solve."""
    uid: int
    v: Any
    damping: Optional[float]
    tokens: int
    adapter: Optional[str]
    rows: Any                   # rides the frame: gossip off, or tenant fold
    tenant: Optional[str] = None
    t_submit: float = 0.0
    worker_id: Optional[int] = None


class WorkerHandle:
    """Dispatcher-side view of one worker."""

    def __init__(self, worker_id: int, channel: Channel,
                 proc: Optional[subprocess.Popen] = None):
        self.worker_id = int(worker_id)
        self.chan = channel
        self.proc = proc
        self.alive = True
        self.inflight: Dict[int, _Request] = {}
        self.applied = 0            # gossip seq the worker has applied
        self.queued = 0             # last reported inner queue depth
        self.served = 0
        self.pongs = 0              # heartbeat replies seen (freshness)
        self.tenants: dict = {}     # last reported tenant packing stats
        self.oldest_age_s = 0.0     # last reported oldest queued request
        self.metrics: dict = {}     # last obs registry snapshot (pong)
        self.health: dict = {}      # last health report (pong)
        self.incidents: list = []   # flight-recorder bundle paths (pong)
        self.n = None

    def __repr__(self):
        state = "alive" if self.alive else "dead"
        return (f"WorkerHandle({self.worker_id}, {state}, "
                f"inflight={len(self.inflight)}, applied={self.applied})")


class Dispatcher:
    """Multi-process request router with gossiped window reconciliation."""

    def __init__(self, workers: List[WorkerHandle], *,
                 route: str = "round_robin", gossip: bool = True,
                 clock=time.perf_counter, registry=None,
                 tracer: Optional[Tracer] = None):
        if route not in ROUTES:
            raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
        if not workers:
            raise ValueError("a fleet needs at least one worker")
        self.workers = list(workers)
        self.route = route
        self.gossip = bool(gossip)
        self.clock = clock
        self.ring = HashRing(str(w.worker_id) for w in self.workers)
        self.log: Optional[GossipLog] = None
        # front-tier accounting reports under "fleet.*" so it never
        # double-counts the workers' own "serve.*" series in a merge
        self.registry = registry
        self.metrics = ServerMetrics(registry=registry, prefix="fleet")
        # always own a tracer (bounded ring, negligible when idle): it is
        # the stitching point for worker-shipped spans either way
        self.tracer = tracer if tracer is not None else Tracer()
        self._uid = 0
        self._order: List[int] = []          # submit order (FIFO flush)
        self._results: Dict[int, SolveResult] = {}
        self._rr = 0
        self._drained: set = set()
        self._acks: Dict[int, dict] = {}     # worker_id -> last ckpt_ok
        self.assignments: Dict[int, int] = {}   # uid -> serving worker_id

    # -- wiring ------------------------------------------------------------
    def init_workers(self, meta: dict,
                     arrays: Optional[dict] = None) -> None:
        """Send every worker its init frame and wait for ``init_ok``.
        ``meta["gossip"]`` is forced to this dispatcher's mode; the shared
        window size from the acks seeds the ``GossipLog``."""
        frame = encode_frame("init", {**meta, "gossip": self.gossip}, arrays)
        for w in self.workers:
            w.chan.send_frame(frame, "init")
        n = None
        for w in self.workers:
            msg = w.chan.recv(timeout=600.0)
            if msg.kind == "error":
                # a worker that cannot build its replica (no card, a
                # kernel that fails to build or launch) says why
                raise RuntimeError(f"worker {w.worker_id} failed init: "
                                   f"{msg.meta.get('message')}")
            if msg.kind != "init_ok":
                raise WireError(f"worker {w.worker_id} failed init: "
                                f"{msg.kind} {msg.meta}")
            w.n = int(msg.meta["n"])
            n = w.n if n is None else n
            if w.n != n:
                raise WireError(f"worker {w.worker_id} window n={w.n} "
                                f"disagrees with fleet n={n}")
        if self.gossip:
            self.log = GossipLog(n)

    # -- request intake ----------------------------------------------------
    def submit(self, v, *, damping: Optional[float] = None, tokens: int = 1,
               rows=None, adapter: Optional[str] = None,
               tenant: Optional[str] = None,
               worker_id: Optional[int] = None) -> int:
        """Route one solve request; returns its fleet-wide uid.

        ``rows`` (adaptation score rows) are admitted to the gossip log —
        slots allocated, event broadcast fleet-wide — before the solve is
        routed, so the fold's identity is independent of routing and of
        worker failures. With gossip off they ride the solve frame and
        fold only on the routed worker.

        ``tenant`` marks the request for a per-tenant delta on the routed
        worker: its rows are *tenant-private* — they always ride the solve
        frame and fold into that tenant's rank-r delta, never the shared
        gossip log. The tenant id doubles as the placement key under
        ``by_adapter`` routing (unless ``adapter`` says otherwise), so one
        tenant's delta, journal, and factor cache live on one worker.
        ``worker_id`` pins the request to one worker (probes); routing
        policy decides otherwise.
        """
        uid = self._uid
        self._uid += 1
        # tensors leave their device once, here: the ledger, the log and
        # every frame (replays included) hold host arrays
        v = to_host(v)
        rows = None if rows is None else to_host(rows)
        shared_rows = rows is not None and tenant is None
        req = _Request(uid=uid, v=v, damping=damping, tokens=int(tokens),
                       adapter=adapter if adapter is not None else tenant,
                       tenant=tenant,
                       rows=None if (shared_rows and self.gossip) else rows,
                       t_submit=self.clock())
        if shared_rows and self.gossip:
            ev = self.log.append(rows, origin=f"req{uid}")
            self._broadcast_fold(ev)
        w = self._worker_by_id(worker_id) if worker_id is not None \
            else self._route_worker(req)
        self._send_solve(w, req)
        self._order.append(uid)
        return uid

    def _send_solve(self, w: WorkerHandle, req: _Request) -> None:
        # the trace id rides the solve frame: worker-side spans tagged
        # with it stitch to this request across the process boundary
        arrays, meta = {}, {"uid": req.uid, "damping": req.damping,
                            "tokens": req.tokens, "adapter": req.adapter,
                            "tenant": req.tenant, "trace": f"req{req.uid}"}
        put_blocks(arrays, meta, "v", req.v)
        if req.rows is not None:
            put_blocks(arrays, meta, "rows", req.rows)
        req.worker_id = w.worker_id
        self.assignments[req.uid] = w.worker_id
        w.inflight[req.uid] = req
        try:
            w.chan.send("solve", meta, arrays)
        except WireError:
            self._on_failure(w)          # re-routes req (and any others)

    def _broadcast_fold(self, ev) -> None:
        arrays, meta = {}, {"seq": ev.seq, "slots": list(ev.slots),
                            "origin": ev.origin}
        put_blocks(arrays, meta, "rows", ev.rows)
        frame = encode_frame("fold", meta, arrays)
        for w in self._alive():
            try:
                w.chan.send_frame(frame, "fold")
            except WireError:
                self._on_failure(w)

    # -- routing -----------------------------------------------------------
    def _alive(self) -> List[WorkerHandle]:
        ws = [w for w in self.workers if w.alive]
        if not ws:
            raise RuntimeError("no alive workers left in the fleet")
        return ws

    def _worker_by_id(self, worker_id: int) -> WorkerHandle:
        for w in self._alive():
            if w.worker_id == worker_id:
                return w
        raise RuntimeError(f"worker {worker_id} is not alive")

    def _route_worker(self, req: _Request) -> WorkerHandle:
        alive = self._alive()
        if self.route == "by_adapter" and req.adapter is not None:
            # ring lookup skipping dead members: healthy placements never
            # move; a dead worker's keys spill to its ring successors
            dead = {str(w.worker_id) for w in self.workers if not w.alive}
            wid = self.ring.lookup(str(req.adapter), avoid=dead)
            return self._worker_by_id(int(wid))
        if self.route == "least_loaded":
            self._pump(0.0)          # drain landed results: current counts
            alive = self._alive()    # the pump may have buried a worker
            # numerically-critical replicas (heartbeat health verdict)
            # take new traffic only when nothing healthier is left:
            # their resident factor needs a refresh, not more load
            healthy = [w for w in alive
                       if w.health.get("verdict") != "critical"]
            return min(healthy or alive,
                       key=lambda w: (len(w.inflight), w.queued,
                                      w.worker_id))
        self._rr += 1
        return alive[self._rr % len(alive)]

    # -- frame pump --------------------------------------------------------
    def _pump(self, timeout: float = 0.1) -> int:
        """Read every frame ready on any alive channel; returns count."""
        alive = [w for w in self.workers if w.alive]
        if not alive:
            return 0
        try:
            ready, _, _ = select.select([w.chan for w in alive], [], [],
                                        timeout)
        except (OSError, ValueError):
            # a socket died between liveness check and select
            for w in alive:
                try:
                    w.chan.fileno()
                except (OSError, ValueError):
                    self._on_failure(w)
            return 0
        handled = 0
        for chan in ready:
            w = next(w for w in self.workers if w.chan is chan)
            try:
                while w.alive and w.chan.poll(0.0):
                    self._handle(w, w.chan.recv(timeout=30.0))
                    handled += 1
            except WireError:
                self._on_failure(w)
        return handled

    def _handle(self, w: WorkerHandle, msg) -> None:
        if msg.kind == "result":
            spans = msg.meta.get("spans")
            if spans:       # worker-recorded spans stitch in, pid intact
                self.tracer.ingest(spans)
            uid = int(msg.meta["uid"])
            req = w.inflight.pop(uid, None)
            if req is None:              # replayed elsewhere already
                return
            t_done = self.clock()
            x = get_blocks(msg, "x")
            self.metrics.record(req.t_submit, t_done, req.tokens)
            rpc_us = (t_done - req.t_submit) * 1e6
            self.tracer.add(
                "rpc", cat="fleet", ts_us=time.time() * 1e6 - rpc_us,
                dur_us=rpc_us, trace=f"req{uid}",
                args={"uid": uid, "worker": w.worker_id})
            w.served += 1
            self._results[uid] = SolveResult(
                uid=uid, x=x, damping=float(msg.meta["damping"]),
                latency_s=t_done - req.t_submit)
        elif msg.kind == "pong":
            w.applied = int(msg.meta.get("applied", w.applied))
            w.queued = int(msg.meta.get("queued", 0))
            w.served = int(msg.meta.get("served", w.served))
            w.tenants = msg.meta.get("tenants", w.tenants) or {}
            w.oldest_age_s = float(msg.meta.get("oldest_age_s", 0.0))
            w.metrics = msg.meta.get("metrics", w.metrics) or {}
            w.health = msg.meta.get("health", w.health) or {}
            w.incidents = msg.meta.get("incidents", w.incidents) or []
            w.pongs += 1
        elif msg.kind == "drained":
            self._drained.add(w.worker_id)
        elif msg.kind == "ckpt_ok":
            self._acks[w.worker_id] = msg.meta
        elif msg.kind == "error":
            raise RuntimeError(f"worker {w.worker_id} failed: "
                               f"{msg.meta.get('message')}")
        else:
            raise WireError(f"unexpected frame {msg.kind!r} from worker "
                            f"{w.worker_id}")

    # -- failure rerouting -------------------------------------------------
    def _on_failure(self, w: WorkerHandle) -> None:
        """Mark ``w`` dead and replay its in-flight requests elsewhere."""
        if not w.alive:
            return
        w.alive = False
        w.chan.close()
        if w.proc is not None:
            w.proc.poll()
        orphans = sorted(w.inflight.values(), key=lambda r: r.uid)
        w.inflight.clear()
        self._alive()                    # raises when nobody is left
        for req in orphans:
            self._send_solve(self._route_worker(req), req)

    # -- the serve API -----------------------------------------------------
    def pending(self) -> int:
        return sum(len(w.inflight) for w in self.workers if w.alive)

    def flush(self, *, timeout: Optional[float] = 120.0
              ) -> List[SolveResult]:
        """Block until every submitted request has a result; return them
        in submit order (the eager server's FIFO contract)."""
        deadline = None if timeout is None else self.clock() + timeout
        while self.pending():
            left = None if deadline is None else deadline - self.clock()
            if left is not None and left <= 0:
                raise TimeoutError(
                    f"{self.pending()} request(s) still in flight")
            self._pump(0.05 if left is None else min(0.05, left))
        out = []
        remaining = []
        for uid in self._order:
            res = self._results.pop(uid, None)
            if res is not None:
                out.append(res)
            else:
                remaining.append(uid)
        self._order = remaining
        return out

    def reconcile(self, *, timeout: Optional[float] = 120.0) -> None:
        """Barrier: every alive worker has applied the full gossip log.
        Afterwards all replicas hold the bit-identical reconciled window
        (same initial state, same events, same order)."""
        if self.log is None:
            return
        deadline = None if timeout is None else self.clock() + timeout
        while True:
            lagging = [w for w in self._alive()
                       if w.applied < self.log.head]
            if not lagging:
                return
            for w in lagging:
                try:
                    w.chan.send("ping", {"barrier": True})
                except WireError:
                    self._on_failure(w)
            self._pump(0.05)
            if deadline is not None and self.clock() > deadline:
                raise TimeoutError(
                    f"reconcile stalled: {[(w.worker_id, w.applied) for w in lagging]} "
                    f"behind log head {self.log.head}")

    def probe(self, v, *, damping: Optional[float] = None,
              timeout: Optional[float] = 120.0) -> Dict[int, Any]:
        """Solve the same RHS on every alive worker (bypasses routing) —
        the reconciliation agreement check. Returns {worker_id: x}.
        Call on a drained dispatcher: the flush inside would swallow any
        unrelated trace results."""
        if self._order or self.pending():
            raise RuntimeError("probe on a busy dispatcher would drop "
                               "pending trace results; flush() first")
        uids = {w.worker_id: self.submit(v, damping=damping,
                                         worker_id=w.worker_id)
                for w in self._alive()}
        results = {r.uid: r for r in self.flush(timeout=timeout)}
        return {wid: results[uid].x for wid, uid in uids.items()
                if uid in results}

    def heartbeat(self, *, timeout: float = 10.0) -> Dict[int, dict]:
        """Ping every alive worker and wait for the *replies* (a report
        built from pre-ping handle state would be stale); returns their
        load reports."""
        baseline = {w.worker_id: w.pongs for w in self._alive()}
        for w in self._alive():
            try:
                w.chan.send("ping", {})
            except WireError:
                self._on_failure(w)
        deadline = self.clock() + timeout
        while any(w.pongs == baseline.get(w.worker_id, 0)
                  for w in self._alive()) and self.clock() < deadline:
            self._pump(0.05)
        return {w.worker_id: {"applied": w.applied,
                              "queued": w.queued,
                              "queue_depth": w.queued,
                              "oldest_age_s": w.oldest_age_s,
                              "served": w.served,
                              "inflight": len(w.inflight),
                              "tenants": w.tenants,
                              "verdict": w.health.get("verdict", "ok")}
                for w in self._alive()}

    def fleet_metrics(self, *, refresh: bool = True,
                      timeout: float = 10.0) -> dict:
        """One merged registry snapshot for the whole fleet: the workers'
        obs snapshots (shipped in heartbeat pongs) folded together with
        the dispatcher's own front-tier registry. Worker histograms sum
        per bucket, so fleet percentiles come from merged buckets
        (``obs.quantile``). ``refresh=False`` merges the last-seen pongs
        without pinging."""
        if refresh:
            self.heartbeat(timeout=timeout)
        snaps = [w.metrics for w in self.workers if w.metrics]
        if self.registry is not None:
            snaps.append(self.registry.snapshot())
        return merge_snapshots(snaps)

    def fleet_health(self, *, refresh: bool = True,
                     timeout: float = 10.0) -> dict:
        """One merged health view for the whole fleet: the workers' health
        reports (shipped in heartbeat pongs next to the metrics snapshot)
        folded by ``obs.merge_health`` — worst member verdict wins, active
        rules union at worst severity, recent events interleave by
        timestamp. ``refresh=False`` merges the last-seen pongs without
        pinging."""
        if refresh:
            self.heartbeat(timeout=timeout)
        return merge_health(w.health for w in self.workers if w.alive)

    def collect_incidents(self, *, refresh: bool = True,
                          timeout: float = 10.0) -> Dict[int, list]:
        """Gather the fleet's flight-recorder incident bundles: a map
        ``{worker_id: [bundle paths]}`` built from the paths workers ship
        in heartbeat pongs. The bundles themselves stay on each worker's
        disk (shared-filesystem deployments can feed them straight to
        ``python -m repro_torch.obs.forensics``). Dead workers keep their
        last-reported list — exactly the bundles a postmortem wants.
        ``refresh=False`` reads the last-seen pongs without pinging."""
        if refresh:
            self.heartbeat(timeout=timeout)
        return {w.worker_id: list(w.incidents)
                for w in self.workers if w.incidents}

    # -- checkpoint --------------------------------------------------------
    def checkpoint(self, ckpt_dir, step: int, *,
                   timeout: Optional[float] = 300.0) -> pathlib.Path:
        """Fleet checkpoint: each worker saves its ServeState + journal
        under ``<dir>/worker_<id>``, the dispatcher writes the manifest
        (routing mode, gossip head, per-worker paths) next to them."""
        from repro_torch.checkpoint.fleet import save_fleet_manifest
        ckpt_dir = pathlib.Path(ckpt_dir)
        self._acks = {}
        for w in self._alive():
            w.chan.send("ckpt", {"dir": str(ckpt_dir / f"worker_{w.worker_id}"),
                                 "step": int(step)})
        deadline = None if timeout is None else self.clock() + timeout
        while len(self._acks) < len(self._alive()):
            self._pump(0.05)
            if deadline is not None and self.clock() > deadline:
                raise TimeoutError(f"checkpoint acks: {sorted(self._acks)}")
        if self.log is not None:
            gossip_path = ckpt_dir / f"gossip_{int(step):09d}.npz"
            ckpt_dir.mkdir(parents=True, exist_ok=True)
            self.log.journal.save(gossip_path)
        else:
            gossip_path = None
        manifest = {
            "step": int(step), "route": self.route, "gossip": self.gossip,
            "gossip_head": None if self.log is None else self.log.head,
            "gossip_base": None if self.log is None else self.log.base,
            "gossip_journal": None if gossip_path is None
            else gossip_path.name,
            "workers": {str(w.worker_id): self._acks[w.worker_id]
                        for w in self._alive()},
            # last-seen flight-recorder bundle paths ride the manifest so
            # a postmortem starting from the checkpoint knows where the
            # incident evidence lives without a live fleet to ask
            "incidents": {str(w.worker_id): list(w.incidents)
                          for w in self.workers if w.incidents},
        }
        path = save_fleet_manifest(ckpt_dir, step, manifest)
        if self.log is not None:
            # the npz + every worker's own checkpoint now cover the applied
            # prefix: truncate it so long traces stop accumulating (k, m)
            # rows in RAM; replay for a rejoiner = restore + since(tail)
            applied = [w.applied for w in self._alive()]
            if applied:
                self.log.compact(min(applied))
        return path

    # -- lifecycle ---------------------------------------------------------
    def shutdown(self, *, drain: bool = True,
                 timeout: Optional[float] = 60.0) -> None:
        """Drain (serve everything submitted, reconcile) and stop the
        fleet; subprocess workers are joined, then killed past the
        timeout."""
        if drain:
            try:
                self.flush(timeout=timeout)
                self.reconcile(timeout=timeout)
                self._drained = set()
                for w in self._alive():
                    try:
                        w.chan.send("drain", {})
                    except WireError:
                        self._on_failure(w)
                deadline = self.clock() + (timeout or 60.0)
                while any(w.alive and w.worker_id not in self._drained
                          for w in self.workers) \
                        and self.clock() < deadline:
                    self._pump(0.05)
            except (RuntimeError, TimeoutError):
                pass    # fleet died or drain stalled: still tear down
                        # channels and reap subprocesses below
        for w in self.workers:
            if w.alive:
                try:
                    w.chan.send("bye", {})
                except WireError:
                    pass
            w.chan.close()
            w.alive = False
        for w in self.workers:
            if w.proc is not None:
                try:
                    w.proc.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    w.proc.kill()
                    w.proc.wait()

    def __enter__(self) -> "Dispatcher":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown(drain=exc_type is None)


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------

def _repro_pythonpath() -> str:
    """PYTHONPATH that makes ``repro_torch`` importable in a worker
    subprocess: the port's ``src`` first."""
    import repro_torch
    pkg_dir = os.path.dirname(os.path.abspath(repro_torch.__file__))
    src = os.path.dirname(pkg_dir)
    current = os.environ.get("PYTHONPATH", "")
    return src if not current else f"{src}{os.pathsep}{current}"


def launch_fleet(n_workers: int, *, init_meta: dict,
                 init_arrays: Optional[dict] = None,
                 route: str = "round_robin", gossip: bool = True,
                 worker_env: Optional[dict] = None,
                 spawn_timeout: float = 300.0,
                 registry=None, device=None) -> Dispatcher:
    """Spawn ``n_workers`` subprocess workers on localhost and return the
    initialized ``Dispatcher``.

    Rendezvous is reversed (workers connect *to* the dispatcher's
    ephemeral listener) so there is no port-assignment race. ``init_meta``
    / ``init_arrays`` form the init frame every worker receives — e.g.
    ``{"mode": "inline", "damping": 1e-2}`` with ``{"S0": window}``.
    ``device``: the workers' torch device (``--device``; default CUDA,
    "cpu" runs the plain versions). CUDA workers find the kernels built:
    this process builds them first (a no-op when the build exists).
    """
    device = "cuda" if device is None else str(device)
    if device.startswith("cuda"):
        from repro_torch.kernels import _build
        _build.build()
    srv, port = listen()
    srv.settimeout(spawn_timeout)
    env = {**os.environ, "PYTHONPATH": _repro_pythonpath(),
           **(worker_env or {})}
    procs = []
    handles: Dict[int, WorkerHandle] = {}
    chan = None                  # the connection being greeted
    try:
        for i in range(n_workers):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.fleet",
                 "--connect", f"127.0.0.1:{port}", "--worker-id", str(i),
                 "--device", device], env=env))
        while len(handles) < n_workers:
            sock, _ = srv.accept()
            sock.settimeout(None)
            chan = Channel(sock)
            hello = chan.recv(timeout=spawn_timeout)
            if hello.kind != "hello":
                raise WireError(f"expected hello, got {hello.kind}")
            wid = int(hello.meta["worker_id"])
            handles[wid] = WorkerHandle(wid, chan, proc=procs[wid])
            chan = None
    except BaseException:
        # rendezvous failed: reap every spawned worker — the ones that
        # did connect are blocked in recv() and would orphan otherwise
        if chan is not None:
            chan.close()
        for h in handles.values():
            h.chan.close()
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        raise
    finally:
        srv.close()
    dispatcher = Dispatcher([handles[i] for i in range(n_workers)],
                            route=route, gossip=gossip, registry=registry)
    try:
        dispatcher.init_workers(init_meta, init_arrays)
    except BaseException:
        dispatcher.shutdown(drain=False, timeout=10.0)
        raise
    return dispatcher
