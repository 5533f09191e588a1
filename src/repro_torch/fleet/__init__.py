"""Fleet serving — a multi-process front tier over the curvature service
(torch port of ``repro.fleet``).

``repro_torch.serve`` made the damped-Fisher factorization a served
asset; ``repro_torch.dist`` sharded it over one process's mesh. This
package adds the layer above: N serving *processes*, each holding a
window replica (eager or async, replicated or sharded) on its device,
behind a ``Dispatcher`` that owns no mesh — it routes ``SolveRequest``s
over localhost sockets and reconciles the replicas' online windows by
gossiping fold *events*.

* ``wire``       — length-prefixed JSON/npz frames, byte for byte the
  reference's; ``Channel`` over any stream socket; the only coupling
  between fleet processes. Tensors cross as host arrays (bf16 as ``|V2``
  records).
* ``gossip``     — ``GossipLog``: the dispatcher-owned total order of
  fold events (global FIFO slots allocated at admission), and
  ``ReplayBuffer``: strictly ordered ingestion at each replica. Replicas
  exchange the rank-k fold columns — O(k·m) — never factors or Grams;
  each replays them through the same fold path, so identical initial
  windows + identical order on one kind of device ⇒ bit-identical
  windows.
* ``worker``     — ``FleetWorker``: the frame loop around one replica
  (inline-seeded from the dispatcher or self-built via
  ``launch.trainer.build_server``); drains on SIGTERM.
* ``ring``       — ``HashRing``: consistent hashing for ``by_adapter``
  placement — adding/removing one worker remaps ~1/N of the key space,
  so tenant/adapter stickiness survives fleet resizes.
* ``dispatcher`` — ``Dispatcher``: routing (``round_robin``,
  ``least_loaded`` off streamed heartbeats, ``by_adapter`` sticky
  placement on the ring), failure rerouting with ledger replay, the
  ``reconcile()`` barrier, fleet checkpoint (per-worker ServeState +
  manifest, then gossip-log compaction), draining shutdown;
  ``launch_fleet`` spawns the subprocess workers
  (``python -m repro_torch.fleet``).

``launch.trainer.build_fleet(...)`` wires a config end to end;
``python -m repro_torch.serve --fleet N --route ...`` serves with it.
"""
from repro_torch.fleet.dispatcher import (
    Dispatcher,
    ROUTES,
    WorkerHandle,
    launch_fleet,
)
from repro_torch.fleet.gossip import GossipLog, ReplayBuffer
from repro_torch.fleet.ring import HashRing
from repro_torch.fleet.wire import (Channel, Message, WireError, connect,
                                    listen)
from repro_torch.fleet.worker import FleetWorker

__all__ = [
    "Channel", "Dispatcher", "FleetWorker", "GossipLog", "HashRing",
    "Message", "ROUTES", "ReplayBuffer", "WireError", "WorkerHandle",
    "connect", "launch_fleet", "listen",
]
