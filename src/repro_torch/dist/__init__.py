"""The sharded serving tier (torch port of ``repro.dist``): the resident
factorization laid out on a mesh and served concurrently.

* ``state``      — ``DistSpec`` (mesh + layout) and ``ShardedServeState``:
  the window as per-position pieces (``ShardedWindow``), the factor and
  the FIFO metadata replicated; uneven windows zero-padded to the mesh;
  checkpoints in the reference's leaves.
* ``cholupdate`` — the rank-k factor maintenance over the mesh: the
  per-slab fold cross pass (``ops.fold_cols``), the replicated core split
  and update, the per-slab refresh (``ops.gram``/``gram_acc``, then
  ``ops.cholesky``), and the rank-k update with its columns sharded
  (composed, or a ring of rotation sweeps on ``ops.cholupdate``) — for
  the 1d, 2d and blocked layouts of ``core.distributed``.
* ``server``     — ``AsyncSolveServer``: thread-safe submits, one worker
  that owns the device, responses that depend only on the order of the
  calls, the per-slab request path (``ops.sv_cross``, ``ops.trisolve``,
  ``ops.serve_apply``), an ordered ``apply_fold`` queue and a draining
  shutdown.

``launch.trainer.build_server(mesh=, layout=, async_=True)`` and
``python -m repro_torch.serve --mesh 1d|2d --async`` wire it end to end.
"""
from repro_torch.dist.cholupdate import (
    make_sharded_fold,
    make_sharded_refresh,
    sharded_chol_downdate,
    sharded_chol_update,
    sharded_window_cols,
)
from repro_torch.dist.server import (AsyncSolveServer,
                                     make_sharded_coalesced_solve)
from repro_torch.dist.state import (
    DistSpec,
    ShardedServeState,
    ShardedWindow,
    init_sharded_serve_state,
    pad_window_to_mesh,
    place_serve_state,
    restore_sharded_serve_state,
    save_sharded_serve_state,
    shard_window,
    sharded_serve_mode,
)

__all__ = [
    "AsyncSolveServer", "DistSpec", "ShardedServeState", "ShardedWindow",
    "init_sharded_serve_state", "make_sharded_coalesced_solve",
    "make_sharded_fold", "make_sharded_refresh", "pad_window_to_mesh",
    "place_serve_state", "restore_sharded_serve_state",
    "save_sharded_serve_state", "shard_window", "sharded_chol_downdate",
    "sharded_chol_update", "sharded_serve_mode", "sharded_window_cols",
]
