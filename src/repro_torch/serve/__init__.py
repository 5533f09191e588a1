"""Online NGD serving (torch port of ``repro.serve``): request-batched
damped-Fisher solves against the resident factorization.

* ``state``   — ``ServeState``: the resident window, Gram and factor;
  array round trip and checkpoints compatible with the JAX package.
* ``batcher`` — token-budget coalescing into multi-RHS microbatches.
* ``adapt``   — ``OnlineAdaptation``: FIFO folds by rank-k factor
  algebra, bounded staleness by age/drift refreshes, the journal,
  metrics, audit and health hooks.
* ``journal`` — ``FoldJournal``: folds and refreshes as replayable events.
* ``server``  — ``SolveServer``: submit → coalesce → solve → adapt.

* ``main``    — ``serve_main``/``serve_trace``: the LM serving loop
  (``python -m repro_torch.serve``), imported on use.

The concurrent and sharded server is ``repro_torch.dist``; tenants are
``repro_torch.tenants``.
"""
from repro_torch.serve.adapt import OnlineAdaptation
from repro_torch.serve.batcher import Microbatch, SolveRequest, TokenBudgetBatcher
from repro_torch.serve.journal import FoldEvent, FoldJournal
from repro_torch.serve.server import ServerMetrics, SolveResult, SolveServer
from repro_torch.serve.state import (
    ServeState,
    ServeStats,
    as_factorization,
    init_serve_state,
    restore_serve_state,
    save_serve_state,
    serve_mode,
    serve_state_arrays,
    serve_state_from_arrays,
)

__all__ = [
    "FoldEvent", "FoldJournal", "Microbatch", "OnlineAdaptation",
    "ServeState", "ServeStats", "ServerMetrics", "SolveRequest",
    "SolveResult", "SolveServer", "TokenBudgetBatcher", "as_factorization",
    "init_serve_state", "restore_serve_state", "save_serve_state",
    "serve_mode", "serve_state_arrays", "serve_state_from_arrays",
]
