"""Online NGD serving (torch port of ``repro.serve``): request-batched
damped-Fisher solves against the resident factorization.

* ``state``   — ``ServeState``: the resident window, Gram and factor;
  array round trip compatible with the JAX package.
* ``batcher`` — token-budget coalescing into multi-RHS microbatches.
* ``adapt``   — ``OnlineAdaptation``: FIFO folds by rank-k factor
  algebra, bounded staleness by age/drift refreshes.
* ``server``  — ``SolveServer``: submit → coalesce → solve → adapt.

* ``main``    — ``serve_main``/``serve_trace``: the LM serving loop
  (``python -m repro_torch.serve``), imported on use.

The journal, checkpoints, tenants and observability hooks come with later
slices.
"""
from repro_torch.serve.adapt import OnlineAdaptation
from repro_torch.serve.batcher import Microbatch, SolveRequest, TokenBudgetBatcher
from repro_torch.serve.server import ServerMetrics, SolveResult, SolveServer
from repro_torch.serve.state import (
    ServeState,
    ServeStats,
    as_factorization,
    init_serve_state,
    serve_mode,
    serve_state_arrays,
    serve_state_from_arrays,
)

__all__ = [
    "Microbatch", "OnlineAdaptation", "ServeState", "ServeStats",
    "ServerMetrics", "SolveRequest", "SolveResult", "SolveServer",
    "TokenBudgetBatcher", "as_factorization", "init_serve_state",
    "serve_mode",
    "serve_state_arrays", "serve_state_from_arrays",
]
