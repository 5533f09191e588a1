"""Core solver library — the paper's damped-NGD dual solve and its
baselines (torch port of ``repro.core``)."""
from repro_torch.core.damping import (
    ConstantDamping,
    DampingState,
    LevenbergMarquardtDamping,
    auto_drift_tol,
)
from repro_torch.core.operator import (
    BlockedScores,
    LazyBlockedScores,
    ScoreOperator,
    as_blocked_vector,
    block_norm,
    is_blocked,
)
from repro_torch.core.solvers import (
    SOLVERS,
    CholFactorization,
    SolverStats,
    center_scores,
    cg_solve,
    chol_factorize,
    chol_solve,
    direct_solve,
    eigh_solve,
    get_solver,
    gram,
    gram_chunked,
    minsr_solve,
    residual,
    svd_solve,
)
# after the solvers: core.distributed imports kernels.ops, which imports
# core.operator and core.solvers
from repro_torch.core.distributed import (  # noqa: E402
    make_sharded_solver,
    sharded_blocked_chol_solve,
    sharded_chol_solve,
    sharded_chol_solve_2d,
)

__all__ = [
    "SOLVERS", "BlockedScores", "CholFactorization", "ConstantDamping",
    "DampingState", "LazyBlockedScores", "LevenbergMarquardtDamping",
    "ScoreOperator", "SolverStats", "as_blocked_vector", "auto_drift_tol",
    "block_norm", "center_scores", "cg_solve", "chol_factorize",
    "chol_solve", "direct_solve", "eigh_solve", "get_solver", "gram",
    "gram_chunked", "is_blocked", "make_sharded_solver", "minsr_solve",
    "residual", "sharded_blocked_chol_solve", "sharded_chol_solve",
    "sharded_chol_solve_2d", "svd_solve",
]
