"""Core solver library — the paper's damped-NGD dual solve (torch port)."""
from repro_torch.core.damping import (
    ConstantDamping,
    DampingState,
    LevenbergMarquardtDamping,
    auto_drift_tol,
)
from repro_torch.core.operator import (
    BlockedScores,
    as_blocked_vector,
    block_norm,
    is_blocked,
)
from repro_torch.core.solvers import (
    CholFactorization,
    SolverStats,
    chol_factorize,
    gram,
    residual,
)

__all__ = [
    "BlockedScores", "CholFactorization", "ConstantDamping", "DampingState",
    "LevenbergMarquardtDamping", "SolverStats", "as_blocked_vector",
    "auto_drift_tol", "block_norm", "chol_factorize", "gram", "is_blocked",
    "residual",
]
