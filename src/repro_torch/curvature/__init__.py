"""Streaming curvature (torch port of ``repro.curvature``): the damped-Fisher
factorization as a maintained, reusable artifact.

* ``update``    — rank-k Cholesky update/downdate (the plain composed and
  rotation methods; ``kernels.ops.cholupdate`` runs the CUDA rotation
  kernel under ``CholFactorization.update``/``downdate``) and the window
  algebra (append, drop-leading, symmetric row replacement).
* ``streaming`` — ``StreamingGram``: the Gram folded over microbatch or
  per-layer pieces into one (n, n) accumulator, for
  ``chol_factorize(..., W=...)``.
* ``cache``     — ``StreamingCurvature`` / ``CurvatureCache``: the Gram
  carried across steps with age- and drift-triggered refreshes and
  re-damping at every λ.
* ``audit``     — the Hager/Higham condition estimate and the Hutchinson
  factor-residual probe of the resident factor, O(n²) each.

``NaturalGradient(curvature=...)`` and the trainer's ``--curvature
streaming`` come with the trainer slice.
"""
from repro_torch.curvature.audit import (
    FactorAudit,
    audit_factor,
    condest,
    factor_residual_probe,
)
from repro_torch.curvature.cache import (
    CurvatureCache,
    CurvatureState,
    CurvatureStats,
    StreamingCurvature,
)
from repro_torch.curvature.streaming import StreamingGram, accumulate_gram
from repro_torch.curvature.update import (
    DowndateAux,
    chol_append,
    chol_downdate,
    chol_drop_leading,
    chol_update,
    replace_factors,
    signed_split,
)

__all__ = [
    "CurvatureCache", "CurvatureState", "CurvatureStats", "DowndateAux",
    "FactorAudit", "StreamingCurvature", "StreamingGram", "accumulate_gram",
    "audit_factor", "chol_append", "chol_downdate", "chol_drop_leading",
    "chol_update", "condest", "factor_residual_probe", "replace_factors",
    "signed_split",
]
