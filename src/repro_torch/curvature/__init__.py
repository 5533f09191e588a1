"""Streaming curvature (torch port): the rank-k factor algebra of
``repro.curvature.update``. ``StreamingGram``, ``CurvatureCache`` and the
audit come with the trainer slice."""
from repro_torch.curvature.update import (
    DowndateAux,
    chol_append,
    chol_downdate,
    chol_drop_leading,
    chol_update,
    replace_factors,
    signed_split,
)

__all__ = ["DowndateAux", "chol_append", "chol_downdate", "chol_drop_leading",
           "chol_update", "replace_factors", "signed_split"]
