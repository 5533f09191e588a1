"""Optimizers (torch port of ``repro.optim``): damped NGD (the paper),
AdamW, learning-rate schedules, per-sample score construction, and the
conversion of a parameter tree between numpy arrays (the JAX package's
``jax.device_get`` form) and tensors.

Still to port: ``hybrid.py`` (NGD on a subtree, AdamW elsewhere) and
``compress.py`` (compressed all-reduce), with the sharded tier.
"""
from repro_torch.core.pytree import params_from_arrays, params_to_arrays
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.optim.ngd import NaturalGradient, NGDState, global_norm
from repro_torch.optim.schedules import constant, warmup_cosine, warmup_linear
from repro_torch.optim.scores import (
    flatten_like,
    lazy_score_blocks,
    make_fisher_matvec,
    per_sample_score_blocks,
    per_sample_scores,
)

__all__ = [
    "AdamW", "AdamWState", "NaturalGradient", "NGDState", "constant",
    "flatten_like", "global_norm", "lazy_score_blocks", "make_fisher_matvec",
    "params_from_arrays", "params_to_arrays", "per_sample_score_blocks",
    "per_sample_scores", "warmup_cosine", "warmup_linear",
]
