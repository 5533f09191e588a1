"""Optimizers (torch port of ``repro.optim``): damped NGD (the paper),
AdamW, learning-rate schedules, per-sample score construction, and the
conversion of a parameter tree between numpy arrays (the JAX package's
``jax.device_get`` form) and tensors; the hybrid optimizer (NGD on a
subtree, AdamW elsewhere) and the compressed all-reduce over a mesh's
per-position gradients.
"""
from repro_torch.core.pytree import params_from_arrays, params_to_arrays
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.optim.compress import (EFState, Int8ErrorFeedback,
                                        bf16_allreduce)
from repro_torch.optim.hybrid import (HybridNGD, HybridState, merge_params,
                                      partition_params, path_of)
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
    "AdamW", "AdamWState", "EFState", "HybridNGD", "HybridState",
    "Int8ErrorFeedback", "NaturalGradient", "NGDState", "bf16_allreduce",
    "constant", "flatten_like", "global_norm", "lazy_score_blocks",
    "make_fisher_matvec", "merge_params", "params_from_arrays",
    "params_to_arrays", "partition_params", "path_of",
    "per_sample_score_blocks", "per_sample_scores", "warmup_cosine",
    "warmup_linear",
]
