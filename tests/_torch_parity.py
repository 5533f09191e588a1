"""Shared inputs for the torch-port parity tests: one numpy draw handed to
both packages with identical bits (bf16 rounded once, through ml_dtypes).
JAX is imported on use: the GPU machine, which runs only the ``cuda``
tests, has none."""
import contextlib
import os

import numpy as np
import torch


def pair(x: np.ndarray, dtype: str = "float32"):
    """(jax array, torch tensor) holding the same values of ``dtype``."""
    import jax.numpy as jnp
    import ml_dtypes
    if dtype == "bfloat16":
        b = np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)
        return (jnp.asarray(b),
                torch.from_numpy(b.view(np.int16).copy()).view(torch.bfloat16))
    a = np.ascontiguousarray(np.asarray(x).astype(dtype))
    return jnp.asarray(a), torch.from_numpy(a.copy())


def rel(a, b) -> float:
    """max |a − b| / max |b| (complex-aware, computed in float64)."""
    def host(t):
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.float()
            return t.numpy()
        return np.asarray(t)
    a = host(a).astype(np.complex128)
    b = host(b).astype(np.complex128)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@contextlib.contextmanager
def reference_dryrun():
    """``repro.launch.dryrun``, imported after JAX has its devices: the
    import sets ``XLA_FLAGS`` (512 host devices) and the compilation-cache
    variables for its own process, and they are restored on exit."""
    import jax
    jax.devices()
    names = ("XLA_FLAGS", "JAX_COMPILATION_CACHE_DIR",
             "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS")
    saved = {k: os.environ.get(k) for k in names}
    try:
        from repro.launch import dryrun
        yield dryrun
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
