"""Shared inputs for the torch-port parity tests: one numpy draw handed to
both packages with identical bits (bf16 rounded once, through ml_dtypes).
JAX is imported on use: the GPU machine, which runs only the ``cuda``
tests, has none."""
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
