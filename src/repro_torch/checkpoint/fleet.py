"""Single-file npz bundles (port of ``repro/checkpoint/fleet.py``'s
``save_npz_bundle`` / ``load_npz_bundle``): named numpy arrays plus a JSON
meta blob under ``__meta__``, written atomically (.tmp → fsync →
rename), so readers never see a torn file. The flight recorder's incident
bundles and the tenant manager's spills (``save_tenant_spill``) use it; a
bundle written by either package loads in the other. The fleet manifests
that the reference keeps in this module come with the fleet
(``repro_torch.roadmap``).
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Tuple

import numpy as np
import torch

__all__ = ["save_npz_bundle", "load_npz_bundle", "save_tenant_spill",
           "load_tenant_spill"]


def save_npz_bundle(path, arrays: dict, meta: dict) -> pathlib.Path:
    """Named numpy arrays + a JSON meta blob in one npz, written
    atomically. ``meta`` must be JSON-serializable."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {k: np.asarray(v) for k, v in arrays.items()}
    payload["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), np.uint8)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    tmp.rename(path)
    return path


def load_npz_bundle(path) -> Tuple[dict, dict]:
    """Inverse of ``save_npz_bundle``: returns (arrays, meta)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return arrays, meta


def _host(a) -> np.ndarray:
    """A host numpy array of ``a``; a bf16 tensor as raw two-byte records
    (``|V2``), as numpy writes the reference's bfloat16 arrays."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(a)


def save_tenant_spill(path, arrays: dict, meta: dict) -> pathlib.Path:
    """Spill one tenant's delta (tenant id, journal position in ``meta``)
    — the npz-bundle format under its historical name. Tensors on any
    device are written from a host copy."""
    return save_npz_bundle(path, {k: _host(v) for k, v in arrays.items()},
                           meta)


def load_tenant_spill(path) -> Tuple[dict, dict]:
    """Inverse of ``save_tenant_spill``: returns (arrays, meta), numpy
    arrays as stored (bf16 as ``|V2`` records)."""
    return load_npz_bundle(path)
