"""Single-file npz bundles (port of ``repro/checkpoint/fleet.py``'s
``save_npz_bundle`` / ``load_npz_bundle``): named numpy arrays plus a JSON
meta blob under ``__meta__``, written atomically (.tmp → fsync →
rename), so readers never see a torn file. The flight recorder's incident
bundles use it; a bundle written by either package loads in the other.
The fleet manifests and the tenants' spill that the reference keeps in
this module come with the fleet and tenants (``repro_torch.roadmap``).
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Tuple

import numpy as np

__all__ = ["save_npz_bundle", "load_npz_bundle"]


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
