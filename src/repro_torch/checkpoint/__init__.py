"""Checkpoints (port of ``repro.checkpoint``): the atomic step directory of
``checkpoint.py``, in the reference's on-disk layout, and ``fleet.py``'s
fleet manifests and npz bundles (whose tenant spill the tenant manager
uses)."""
from repro_torch.checkpoint.checkpoint import (all_steps, latest_step,
                                               restore, save)
from repro_torch.checkpoint.fleet import (latest_fleet_step,
                                          load_fleet_manifest,
                                          load_npz_bundle,
                                          save_fleet_manifest,
                                          save_npz_bundle)

__all__ = ["all_steps", "latest_step", "restore", "save",
           "latest_fleet_step", "load_fleet_manifest", "load_npz_bundle",
           "save_fleet_manifest", "save_npz_bundle"]
