"""Checkpoints (port of ``repro.checkpoint``): the atomic step directory of
``checkpoint.py``, in the reference's on-disk layout, and the npz bundles
of ``fleet.py`` (whose tenant spill the tenant manager uses). The
fleet's manifests come with a later slice (``repro_torch.roadmap``)."""
from repro_torch.checkpoint.checkpoint import (all_steps, latest_step,
                                               restore, save)
from repro_torch.checkpoint.fleet import load_npz_bundle, save_npz_bundle

__all__ = ["all_steps", "latest_step", "restore", "save",
           "load_npz_bundle", "save_npz_bundle"]
