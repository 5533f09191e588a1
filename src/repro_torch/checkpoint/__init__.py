"""Checkpoints (port of ``repro.checkpoint``): the atomic step directory of
``checkpoint.py``, in the reference's on-disk layout. The fleet's
manifests and npz bundles (``checkpoint/fleet.py``) come with tenants
(``repro_torch.roadmap``)."""
from repro_torch.checkpoint.checkpoint import (all_steps, latest_step,
                                               restore, save)

__all__ = ["all_steps", "latest_step", "restore", "save"]
