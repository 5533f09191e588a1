"""Workload shapes (port of ``repro/configs/shapes.py``) assigned to the LM-family architectures.

``long_500k`` needs sub-quadratic sequence handling: it RUNS for SSM and
hybrid archs and is SKIPPED for pure-full-attention archs (and for gemma2,
whose global layers are full attention) — DESIGN.md §Shape-cell skips.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WorkloadShape:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES = {
    "train_4k": WorkloadShape("train_4k", "train", 4_096, 256),
    "prefill_32k": WorkloadShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": WorkloadShape("decode_32k", "decode", 32_768, 128),
    "long_500k": WorkloadShape("long_500k", "decode", 524_288, 1),
}

# families whose decode cost/memory is sub-quadratic in context length
_LONG_OK = ("ssm", "hybrid")


def applicable(cfg, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return cfg.family in _LONG_OK
    return True


def cells(cfg):
    """All applicable (shape_name, WorkloadShape) for an arch config."""
    return [(n, s) for n, s in SHAPES.items() if applicable(cfg, n)]
