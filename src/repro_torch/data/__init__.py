"""Deterministic synthetic data and its placement over a mesh (port of
``repro.data``)."""
from repro_torch.data.pipeline import (SyntheticLM, place, prefetch,
                                       split_leading)

__all__ = ["SyntheticLM", "place", "prefetch", "split_leading"]
