"""Decoder-only language models (torch port of ``repro.models``): the
configuration, the layers dense attention needs, the LM trunk with its
prefill and decode paths, and the family API the serving front talks to.
"""
from repro_torch.models.api import ModelAPI, get_api
from repro_torch.models.config import BlockSlot, ModelConfig

__all__ = ["BlockSlot", "ModelAPI", "ModelConfig", "get_api"]
