"""The model zoo (torch port of ``repro.models``): the configuration,
the layers, the LM trunk with its prefill and decode paths, the
encoder-decoder trunk, and the family API the serving front and the
trainer talk to.
"""
from repro_torch.models import encdec
from repro_torch.models.api import ModelAPI, get_api
from repro_torch.models.config import BlockSlot, ModelConfig

__all__ = ["BlockSlot", "ModelAPI", "ModelConfig", "encdec", "get_api"]
