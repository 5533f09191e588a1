"""Uniform model API (port of ``repro/models/api.py``) — the layer the
serving front and the trainer talk to.

``get_api(cfg)`` returns a ``ModelAPI`` whose members close over the
config. The decoder-only families are ported: dense, MoE, SSM (Mamba2)
and hybrid (jamba). The encoder-decoder and audio families, and configs
with cross-attention slots, raise ``NotImplementedError`` until their
slice. ``param_specs`` and ``make_input_specs`` (the reference's dry-run
stand-ins) wait with the launch tooling.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.roadmap import queue

__all__ = ["ModelAPI", "get_api"]


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init_params: Callable           # init_params(cpu_gen, device) -> params
    loss: Callable                  # loss(params, batch) -> (scalar, metrics)
    prefill: Callable               # prefill(params, batch) -> (logits, cache, idx)
    decode_step: Callable           # decode(params, cache, idx, tokens) -> (logits, cache)
    init_cache: Callable            # init_cache(batch, max_len) -> cache
    sample_logp: Callable           # logp(params, ex) -> scalar (score-matrix rows)


def get_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.family in ("encdec", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder trunk (models/encdec.py) comes "
            f"with a later slice of the model zoo ({queue('models')})")
    later = [s for s in cfg.slots if s.cross_attn]
    if later:
        raise NotImplementedError(
            f"{cfg.name}: {later[0]} needs a block a later slice of the "
            f"model zoo ports ({queue('models')})")

    def init_params(gen: torch.Generator, device=None):
        return lm.init_params(gen, cfg, device)

    def loss(params, batch):
        return lm.lm_loss(params, cfg, batch)

    def prefill(params, batch):
        return lm.prefill(params, cfg, batch["tokens"],
                          max_len=batch.get("max_len",
                                            batch["tokens"].shape[1] + 1),
                          prefix_embeds=batch.get("prefix_embeds"))

    def decode_step(params, cache, idx, tokens):
        return lm.decode_step(params, cfg, cache, idx, tokens)

    def init_cache(batch, max_len, device=None):
        return lm.init_cache(cfg, batch, max_len, device=device)

    def sample_logp(params, ex):
        return lm.sample_logp(params, cfg, ex)

    return ModelAPI(cfg, init_params, loss, prefill, decode_step, init_cache,
                    sample_logp)
