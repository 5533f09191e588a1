"""Uniform model API (port of ``repro/models/api.py``) — the layer the
serving front and the trainer talk to.

``get_api(cfg)`` returns a ``ModelAPI`` whose members close over the
family dispatch: the encoder-decoder and audio families through
``models.encdec`` (a batch carries ``frames``), every other family
through ``models.lm`` (a VLM batch carries ``prefix_embeds``).
``param_specs`` and ``make_input_specs`` (the reference's dry-run
stand-ins) wait with the launch tooling.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import encdec, lm
from repro_torch.models.config import ModelConfig

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


def _is_encdec(cfg):
    return cfg.family in ("encdec", "audio")


def get_api(cfg: ModelConfig) -> ModelAPI:
    if _is_encdec(cfg):
        def init_params(gen: torch.Generator, device=None):
            return encdec.init_params(gen, cfg, device)

        def loss(params, batch):
            return encdec.loss(params, cfg, batch)

        def prefill(params, batch):
            logits, cache, idx, _ = encdec.prefill(
                params, cfg, batch["frames"], batch["tokens"],
                max_len=batch.get("max_len", cfg.max_target_positions))
            return logits, cache, idx

        def decode_step(params, cache, idx, tokens):
            return encdec.decode_step(params, cfg, cache, idx, tokens)

        def init_cache(batch, max_len, device=None):
            return lm.init_cache(cfg, batch, max_len, enc_len=cfg.enc_seq,
                                 device=device)

        def sample_logp(params, ex):
            enc_out = encdec.encode(params, cfg, ex["frames"][None])
            ex2 = {k: v for k, v in ex.items() if k != "frames"}
            return lm.sample_logp(params["dec"], cfg,
                                  {**ex2, "enc_out": enc_out[0]})

        return ModelAPI(cfg, init_params, loss, prefill, decode_step,
                        init_cache, sample_logp)

    def init_params(gen: torch.Generator, device=None):
        return lm.init_params(gen, cfg, device)

    def loss(params, batch):
        return lm.lm_loss(params, cfg, batch)

    def prefill(params, batch):
        # max_len defaults to the tokens + 1, as the reference's: a prefix
        # then does not fit, and lm.prefill raises (the reference decodes
        # from a cache too short for it)
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
