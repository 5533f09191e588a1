"""Uniform model API (port of ``repro/models/api.py``) — the layer the
serving front and the trainer talk to.

``get_api(cfg)`` returns a ``ModelAPI`` whose members close over the
family dispatch: the encoder-decoder and audio families through
``models.encdec`` (a batch carries ``frames``), every other family
through ``models.lm`` (a VLM batch carries ``prefix_embeds``).
``param_specs`` and ``make_input_specs`` give the dry run's stand-ins:
tensors on the meta device with the reference's shapes and dtypes,
nothing allocated and nothing drawn.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import encdec, lm
from repro_torch.models.config import ModelConfig

__all__ = ["ModelAPI", "get_api", "make_input_specs"]


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init_params: Callable           # init_params(cpu_gen, device) -> params
    param_specs: Callable           # param_specs() -> params on meta
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

        return ModelAPI(cfg, init_params, lambda: encdec.param_specs(cfg),
                        loss, prefill, decode_step, init_cache, sample_logp)

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

    return ModelAPI(cfg, init_params, lambda: lm.param_specs(cfg), loss,
                    prefill, decode_step, init_cache, sample_logp)


# ---------------------------------------------------------------------------
# input specs (dry-run stand-ins)
# ---------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=lm.META)


def make_input_specs(cfg: ModelConfig, *, kind: str, seq: int, batch: int):
    """Meta tensors for one workload cell.

    kind: "train" → loss batch; "prefill" → prompt batch;
    "decode" → one-token step with a seq-length KV cache.

    Whisper's decoder is architecturally capped at
    ``cfg.max_target_positions`` learned positions — its cells run at that
    cap (batch retained), as the reference's do.
    """
    i32, dt = torch.int32, cfg.param_dtype
    if _is_encdec(cfg):
        T = min(seq, cfg.max_target_positions)
        if kind == "train":
            return {"frames": _spec((batch, cfg.enc_seq, cfg.enc_d_model), dt),
                    "inputs": _spec((batch, T - 1), i32),
                    "labels": _spec((batch, T - 1), i32)}
        if kind == "prefill":
            return {"frames": _spec((batch, cfg.enc_seq, cfg.enc_d_model), dt),
                    "tokens": _spec((batch, T - 1), i32)}
        return {"tokens": _spec((batch, 1), i32),
                "cache": lm.cache_specs(cfg, batch, T, enc_len=cfg.enc_seq),
                "cache_index": _spec((), i32)}

    extra = {}
    if cfg.family == "vlm":
        extra["prefix_embeds"] = _spec((batch, cfg.n_patches, cfg.d_model), dt)

    if kind == "train":
        return {**extra,
                "inputs": _spec((batch, seq), i32),
                "labels": _spec((batch, seq), i32)}
    if kind == "prefill":
        return {**extra, "tokens": _spec((batch, seq), i32)}
    return {"tokens": _spec((batch, 1), i32),
            "cache": lm.cache_specs(cfg, batch, seq),
            "cache_index": _spec((), i32)}
