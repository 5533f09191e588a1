"""Encoder-decoder trunk, the whisper family (port of
``repro/models/encdec.py``).

The modality frontend is a stub, as in the reference: a batch carries
precomputed mel-frame embeddings ``frames`` (B, enc_seq, d_model); the
conv frontend that would produce them is out of scope. Encoder: a
bidirectional attention stack with sinusoidal positions. Decoder: the LM
trunk of ``models.lm`` with learned positions, causal self-attention and
cross-attention into the encoder's output.

Where the attention runs: ``encode`` under ``prefill`` takes no gradient,
so its bidirectional layers take the flash kernel wherever
``lm._kernel_route`` admits them, as the decoder's self- and
cross-attention do there. Under ``loss`` and the score pass the encoder
keeps the blockwise attention (the kernel has no backward), as the
reference's ``run_stack(mode="train")`` does everywhere.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import lm
from repro_torch.models.config import BlockSlot, ModelConfig

__all__ = ["decode_step", "encode", "encoder_cfg", "init_params", "loss",
           "param_specs", "prefill", "sinusoidal_pos"]

F32 = torch.float32


def encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-enc",
        n_layers=cfg.enc_layers,
        d_model=cfg.enc_d_model or cfg.d_model,
        n_heads=cfg.enc_n_heads or cfg.n_heads,
        n_kv_heads=cfg.enc_n_heads or cfg.n_kv_heads,
        head_dim=None,
        d_ff=cfg.enc_d_ff or cfg.d_ff,
        slots=(BlockSlot(bidirectional=True),),
        pos_embed="sinusoidal",
    )


def sinusoidal_pos(T: int, d: int, dtype=F32, device=None) -> torch.Tensor:
    """(T, d): sines then cosines of pos / 10000^(i / (d/2 − 1 + 1e-9)),
    computed in fp32 and cast to ``dtype``, as the reference does."""
    pos = torch.arange(T, dtype=F32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=F32, device=device)[None, :]
    ang = pos / (10000.0 ** (dim / (d // 2 - 1 + 1e-9)))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None):
    """{"enc_blocks", "enc_final_norm", "dec"}, drawn from the CPU
    generator ``gen`` and placed on ``device`` (the CPU by default)."""
    device = torch.device("cpu" if device is None else device)
    ecfg = encoder_cfg(cfg)
    return {
        "enc_blocks": lm.init_blocks(gen, ecfg, device=device),
        "enc_final_norm": lm._norm_p(ecfg, ecfg.d_model, device),
        "dec": lm.init_params(gen, cfg, device),
    }


def param_specs(cfg: ModelConfig):
    """The parameter tree on the meta device: the reference's leaf paths,
    shapes and dtypes, with nothing allocated and nothing drawn."""
    return init_params(None, cfg, lm.META)


def encode(params, cfg: ModelConfig, frames, *, mode: str = "train"):
    """frames: (B, Te, D) precomputed frame embeddings (stub frontend).
    ``mode="prefill"``: the layers as a prefill runs them (the flash
    kernel where the route admits it; no gradient)."""
    ecfg = encoder_cfg(cfg)
    x = frames.to(ecfg.param_dtype)
    x = x + sinusoidal_pos(x.shape[1], x.shape[2], x.dtype, x.device)[None]
    positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    x, _ = lm.run_stack(params["enc_blocks"], x, ecfg, positions=positions,
                        mode=mode)
    return lm._apply_norm(x, params["enc_final_norm"], ecfg)


def loss(params, cfg: ModelConfig, batch):
    """batch: {"frames": (B, Te, D), "inputs": (B, T), "labels": (B, T)}."""
    enc_out = encode(params, cfg, batch["frames"])
    return lm.lm_loss(params["dec"], cfg, {**batch, "enc_out": enc_out})


def prefill(params, cfg: ModelConfig, frames, tokens, *, max_len: int):
    """Returns (logits, cache, next_index, enc_out)."""
    enc_out = encode(params, cfg, frames, mode="prefill")
    logits, cache, idx = lm.prefill(params["dec"], cfg, tokens,
                                    max_len=max_len, enc_out=enc_out)
    return logits, cache, idx, enc_out


def decode_step(params, cfg: ModelConfig, cache, cache_index, tokens,
                *, enc_out=None):
    """The cross-attention keys and values were cached at prefill;
    ``enc_out`` is unused here, kept in the signature as the reference
    keeps it."""
    return lm.decode_step(params["dec"], cfg, cache, cache_index, tokens,
                          enc_out=enc_out)
