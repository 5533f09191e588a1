"""Model configuration (port of ``repro/models/config.py``).

One ``ModelConfig`` covers every architecture family of the reference.
The layer stack is a repeated **super-block** of ``BlockSlot``s: the
parameters of each slot are stacked over ``repeats``, and the stack
drivers of ``models.lm`` loop over the repeats in Python (the reference
scans them with ``lax.scan``).

Every field of the reference is kept, so a configuration reads the same
in both packages. The numeric levers are acted on as the reference acts
on them: ``attn_bf16`` (bf16 QK/PV operands), ``ssd_factored`` (the
factored intra-chunk decay) and ``ssd_bf16`` (bf16 SSD operands, fp32
sums). The sharding and compilation levers (``attn_seq_shard``,
``fsdp_gather_weights``, ``moe_*``, ``gather_unembed``, ``ssd_shard``,
``remat``) do not change values on one device and the port does not
act on them; ``param_dtype`` is a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

__all__ = ["BlockSlot", "ModelConfig"]


@dataclasses.dataclass(frozen=True)
class BlockSlot:
    """One layer *position* inside the repeated super-block."""
    kind: str = "attn"                  # "attn" | "mamba"
    window: Optional[int] = None        # sliding-window size (attn only)
    moe: bool = False                   # MoE FFN instead of dense MLP
    cross_attn: bool = False            # enc-dec decoder blocks
    bidirectional: bool = False         # encoder blocks


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"               # dense|moe|ssm|hybrid|encdec|vlm|audio

    # trunk dims
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None      # default d_model // n_heads
    d_ff: int = 1024
    vocab: int = 32000

    # layer pattern: slots repeated n_layers/len(slots) times
    slots: Sequence[BlockSlot] = (BlockSlot(),)

    # attention details
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None       # gemma2: 50.0
    logit_softcap: Optional[float] = None      # gemma2: 30.0
    query_scale: Optional[float] = None        # default 1/sqrt(head_dim)
    use_post_norm: bool = False                # gemma2 sandwich norms
    scale_embed: bool = False                  # gemma2 sqrt(d) embed scale
    tie_embeddings: bool = True

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # Mamba2 / SSD
    ssm_state: int = 128
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssd_chunk: int = 256

    # encoder (enc-dec archs); frontend stubs provide encoder inputs directly
    enc_layers: int = 0
    enc_d_model: int = 0
    enc_n_heads: int = 0
    enc_d_ff: int = 0
    enc_seq: int = 0                    # e.g. whisper 1500 mel frames
    max_target_positions: int = 0       # whisper: 448 learned positions

    # VLM stub frontend
    n_patches: int = 0                  # patch-embedding prefix length

    # numerics / layer flavors
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    norm_type: str = "rms"              # "rms" | "layer"
    mlp_type: str = "swiglu"            # "swiglu" | "gelu"
    pos_embed: str = "rope"             # "rope" | "learned" | "sinusoidal"

    # training (kept for parity; the port does not rematerialize)
    remat: str = "dots"                 # "none" | "dots" | "full"

    # the reference's perf levers: the numeric ones acted on (ssd_bf16,
    # ssd_factored, attn_bf16), the sharding ones kept and inert
    ssd_bf16: bool = False          # SSD contraction operands in bf16
    ssd_factored: bool = False      # factor exp(cum_i−cum_j): no Q×Q decay
    moe_shard_constraints: bool = False
    moe_ep_over_data: bool = False
    gather_unembed: bool = False
    attn_seq_shard: bool = False
    attn_bf16: bool = False         # bf16 QK/PV operands (f32 softmax stats)
    fsdp_gather_weights: bool = False
    ssd_shard: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_layers % len(self.slots):
            raise ValueError(f"{self.name}: {self.n_layers} layers do not "
                             f"repeat a super-block of {len(self.slots)}")

    @property
    def repeats(self) -> int:
        return self.n_layers // len(self.slots)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (the reference's layout;
        padded logits are masked in ``unembed``)."""
        return -(-self.vocab // 256) * 256

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def d_inner(self) -> int:           # mamba
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def scaled(self, **overrides) -> "ModelConfig":
        """Return a reduced copy (smoke configs, depth cuts)."""
        return dataclasses.replace(self, **overrides)
