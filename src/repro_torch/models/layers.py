"""Layers of the dense-attention architectures (port of
``repro/models/layers.py``).

Plain functions over tensors and explicit parameter dicts, written
without in-place operations so that ``torch.func.vmap(torch.func.grad(...))``
goes through them (the per-sample score pass). Contents:

* RMSNorm / LayerNorm
* RoPE
* blockwise attention: online softmax over KV blocks, GQA, sliding
  window, logit softcap, causal/bidirectional, the decode path's
  ``q_offset``/``kv_len``/``k_positions`` (a Python loop over KV blocks
  takes the place of ``lax.scan``)
* attention projections, SwiGLU MLP

The MoE and Mamba2 blocks come with later slices of the model zoo.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["NEG_INF", "attn_qkv", "flash_attention", "layer_norm",
           "rms_norm", "rope", "swiglu_mlp"]

F32 = torch.float32
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x, gamma, *, eps=1e-6):
    x32 = x.to(F32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + gamma.to(F32))
    return out.to(x.dtype)


def layer_norm(x, gamma, beta, *, eps=1e-5):
    x32 = x.to(F32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps) * gamma.to(F32) + beta.to(F32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x, positions, *, theta: float):
    """x: (..., T, H, hd); positions: (..., T)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                      / half)
    ang = positions[..., None].to(F32) * freqs            # (..., T, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _softcap(scores, cap: Optional[float]):
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    q_offset=0,
                    kv_len=None,
                    k_positions: Optional[torch.Tensor] = None,
                    kv_block: int = 512,
                    bf16_operands: bool = False):
    """Blockwise attention with online softmax (memory O(Tq·bk), not O(Tq·Tk)).

    q: (B, Tq, H, hd);  k, v: (B, Tk, KH, hd) with H % KH == 0 (GQA).
    ``q_offset``: absolute position of q[0] (decode: cache length).
    ``kv_len``: number of valid cache positions (decode); None = all valid.
    ``k_positions``: explicit absolute positions of each cache slot (ring
    buffers); entries < 0 are invalid. Overrides the default arange.
    ``bf16_operands``: QK and PV take bf16-rounded operands (fp32 sums and
    statistics). Returns (B, Tq, H, hd) in q.dtype.
    """
    B, Tq, H, hd = q.shape
    _, Tk, KH, _ = k.shape
    g = H // KH
    scale = scale if scale is not None else hd ** -0.5
    dev = q.device

    nblk = -(-Tk // kv_block)
    pad = nblk * kv_block - Tk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        if k_positions is not None:
            k_positions = F.pad(k_positions, (0, pad), value=-1)
    q_pos = q_offset + torch.arange(Tq, device=dev)

    # operands rounded to the compute dtype, products and sums in fp32
    # (the reference's preferred_element_type=F32)
    cdt = torch.bfloat16 if bf16_operands else F32
    qg = (q.reshape(B, Tq, KH, g, hd).to(F32) * scale).to(cdt).to(F32)

    m = torch.full((B, Tq, KH, g), NEG_INF, dtype=F32, device=dev)
    l = torch.zeros((B, Tq, KH, g), dtype=F32, device=dev)
    acc = torch.zeros((B, Tq, KH, g, hd), dtype=F32, device=dev)
    for j in range(nblk):
        k_j = k[:, j * kv_block:(j + 1) * kv_block].to(cdt).to(F32)
        v_j = v[:, j * kv_block:(j + 1) * kv_block].to(cdt).to(F32)
        if k_positions is None:
            k_pos = j * kv_block + torch.arange(kv_block, device=dev)
        else:
            k_pos = k_positions[j * kv_block:(j + 1) * kv_block]
        s = torch.einsum("btkgd,bskd->btkgs", qg, k_j)     # (B,Tq,KH,g,bk)
        s = _softcap(s, softcap)
        mask = torch.ones((Tq, kv_block), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        if kv_len is not None:
            mask = mask & (k_pos < kv_len)[None, :]
        if k_positions is None:
            mask = mask & (k_pos < Tk)[None, :]            # padding blocks
        else:
            mask = mask & (k_pos >= 0)[None, :]            # ring validity
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)

        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = corr * l + torch.sum(p, dim=-1)
        pv = torch.einsum("btkgs,bskd->btkgd", p.to(cdt).to(F32), v_j)
        acc = corr[..., None] * acc + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, Tq, H, hd).to(q.dtype)


def attn_qkv(x, p, cfg, *, positions, rope_on=True):
    """Project to q, k, v. x: (B, T, D). Returns (q, k, v)."""
    B, T, _ = x.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, T, H, hd)
    k = (x @ p["wk"]).reshape(B, T, KH, hd)
    v = (x @ p["wv"]).reshape(B, T, KH, hd)
    if rope_on:
        q = rope(q, positions, theta=cfg.rope_theta)
        k = rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def swiglu_mlp(x, p):
    gate = F.silu(x @ p["w_gate"])
    up = x @ p["w_up"]
    return (gate * up) @ p["w_down"]
