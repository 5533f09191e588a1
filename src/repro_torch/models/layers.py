"""Layers of the decoder-only architectures (port of
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
* sort-based capacity MoE: fp32 router, top-k, the Switch aux loss,
  slots placed by rank within their expert and dropped past capacity,
  the experts' SwiGLU batched over E (``scatter_add`` onto fresh zeros
  and a one-hot count in place of ``.at[].add`` and ``bincount``, so
  ``vmap`` batches it)
* the Mamba2 SSD block: the chunked state-space-duality form for train
  and prefill (a Python loop over chunks in place of ``lax.scan``), the
  O(1) recurrent form for decode, and the depthwise causal conv
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["NEG_INF", "attn_qkv", "flash_attention", "layer_norm",
           "mamba_block", "moe_block", "rms_norm", "rope", "swiglu_mlp"]

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


# ---------------------------------------------------------------------------
# MoE — sort-based capacity dispatch
# ---------------------------------------------------------------------------

def moe_block(x, p, cfg):
    """x: (B, T, D) → (B, T, D), plus the router's aux loss.

    Dispatch: flatten tokens, route top-k, sort slots by expert (stably,
    as ``jnp.argsort``), place each slot at its rank within its expert's
    capacity buffer (slots past ``cap`` are dropped: they add zeros at
    position 0, as the reference's ``.at[].add``), run the experts'
    SwiGLU as one batched product over E, combine with the gates. The
    combine sums each token's K slots in slot order (the reference
    scatter-adds them), so it is deterministic on the card.
    """
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    dev = x.device
    xf = x.reshape(B * T, D)
    n_tok = B * T

    logits = (xf @ p["router"]).to(F32)
    probs = torch.softmax(logits, dim=-1)
    # top-k by a stable descending sort: among equal probabilities the
    # lower expert index comes first, as lax.top_k (bf16 router logits tie)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :K], idx[:, :K]                      # (T, K)
    gate = gate / torch.clamp_min(torch.sum(gate, -1, keepdim=True), 1e-9)

    # load-balance aux loss (Switch-style)
    experts = torch.arange(E, device=dev)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.sum((idx[..., None] == experts).to(F32), dim=1),
                    dim=0) / K
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)

    slots_e = idx.reshape(-1)                                # (n_tok*K,)
    slots_t = torch.arange(n_tok, device=dev).repeat_interleave(K)
    slots_g = gate.reshape(-1)
    order = torch.argsort(slots_e, stable=True)
    se, st, sg = slots_e[order], slots_t[order], slots_g[order]

    counts = torch.sum((se[:, None] == experts).to(torch.int64), dim=0)
    starts = torch.cumsum(counts, 0) - counts                # exclusive
    pos = torch.arange(n_tok * K, device=dev) - starts[se]
    cap = int(cfg.capacity_factor * n_tok * K / E) or 1
    keep = pos < cap
    pos_c = torch.where(keep, pos, 0)
    where = (se * cap + pos_c)[:, None].expand(-1, D)        # buffer row

    src = torch.where(keep[:, None], xf[st], 0)
    buf = torch.zeros((E * cap, D), dtype=x.dtype, device=dev) \
        .scatter_add(0, where, src).reshape(E, cap, D)

    # expert FFN (SwiGLU), batched over E
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["w_gate"])) \
        * torch.einsum("ecd,edf->ecf", buf, p["w_up"])
    out_buf = torch.einsum("ecf,efd->ecd", h, p["w_down"]).reshape(E * cap, D)

    gathered = torch.gather(out_buf, 0, where) * sg[:, None].to(x.dtype)
    gathered = torch.where(keep[:, None], gathered, 0)
    # back to slot order (token-major, k minor), then each token's K sum
    slot_rows = order[:, None].expand(-1, D)
    by_slot = torch.zeros_like(gathered).scatter(0, slot_rows, gathered)
    y = torch.sum(by_slot.reshape(n_tok, K, D), dim=1)
    return y.reshape(B, T, D), aux


# ---------------------------------------------------------------------------
# Mamba2 — SSD (state-space duality), chunked scan
# ---------------------------------------------------------------------------

def _ssd_inner(xh, dt, A, Bm, Cm, cfg, *, h0=None):
    """Chunked SSD core.

    xh: (B, T, nh, hp); dt: (B, T, nh) (post-softplus);
    A: (nh,) negative reals; Bm/Cm: (B, T, g, ds).
    Returns y (B, T, nh, hp) and the final state (B, nh, ds, hp) fp32.

    ``cfg.ssd_factored`` factors exp(cum_i − cum_j) into the (Q, ds)
    operands (cum clamped at −20 a chunk) instead of masking a Q×Q decay
    before ``exp``; ``cfg.ssd_bf16`` rounds the contractions' operands to
    bf16 and sums in fp32 (the reference's ``preferred_element_type``).
    """
    Bsz, T, nh, hp = xh.shape
    g, ds = Bm.shape[2], Bm.shape[3]
    Q = min(cfg.ssd_chunk, T)
    Tp = -(-T // Q) * Q
    if Tp != T:
        # zero-pad the tail: dt = 0 ⇒ identity decay and zero state update,
        # so both y[:T] and the final state are exact.
        xh = F.pad(xh, (0, 0, 0, 0, 0, Tp - T))
        dt = F.pad(dt, (0, 0, 0, Tp - T))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, Tp - T))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, Tp - T))
    T_out, T = T, Tp
    nc = T // Q
    rep = nh // g

    xc = xh.reshape(Bsz, nc, Q, nh, hp).to(F32)
    dtc = dt.reshape(Bsz, nc, Q, nh).to(F32)
    Bc = Bm.reshape(Bsz, nc, Q, g, ds).repeat_interleave(rep, dim=3).to(F32)
    Cc = Cm.reshape(Bsz, nc, Q, g, ds).repeat_interleave(rep, dim=3).to(F32)

    def rnd(t):
        """An operand as the contraction takes it: bf16-rounded with
        ``ssd_bf16``, the products and sums fp32 either way."""
        return t.to(torch.bfloat16).to(F32) if cfg.ssd_bf16 else t

    dA = dtc * A.to(F32)                                      # (B,nc,Q,nh)
    cum = torch.cumsum(dA, dim=2)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xh.device))[None, None, :, :, None]

    # --- intra-chunk (attention-like, masked by causal decay) -------------
    if cfg.ssd_factored:
        cum_cl = torch.clamp_min(cum, -20.0)
        Ce = rnd(Cc * torch.exp(cum_cl)[..., None])           # (B,nc,Q,nh,ds)
        Bw = rnd(Bc * (dtc * torch.exp(-cum_cl))[..., None])
        cb = torch.einsum("bcqhd,bckhd->bcqkh", Ce, Bw)       # (B,nc,Q,Q,nh)
        M = rnd(torch.where(causal, cb, 0.0))
    else:
        seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,Q,nh)
        # mask BEFORE exp: the upper triangle's seg is positive and can
        # overflow, and an inf poisons the where()'s gradient with inf·0
        decay = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)),
                            0.0)
        cb = torch.einsum("bcqhd,bckhd->bcqkh", rnd(Cc), rnd(Bc))
        M = rnd(cb * decay * dtc[:, :, None, :, :])
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", M, rnd(xc))

    # --- chunk summary states ---------------------------------------------
    w = torch.exp(cum[:, :, -1:, :] - cum) * dtc              # (B,nc,Q,nh)
    S = torch.einsum("bcqh,bcqhd,bcqhp->bchdp", rnd(w), rnd(Bc), rnd(xc))

    # --- inter-chunk recurrence (a loop over the nc chunks) ----------------
    a_chunk = torch.exp(cum[:, :, -1, :])                     # (B,nc,nh)
    h = torch.zeros((Bsz, nh, ds, hp), dtype=F32, device=xh.device) \
        if h0 is None else h0.to(F32)
    h_starts = []
    for c in range(nc):
        h_starts.append(h)                                    # state at chunk START
        h = a_chunk[:, c, :, None, None] * h + S[:, c]
    h_starts = torch.stack(h_starts, dim=1)                   # (B,nc,nh,ds,hp)

    y_inter = torch.einsum("bcqhd,bchdp->bcqhp",
                           rnd(Cc * torch.exp(cum)[..., None]), rnd(h_starts))
    y = (y_intra + y_inter).reshape(Bsz, T, nh, hp)[:, :T_out]
    return y.to(xh.dtype), h


def _causal_conv(x, w, *, state=None):
    """Depthwise causal conv1d. x: (B, T, C); w: (K, C).

    Train: left-pad K-1 zeros. Decode: ``state`` is (B, K-1, C) of the
    last K-1 inputs; returns (y, new_state) (new_state None in train).
    """
    K = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    T = x.shape[1]
    y = sum(xp[:, i:i + T, :] * w[i][None, None, :] for i in range(K))
    if state is None:
        return y, None
    return y, xp[:, -(K - 1):, :]


def _split_in_proj(zxbcdt, cfg):
    """(z, xBC, dt) of the input projection."""
    di, nh = cfg.d_inner, cfg.ssm_heads
    conv_ch = di + 2 * cfg.ssm_groups * cfg.ssm_state
    return torch.split(zxbcdt, [di, conv_ch, nh], dim=-1)


def _ssm_inputs(xBC, dt, p, cfg):
    """(xh, Bm, Cm, dt, A) from the conv's output and the raw dt."""
    B, T, _ = xBC.shape
    di, nh, hp = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    g, ds = cfg.ssm_groups, cfg.ssm_state
    xh, Bm, Cm = torch.split(F.silu(xBC), [di, g * ds, g * ds], dim=-1)
    dt = F.softplus(dt.to(F32) + p["dt_bias"].to(F32))
    A = -torch.exp(p["A_log"].to(F32))                        # (nh,)
    return (xh.reshape(B, T, nh, hp), Bm.reshape(B, T, g, ds),
            Cm.reshape(B, T, g, ds), dt, A)


def mamba_block(x, p, cfg, *, cache=None):
    """Mamba2 block. x: (B, T, D).

    cache (decode): {"conv": (B, K-1, conv_ch), "ssm": (B, nh, ds, hp)}.
    Returns (y, new_cache) — new_cache is None in train mode; in decode
    its "ssm" is rounded to the cache's dtype, as the reference's.
    """
    B, T, D = x.shape
    di, nh = cfg.d_inner, cfg.ssm_heads
    g = cfg.ssm_groups

    z, xBC, dt = _split_in_proj(x @ p["in_proj"], cfg)
    conv_state = None if cache is None else cache["conv"]
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], state=conv_state)
    xh, Bm, Cm, dt, A = _ssm_inputs(xBC, dt, p, cfg)

    if cache is None:
        y, _ = _ssd_inner(xh, dt, A, Bm, Cm, cfg)
        new_cache = None
    else:
        # O(1) recurrent decode: h ← exp(A·dt)·h + dt·B⊗x ;  y = C·h + D·x
        h = cache["ssm"].to(F32)                              # (B,nh,ds,hp)
        rep = nh // g
        B1 = Bm[:, 0].repeat_interleave(rep, dim=1).to(F32)   # (B,nh,ds)
        C1 = Cm[:, 0].repeat_interleave(rep, dim=1).to(F32)
        dt1 = dt[:, 0]                                        # (B,nh)
        x1 = xh[:, 0].to(F32)                                 # (B,nh,hp)
        decay = torch.exp(dt1 * A[None, :])                   # (B,nh)
        h = decay[:, :, None, None] * h \
            + torch.einsum("bh,bhd,bhp->bhdp", dt1, B1, x1)
        y = torch.einsum("bhd,bhdp->bhp", C1, h)[:, None]     # (B,1,nh,hp)
        new_cache = {"conv": new_conv, "ssm": h.to(cache["ssm"].dtype)}

    y = y + p["D"].to(F32)[None, None, :, None] * xh.to(F32)
    y = y.reshape(B, T, di)
    # gated RMSNorm (mamba2)
    y = rms_norm(y.to(x.dtype) * F.silu(z), p["norm_g"], eps=cfg.norm_eps)
    return y @ p["out_proj"], new_cache
