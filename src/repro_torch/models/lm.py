"""The LM trunk (port of ``repro/models/lm.py``): attention, Mamba2, MoE
and cross-attention slots, so the dense, MoE, SSM and hybrid families,
the VLM (a patch prefix before the tokens) and the decoder of the
encoder-decoder trunk (``models/encdec.py``).

Parameters are explicit trees: ``{"embed", "final_norm", "blocks"[,
"head"]}`` where ``blocks`` is a list with one dict per slot of the
super-block, each leaf stacked over ``cfg.repeats``. The three stack
drivers loop over the repeats in Python and index the stacked leaves
(the reference scans them):

* ``run_stack``         — train / eval (the score pass runs it under
  ``torch.func.vmap(grad)``);
* ``run_stack_prefill`` — also emits the per-layer KV rows (a Mamba2
  slot: its conv and SSM states; a cross-attention slot: also the
  encoder's projected keys and values ``ck``/``cv``);
* ``run_stack_decode``  — one token in, the cache written in place.

Prefill routes a layer's self-attention through the flash-attention
kernel (``kernels.ops.flash_attention``) exactly when the call is one the
TPU kernel computes and the CUDA kernels take (``_kernel_route``): no
softcap; no ``attn_bf16`` rounding of fp32 operands (a bf16 model's
operands already are bf16); no ``q_offset``/``kv_len``/``k_positions``
(prefill never has those three); shapes ``flash_attention.supported``
accepts. Every other call — the train and score passes (no backward
kernel), decode (``kv_len``, ring positions), a softcapped model, an fp32
model with ``attn_bf16``, a head_dim the kernels lack — runs the
blockwise attention of ``models.layers``, as the reference does
everywhere. The rule reads shapes, dtypes and the config only, so it
routes a CPU run as it routes the card's. A cross-attention layer at
prefill (the decoder's queries against the encoder's frames) takes the
kernel wherever the shapes are supported: the reference's cross-attention
has no softcap and no ``attn_bf16`` rounding.

Initialization draws from an explicit CPU ``torch.Generator`` and moves
each draw to the device asked for, so one seed gives the same weights on
every device. The same code gives the shapes alone: on the meta device
it draws nothing (``param_specs``, ``cache_specs``: the dry run's
stand-ins, with the reference's leaf paths, shapes and dtypes). Shapes, scales and dtypes are the reference's, not its
bits (``jax.random`` and torch draw different numbers). The reference
draws a cross-attention slot's ``xq`` and ``xo`` from one key, so at
d = H·hd they are one matrix; the port draws them apart.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.pytree import tree_map
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import supported as flash_supported
from repro_torch.models import layers as L
from repro_torch.models.config import BlockSlot, ModelConfig

__all__ = ["block_apply", "cache_specs", "chunked_ce", "decode_step",
           "embed_tokens", "forward", "init_blocks", "init_cache",
           "init_params", "init_slot", "lm_loss", "mamba_prefill_cache",
           "param_specs", "prefill", "run_stack", "run_stack_decode",
           "run_stack_prefill", "sample_logp", "unembed"]

F32 = torch.float32


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _randn(gen: torch.Generator, shape, device) -> torch.Tensor:
    """F32 normal draws from the CPU generator ``gen``, moved to
    ``device``: one seed gives the same weights on every device. On the
    meta device nothing is drawn: the leaf's shape alone (``param_specs``;
    ``gen`` is not read)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=F32, device=device)
    return torch.randn(shape, generator=gen, dtype=F32).to(device)


def _norm_p(cfg, d, device):
    if cfg.norm_type == "layer":
        return {"g": torch.ones((d,), dtype=cfg.param_dtype, device=device),
                "b": torch.zeros((d,), dtype=cfg.param_dtype, device=device)}
    return {"g": torch.zeros((d,), dtype=cfg.param_dtype, device=device)}


def _apply_norm(x, p, cfg):
    if cfg.norm_type == "layer":
        return L.layer_norm(x, p["g"], p["b"], eps=cfg.norm_eps)
    return L.rms_norm(x, p["g"], eps=cfg.norm_eps)


def _dense(gen, shape, dtype, device, scale=None):
    scale = scale if scale is not None else shape[0] ** -0.5
    return (_randn(gen, shape, device) * scale).to(dtype)


def _init_attn(gen, cfg, d, device, *, cross=False):
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pd = cfg.param_dtype
    p = {
        "norm": _norm_p(cfg, d, device),
        "wq": _dense(gen, (d, H * hd), pd, device),
        "wk": _dense(gen, (d, KH * hd), pd, device),
        "wv": _dense(gen, (d, KH * hd), pd, device),
        "wo": _dense(gen, (H * hd, d), pd, device),
    }
    if cross:
        p.update({
            "xnorm": _norm_p(cfg, d, device),
            "xq": _dense(gen, (d, H * hd), pd, device),
            "xk": _dense(gen, (d, KH * hd), pd, device),
            "xv": _dense(gen, (d, KH * hd), pd, device),
            "xo": _dense(gen, (H * hd, d), pd, device),
        })
    if cfg.use_post_norm:
        p["post_norm"] = _norm_p(cfg, d, device)
    return p


def _init_ffn(gen, cfg, d, device, *, moe: bool):
    pd = cfg.param_dtype
    if moe:
        E, f = cfg.n_experts, cfg.d_ff
        p = {"router": _dense(gen, (d, E), pd, device),
             "w_gate": _dense(gen, (E, d, f), pd, device, scale=d ** -0.5),
             "w_up": _dense(gen, (E, d, f), pd, device, scale=d ** -0.5),
             "w_down": _dense(gen, (E, f, d), pd, device, scale=f ** -0.5)}
    elif cfg.mlp_type == "gelu":
        p = {"w_up": _dense(gen, (d, cfg.d_ff), pd, device),
             "w_down": _dense(gen, (cfg.d_ff, d), pd, device)}
    else:
        p = {"w_gate": _dense(gen, (d, cfg.d_ff), pd, device),
             "w_up": _dense(gen, (d, cfg.d_ff), pd, device),
             "w_down": _dense(gen, (cfg.d_ff, d), pd, device)}
    p["ffn_norm"] = _norm_p(cfg, d, device)
    if cfg.use_post_norm:
        p["ffn_post_norm"] = _norm_p(cfg, d, device)
    return p


def _init_mamba(gen, cfg, d, device):
    di, nh = cfg.d_inner, cfg.ssm_heads
    g, ds, K = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv
    conv_ch = di + 2 * g * ds
    proj_out = 2 * di + 2 * g * ds + nh
    pd = cfg.param_dtype
    return {
        "norm": _norm_p(cfg, d, device),
        "in_proj": _dense(gen, (d, proj_out), pd, device),
        "conv_w": _dense(gen, (K, conv_ch), pd, device, scale=0.1),
        "dt_bias": torch.zeros((nh,), dtype=F32, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=F32)
                           ).to(device),
        "D": torch.ones((nh,), dtype=F32, device=device),
        "norm_g": torch.zeros((di,), dtype=pd, device=device),
        "out_proj": _dense(gen, (di, d), pd, device),
    }


def init_slot(gen: torch.Generator, slot: BlockSlot, cfg: ModelConfig, d,
              device=None):
    """Params for one slot position (un-stacked).

    A pure-SSM slot (mamba2: ``d_ff == 0``, no MoE) has no FFN sublayer:
    the Mamba2 mixer is the whole block."""
    device = torch.device("cpu" if device is None else device)
    if slot.kind == "mamba":
        p = _init_mamba(gen, cfg, d, device)
        if cfg.d_ff == 0 and not slot.moe:
            return p
    else:
        p = _init_attn(gen, cfg, d, device, cross=slot.cross_attn)
    p.update(_init_ffn(gen, cfg, d, device, moe=slot.moe))
    return p


def init_blocks(gen: torch.Generator, cfg: ModelConfig, d=None, device=None):
    """List of per-slot trees, each leaf stacked over cfg.repeats."""
    d = d or cfg.d_model
    blocks = []
    for slot in cfg.slots:
        rows = [init_slot(gen, slot, cfg, d, device)
                for _ in range(cfg.repeats)]
        blocks.append(tree_map(lambda *xs: torch.stack(xs), *rows))
    return blocks


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None):
    """The parameter tree, drawn from the CPU generator ``gen`` and placed
    on ``device`` (the CPU by default); each draw is scaled, cast and
    stacked there."""
    device = torch.device("cpu" if device is None else device)
    params = {
        "embed": (_randn(gen, (cfg.padded_vocab, cfg.d_model), device)
                  * 0.02).to(cfg.param_dtype),
        "final_norm": _norm_p(cfg, cfg.d_model, device),
        "blocks": init_blocks(gen, cfg, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = _dense(gen, (cfg.d_model, cfg.padded_vocab),
                                cfg.param_dtype, device)
    if cfg.pos_embed == "learned":
        params["pos_embed"] = (_randn(gen, (cfg.max_target_positions or 2048,
                                            cfg.d_model), device) * 0.02
                               ).to(cfg.param_dtype)
    return params


META = torch.device("meta")


def param_specs(cfg: ModelConfig):
    """The parameter tree on the meta device: the reference's leaf paths,
    shapes and dtypes, with nothing allocated and nothing drawn."""
    return init_params(None, cfg, META)


# ---------------------------------------------------------------------------
# block body (shared by all three drivers)
# ---------------------------------------------------------------------------

def _kernel_route(q, k, cfg) -> bool:
    """Whether a prefill layer's attention takes ``ops.flash_attention``:
    no softcap (the TPU kernel has none), no ``attn_bf16`` rounding of
    fp32 operands (the blockwise attention rounds q·scale, k, v and p as
    the reference's ``bf16_operands`` does), and shapes the kernels take."""
    return (cfg.attn_softcap is None
            and not (cfg.attn_bf16 and q.dtype != torch.bfloat16)
            and flash_supported(q, k))


def _is_ring(slot, S: int) -> bool:
    """Whether a slot's decode cache of S positions is a ring buffer (a
    window the cache holds whole); otherwise it decodes by position."""
    return slot.window is not None and slot.window <= S + 1


def _self_attn(slot, p, x, cfg, *, positions, mode, cache=None,
               cache_index=None):
    """Returns (attn_out, cache_out).

    Decode-mode windowed slots use a **ring-buffer** cache of size
    S = window: slot j holds the most recent absolute position p ≡ j (mod S)
    with p ≤ cache_index; absolute positions are reconstructed for the mask
    and negative (not-yet-written) slots are invalid. The decode cache is
    written in place (the reference returns an updated copy).
    """
    h = _apply_norm(x, p["norm"], cfg)
    rope_on = cfg.pos_embed == "rope"
    q, k, v = L.attn_qkv(h, p, cfg, positions=positions, rope_on=rope_on)

    if mode == "decode":
        S = cache["k"].shape[1]
        is_ring = _is_ring(slot, S)
        write_at = cache_index % S if is_ring else cache_index
        if write_at >= S:
            raise ValueError(
                f"decode at position {cache_index} is past the cache's "
                f"max_len {S} (a prefill's max_len counts the prefix)")
        cache["k"][:, write_at] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, write_at] = v[:, 0].to(cache["v"].dtype)
        if is_ring:
            j = torch.arange(S, device=x.device)
            k_positions = cache_index - torch.remainder(cache_index - j, S)
            out = L.flash_attention(
                q, cache["k"], cache["v"], causal=True, window=slot.window,
                softcap=cfg.attn_softcap, scale=cfg.query_scale,
                q_offset=cache_index, k_positions=k_positions,
                kv_block=min(512, S))
        else:
            out = L.flash_attention(
                q, cache["k"], cache["v"], causal=True, window=slot.window,
                softcap=cfg.attn_softcap, scale=cfg.query_scale,
                q_offset=cache_index, kv_len=cache_index + 1,
                kv_block=min(512, S))
        cache_out = cache
    elif mode == "prefill" and _kernel_route(q, k, cfg):
        out = ops.flash_attention(q, k, v, causal=not slot.bidirectional,
                                  window=slot.window, scale=cfg.query_scale)
        cache_out = {"k": k, "v": v}
    else:
        out = L.flash_attention(
            q, k, v, causal=not slot.bidirectional,
            window=slot.window, softcap=cfg.attn_softcap,
            scale=cfg.query_scale, kv_block=min(512, k.shape[1]),
            bf16_operands=cfg.attn_bf16)
        cache_out = {"k": k, "v": v} if mode == "prefill" else None

    out = out.reshape(*out.shape[:2], -1) @ p["wo"]
    if cfg.use_post_norm:
        out = _apply_norm(out, p["post_norm"], cfg)
    return out, cache_out


def _cross_attn(p, x, enc_out, cfg, *, mode, cached_kv=None):
    """Non-causal attention of the decoder's queries to the encoder's
    output (``enc_out``, or at decode the ``ck``/``cv`` its prefill
    cached). No softcap and no ``attn_bf16`` rounding, as the reference's;
    at prefill it takes the flash kernel wherever the shapes are
    supported. Returns (out, {"ck", "cv"})."""
    h = _apply_norm(x, p["xnorm"], cfg)
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (h @ p["xq"]).reshape(*h.shape[:2], H, hd)
    if cached_kv is None:
        B, Te = enc_out.shape[:2]
        k = (enc_out @ p["xk"]).reshape(B, Te, KH, hd)
        v = (enc_out @ p["xv"]).reshape(B, Te, KH, hd)
    else:
        k, v = cached_kv["ck"], cached_kv["cv"]
    if mode == "prefill" and flash_supported(q, k):
        out = ops.flash_attention(q, k, v, causal=False,
                                  scale=cfg.query_scale)
    else:
        out = L.flash_attention(q, k, v, causal=False, scale=cfg.query_scale,
                                kv_block=min(512, k.shape[1]))
    out = out.reshape(*out.shape[:2], -1) @ p["xo"]
    return out, {"ck": k, "cv": v}


def _ffn(slot, p, x, cfg):
    """Returns (out, aux): the MoE's router aux loss, else 0."""
    h = _apply_norm(x, p["ffn_norm"], cfg)
    aux = 0.0
    if slot.moe:
        out, aux = L.moe_block(h, p, cfg)
    elif cfg.mlp_type == "gelu":
        out = F.gelu(h @ p["w_up"], approximate="tanh") @ p["w_down"]
    else:
        out = L.swiglu_mlp(h, p)
    if cfg.use_post_norm:
        out = _apply_norm(out, p["ffn_post_norm"], cfg)
    return out, aux


def block_apply(slot: BlockSlot, p, x, cfg, *, positions, mode,
                cache=None, cache_index=None, enc_out=None):
    """One layer. Returns (x, cache_out, aux_loss). A Mamba2 slot's decode
    writes its new conv and SSM states into ``cache`` in place. A
    cross-attention slot adds its attention to ``enc_out`` after the
    self-attention; its prefill returns ``ck``/``cv`` beside ``k``/``v``,
    and its decode reads them from ``cache``."""
    if slot.kind == "mamba":
        h = _apply_norm(x, p["norm"], cfg)
        y, new = L.mamba_block(h, p, cfg,
                               cache=cache if mode == "decode" else None)
        x = x + y
        cache_out = {}
        if mode == "decode":
            for key in ("conv", "ssm"):
                cache[key].copy_(new[key])
            cache_out = cache
        elif mode == "prefill":
            cache_out = mamba_prefill_cache(h, p, cfg)
    else:
        attn_out, cache_out = _self_attn(
            slot, p, x, cfg, positions=positions, mode=mode, cache=cache,
            cache_index=cache_index)
        x = x + attn_out
        if slot.cross_attn:
            xo, ckv = _cross_attn(p, x, enc_out, cfg, mode=mode,
                                  cached_kv=cache if mode == "decode"
                                  else None)
            x = x + xo
            if mode == "prefill":
                cache_out.update(ckv)
    if "ffn_norm" not in p:          # pure-SSM block: no FFN sublayer
        return x, cache_out or {}, 0.0
    ffn_out, aux = _ffn(slot, p, x, cfg)
    return x + ffn_out, cache_out or {}, aux


def mamba_prefill_cache(h, p, cfg):
    """The conv and SSM final states of a prompt, recomputed for the
    decode cache: {"conv": (B, K-1, conv_ch), "ssm": (B, nh, ds, hp)} in
    ``param_dtype``."""
    K = cfg.ssm_conv
    _, xBC, dt = L._split_in_proj(h @ p["in_proj"], cfg)
    conv_state = xBC[:, -(K - 1):, :]
    xBC_c, _ = L._causal_conv(xBC, p["conv_w"])
    xh, Bm, Cm, dt, A = L._ssm_inputs(xBC_c, dt, p, cfg)
    _, hT = L._ssd_inner(xh, dt, A, Bm, Cm, cfg)
    return {"conv": conv_state, "ssm": hT.to(cfg.param_dtype)}


# ---------------------------------------------------------------------------
# stack drivers
# ---------------------------------------------------------------------------

def _row(tree, r: int):
    """Repeat ``r`` of a stacked slot tree."""
    return tree_map(lambda t: t[r], tree)


def run_stack(blocks, x, cfg, *, positions, enc_out=None, mode="train"):
    """The super-block over cfg.repeats, no cache kept (the port does not
    rematerialize). ``mode="train"``: train / eval, blockwise attention;
    ``"prefill"``: the layers as a prefill runs them, the flash kernel
    where the route admits it (an encoder under the decoder's prefill,
    no gradient taken). Returns (x, aux)."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    for r in range(cfg.repeats):
        for slot, p in zip(cfg.slots, blocks):
            x, _, a = block_apply(slot, _row(p, r), x, cfg,
                                  positions=positions, mode=mode,
                                  enc_out=enc_out)
            aux = aux + a
    return x, aux


def run_stack_prefill(blocks, x, cfg, *, positions, enc_out=None):
    """Emitting cache rows. Returns (x, cache_list, aux): per slot, k and v
    stacked over the repeats, (R, B, T, KH, hd) (a cross-attention slot
    also ck and cv, (R, B, Te, KH, hd)), or a Mamba2 slot's conv and SSM
    states, (R, B, K-1, conv_ch) and (R, B, nh, ds, hp)."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    rows = [[] for _ in cfg.slots]
    for r in range(cfg.repeats):
        for si, (slot, p) in enumerate(zip(cfg.slots, blocks)):
            x, c, a = block_apply(slot, _row(p, r), x, cfg,
                                  positions=positions, mode="prefill",
                                  enc_out=enc_out)
            rows[si].append(c)
            aux = aux + a
    cache = [{key: torch.stack([c[key] for c in rs]) for key in rs[0]}
             for rs in rows]
    return x, cache, aux


def run_stack_decode(blocks, cache, x, cfg, *, cache_index, enc_out=None):
    """One token through every layer. Returns (x, cache), the cache
    written in place."""
    positions = torch.full((x.shape[0], 1), cache_index, device=x.device)
    for r in range(cfg.repeats):
        for slot, p, c in zip(cfg.slots, blocks, cache):
            x, _, _ = block_apply(slot, _row(p, r), x, cfg,
                                  positions=positions, mode="decode",
                                  cache=_row(c, r), cache_index=cache_index,
                                  enc_out=enc_out)
    return x, cache


# ---------------------------------------------------------------------------
# full model: embed → stack → logits
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg, tokens):
    x = params["embed"][tokens.long()].to(cfg.param_dtype)
    if cfg.scale_embed:
        # torch.full, not torch.tensor: the latter's detach_ is refused
        # inside a grad transform on the meta device (the dry run)
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=cfg.param_dtype,
                           device=x.device)
    return x


def unembed(params, cfg, x):
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["head"]
    logits = logits.to(F32)
    if cfg.logit_softcap:
        logits = L._softcap(logits, cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab:      # mask vocab-padding slots
        mask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab
        logits = torch.where(mask, logits, L.NEG_INF)
    return logits


def _positions_like(x, offset=0):
    B, T = x.shape[:2]
    return (torch.arange(T, device=x.device) + offset).expand(B, T)


def _trunk_input(params, cfg, tokens, prefix_embeds=None):
    x = embed_tokens(params, cfg, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    if cfg.pos_embed == "learned":
        x = x + params["pos_embed"][:x.shape[1]][None].to(x.dtype)
    return x


def forward(params, cfg: ModelConfig, tokens, *, prefix_embeds=None,
            enc_out=None):
    """tokens: (B, T) int. prefix_embeds: (B, P, D) multimodal prefix.
    enc_out: (B, Te, D) the encoder's output, for cross-attention slots.
    Returns (logits (B, T[+P], V) fp32, aux)."""
    x = _trunk_input(params, cfg, tokens, prefix_embeds)
    x, aux = run_stack(params["blocks"], x, cfg,
                       positions=_positions_like(x), enc_out=enc_out)
    x = _apply_norm(x, params["final_norm"], cfg)
    return unembed(params, cfg, x), aux


def chunked_ce(params, cfg: ModelConfig, x, labels, *, mask=None,
               chunk: int = 1024):
    """Cross-entropy without materializing (B, T, V) logits: unembed,
    log-softmax and gather per T-chunk. Returns (mean_nll, token_count)."""
    B, T, D = x.shape
    chunk = min(chunk, T)
    nck = -(-T // chunk)
    Tp = nck * chunk
    pad_mask = torch.ones((B, T), dtype=F32, device=x.device) \
        if mask is None else mask.to(F32)
    if Tp != T:
        x = F.pad(x, (0, 0, 0, Tp - T))
        labels = F.pad(labels, (0, Tp - T))
        pad_mask = F.pad(pad_mask, (0, Tp - T))
    tot = torch.zeros((), dtype=F32, device=x.device)
    cnt = torch.zeros((), dtype=F32, device=x.device)
    for c in range(nck):
        sl = slice(c * chunk, (c + 1) * chunk)
        logp = torch.log_softmax(unembed(params, cfg, x[:, sl]), dim=-1)
        nll = -torch.gather(logp, -1, labels[:, sl].long()[..., None])[..., 0]
        tot = tot + torch.sum(nll * pad_mask[:, sl])
        cnt = cnt + torch.sum(pad_mask[:, sl])
    return tot / torch.clamp_min(cnt, 1.0), cnt


def sample_logp(params, cfg: ModelConfig, ex):
    """log P_θ(x) of ONE example (no leading batch axis, no aux losses) —
    the quantity whose per-sample gradients form the score matrix S."""
    batch1 = {key: val[None] for key, val in ex.items()}
    x = _trunk_input(params, cfg, batch1["inputs"],
                     batch1.get("prefix_embeds"))
    x, _ = run_stack(params["blocks"], x, cfg, positions=_positions_like(x),
                     enc_out=batch1.get("enc_out"))
    x = _apply_norm(x, params["final_norm"], cfg)
    P = x.shape[1] - batch1["labels"].shape[1]
    if P > 0:
        x = x[:, P:]
    mean_nll, cnt = chunked_ce(params, cfg, x, batch1["labels"],
                               mask=batch1.get("mask"))
    return -mean_nll * cnt


def lm_loss(params, cfg: ModelConfig, batch):
    """batch: {"inputs": (B,T), "labels": (B,T), optional "mask",
    optional "prefix_embeds", optional "enc_out"}. Returns (loss,
    {"nll", "aux"})."""
    x = _trunk_input(params, cfg, batch["inputs"], batch.get("prefix_embeds"))
    x, aux = run_stack(params["blocks"], x, cfg, positions=_positions_like(x),
                       enc_out=batch.get("enc_out"))
    x = _apply_norm(x, params["final_norm"], cfg)
    P = x.shape[1] - batch["labels"].shape[1]
    if P > 0:
        x = x[:, P:]
    loss, _ = chunked_ce(params, cfg, x, batch["labels"],
                         mask=batch.get("mask"))
    return loss + aux, {"nll": loss, "aux": aux}


# ---------------------------------------------------------------------------
# cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, enc_len=0,
               device=None):
    """Zero cache: a list per slot of stacked (R, batch, S, KH, hd) k, v
    (a cross-attention slot also (R, batch, enc_len, KH, hd) ck, cv), or a
    Mamba2 slot's (R, batch, K-1, conv_ch) conv and (R, batch, nh, ds, hp)
    SSM states, all in ``param_dtype``."""
    KH, hd, R = cfg.n_kv_heads, cfg.head_dim, cfg.repeats
    shapes = {"conv": (R, batch, cfg.ssm_conv - 1,
                       cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state),
              "ssm": (R, batch, cfg.ssm_heads, cfg.ssm_state,
                      cfg.ssm_head_dim)}
    cache = []
    for slot in cfg.slots:
        if slot.kind == "mamba":
            keys = ("conv", "ssm")
        else:
            S = min(max_len, slot.window) if slot.window else max_len
            shapes["k"] = shapes["v"] = (R, batch, S, KH, hd)
            shapes["ck"] = shapes["cv"] = (R, batch, enc_len, KH, hd)
            keys = ("k", "v", "ck", "cv") if slot.cross_attn else ("k", "v")
        cache.append({key: torch.zeros(shapes[key], dtype=cfg.param_dtype,
                                       device=device) for key in keys})
    return cache


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, *, enc_len=0):
    """``init_cache``'s tree on the meta device (nothing allocated)."""
    return init_cache(cfg, batch, max_len, enc_len=enc_len, device=META)


def _check_fits(cfg, T: int, P: int, max_len: int) -> None:
    """Raise unless every slot that decodes by position (not a ring) holds
    the prompt's T = P + tokens positions. The reference lays a longer
    prompt out as a ring there too, and its decode then writes at a
    clamped position and reads the wrong keys."""
    for slot in cfg.slots:
        if slot.kind == "mamba":
            continue
        S = min(max_len, slot.window) if slot.window else max_len
        if not _is_ring(slot, S) and T > S:
            raise ValueError(
                f"prefill of {T} positions ({P} prefix + {T - P} tokens) "
                f"does not fit max_len={max_len}: max_len counts the prefix")


def prefill(params, cfg: ModelConfig, tokens, *, max_len: int,
            prefix_embeds=None, enc_out=None):
    """Forward pass that also builds the decode cache.

    Returns (logits (B, 1, V) of the last position, cache, next_index).
    Windowed slots get their last ``window`` keys laid out in ring-buffer
    order (see ``_self_attn``); a cross-attention slot's cache also holds
    the encoder's keys and values ``ck``/``cv`` for ``enc_out``.
    ``max_len`` counts the prefix: a prompt longer than a slot that
    decodes by position raises ``ValueError``."""
    x = _trunk_input(params, cfg, tokens, prefix_embeds)
    T = x.shape[1]
    _check_fits(cfg, T, T - tokens.shape[1], max_len)
    x, cache_rows, _ = run_stack_prefill(params["blocks"], x, cfg,
                                         positions=_positions_like(x),
                                         enc_out=enc_out)
    x = _apply_norm(x, params["final_norm"], cfg)
    # serving needs the last position's logits only
    logits = unembed(params, cfg, x[:, -1:])

    cache = []
    for slot, c in zip(cfg.slots, cache_rows):
        if slot.kind == "mamba":
            cache.append(c)
            continue
        S = min(max_len, slot.window) if slot.window else max_len
        k, v = c["k"], c["v"]                   # (R, B, T, KH, hd)
        if T > S:                               # ring layout of last S keys
            p = np.arange(T - S, T)
            order = torch.from_numpy(np.argsort(p % S)).to(k.device)
            k = k[:, :, T - S:][:, :, order]
            v = v[:, :, T - S:][:, :, order]
        elif T < S:
            k = F.pad(k, (0, 0, 0, 0, 0, S - T))
            v = F.pad(v, (0, 0, 0, 0, 0, S - T))
        out = {"k": k.contiguous(), "v": v.contiguous()}
        if slot.cross_attn:
            out["ck"], out["cv"] = c["ck"], c["cv"]
        cache.append(out)
    return logits, cache, T


def decode_step(params, cfg: ModelConfig, cache, cache_index: int, tokens,
                *, enc_out=None):
    """tokens: (B, 1). Returns (logits (B, 1, V), cache) — the cache is
    written in place. A learned position past the table's last row reads
    the last row, as the reference's clamped index does. A
    cross-attention slot reads the ``ck``/``cv`` its prefill cached;
    ``enc_out`` is kept for the signature."""
    x = embed_tokens(params, cfg, tokens)
    if cfg.pos_embed == "learned":
        row = min(int(cache_index), params["pos_embed"].shape[0] - 1)
        x = x + params["pos_embed"][row][None, None].to(x.dtype)
    x, cache = run_stack_decode(params["blocks"], cache, x, cfg,
                                cache_index=cache_index, enc_out=enc_out)
    x = _apply_norm(x, params["final_norm"], cfg)
    return unembed(params, cfg, x), cache
