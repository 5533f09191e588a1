"""Per-architecture configs (``--arch <id>``), port of ``repro.configs``.

All ten architectures of the reference: dense (llama3.2-3b, llama3-8b,
gemma2-2b, gemma2-9b), MoE (qwen3-moe-30b-a3b, qwen3-moe-235b-a22b), SSM
(mamba2-1.3b), hybrid (jamba-v0.1-52b), audio encoder-decoder
(whisper-base) and VLM (pixtral-12b), with ``CONFIG`` and ``SMOKE``
exactly as in the reference, and ``get_tuned`` as the reference's.
"""
import dataclasses
import importlib

__all__ = ["ARCHS", "get_config", "get_smoke", "get_tuned", "list_archs"]

ARCHS = {
    "whisper-base": "repro_torch.configs.whisper_base",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "llama3.2-3b": "repro_torch.configs.llama32_3b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_52b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
}


def list_archs():
    return sorted(ARCHS)


def get_config(name: str):
    return importlib.import_module(ARCHS[name]).CONFIG


def get_smoke(name: str):
    return importlib.import_module(ARCHS[name]).SMOKE


def get_tuned(name: str, kind: str = "train"):
    """CONFIG plus the reference's confirmed levers for a workload
    ``kind`` ("train", "prefill", "decode"), as ``repro.configs.get_tuned``
    sets them:

    * attention archs and the encoder-decoder ("encdec", "audio")
      families: ``attn_seq_shard`` and ``attn_bf16``, except for the MoE
      family's serving kinds;
    * SSM/hybrid archs: ``ssd_factored``, ``ssd_bf16`` and ``ssd_shard``;
    * qwen3-moe-235b: ``remat="full"``; jamba: ``moe_ep_over_data``.

    The port acts on ``attn_bf16``, ``ssd_factored`` and ``ssd_bf16``; the
    sharding levers are recorded and inert on one device, as the
    reference's are without a mesh.
    """
    cfg = get_config(name)
    kw = {}
    attn_ok = kind == "train" or cfg.family != "moe"
    if attn_ok and (any(s.kind == "attn" for s in cfg.slots)
                    or cfg.family in ("encdec", "audio")):
        kw.update(attn_seq_shard=True, attn_bf16=True)
    if any(s.kind == "mamba" for s in cfg.slots):
        kw.update(ssd_factored=True, ssd_bf16=True, ssd_shard=True)
    if name == "qwen3-moe-235b-a22b":
        kw.update(remat="full")
    if name == "jamba-v0.1-52b":
        kw.update(moe_ep_over_data=True)
    return dataclasses.replace(cfg, **kw)
