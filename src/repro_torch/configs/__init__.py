"""Per-architecture configs (``--arch <id>``), port of ``repro.configs``.

The decoder-only architectures are ported: dense (llama3.2-3b,
llama3-8b, gemma2-2b, gemma2-9b), MoE (qwen3-moe-30b-a3b,
qwen3-moe-235b-a22b), SSM (mamba2-1.3b) and hybrid (jamba-v0.1-52b),
with ``CONFIG`` and ``SMOKE`` exactly as in the reference, and
``get_tuned`` as the reference's. The other architectures of the
reference are listed, so the CLI offers the same choices, and
``get_config``/``get_smoke``/``get_tuned`` of one of them raises
``NotImplementedError`` naming the slice that ports it.
"""
import dataclasses
import importlib

from repro_torch.roadmap import queue

__all__ = ["ARCHS", "LATER", "get_config", "get_smoke", "get_tuned",
           "list_archs"]

ARCHS = {
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "llama3.2-3b": "repro_torch.configs.llama32_3b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_52b",
}

# architecture → what the reference needs that the port does not have yet
LATER = {
    "whisper-base": "the encoder-decoder trunk (models/encdec.py)",
    "pixtral-12b": "the VLM front end (patch-embedding prefix)",
}


def list_archs():
    return sorted({**ARCHS, **LATER})


def _module(name: str):
    if name in LATER:
        raise NotImplementedError(
            f"{name} needs {LATER[name]}, which a later slice of the model "
            f"zoo ports ({queue('models')})")
    return importlib.import_module(ARCHS[name])


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE


def get_tuned(name: str, kind: str = "train"):
    """CONFIG plus the reference's confirmed levers for a workload
    ``kind`` ("train", "prefill", "decode"), as ``repro.configs.get_tuned``
    sets them:

    * attention archs: ``attn_seq_shard`` and ``attn_bf16``, except for
      the MoE family's serving kinds;
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
