"""Per-architecture configs (``--arch <id>``), port of ``repro.configs``.

The dense-attention architectures are ported (llama3.2-3b, llama3-8b,
gemma2-2b, gemma2-9b), with ``CONFIG`` and ``SMOKE`` exactly as in the
reference. The other architectures of the reference are listed, so the
CLI offers the same choices, and ``get_config``/``get_smoke`` of one of
them raises ``NotImplementedError`` naming the slice that ports it.
"""
import importlib

from repro_torch.roadmap import queue

__all__ = ["ARCHS", "LATER", "get_config", "get_smoke", "list_archs"]

ARCHS = {
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "llama3.2-3b": "repro_torch.configs.llama32_3b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
}

# architecture → what the reference needs that the port does not have yet
LATER = {
    "whisper-base": "the encoder-decoder trunk (models/encdec.py)",
    "mamba2-1.3b": "the Mamba2 SSD block (layers.mamba_block)",
    "qwen3-moe-235b-a22b": "the MoE block (layers.moe_block)",
    "qwen3-moe-30b-a3b": "the MoE block (layers.moe_block)",
    "jamba-v0.1-52b": "the Mamba2 and MoE blocks",
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
