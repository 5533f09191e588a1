"""jamba-v0.1-52b [hybrid]: Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887].

32L (4 super-blocks of 8: attention at slot 4, MoE FFN on odd slots),
d=4096, 32H (GQA kv=8, head_dim=128), d_ff=14336, vocab=65536.
Mamba blocks unified on the SSD (Mamba-2) formulation — DESIGN.md §8.
"""
from repro_torch.models.config import BlockSlot, ModelConfig

_M = BlockSlot(kind="mamba")
_ME = BlockSlot(kind="mamba", moe=True)
_A = BlockSlot(kind="attn")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=65_536,
    slots=(_M, _ME, _M, _ME, _A, _ME, _M, _ME),
    n_experts=16, top_k=2, capacity_factor=1.25,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_groups=1, ssm_conv=4,
    ssd_chunk=256,
    rope_theta=1_000_000.0, tie_embeddings=False,
)

SMOKE = CONFIG.scaled(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab=128, n_experts=4, top_k=2, capacity_factor=8.0,
    ssm_state=16, ssm_head_dim=16, ssd_chunk=8,
    dtype="float32", remat="none")
