"""qwen3-moe-235b-a22b [moe]: 128 experts top-8 [hf:Qwen/Qwen3-235B-A22B].

94L, d=4096, 64H (GQA kv=4, head_dim=128), expert d_ff=1536, vocab=151936.
"""
from repro_torch.models.config import BlockSlot, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151_936,
    slots=(BlockSlot(moe=True),),
    n_experts=128, top_k=8, capacity_factor=1.25,
    rope_theta=1_000_000.0, tie_embeddings=False,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64,
    vocab=128, n_experts=8, top_k=2, capacity_factor=8.0,
    dtype="float32", remat="none")
