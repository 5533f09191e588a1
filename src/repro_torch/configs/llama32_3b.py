"""llama3.2-3b [dense]: small llama3 [hf:meta-llama/Llama-3.2-3B].

28L, d=3072, 24H (GQA kv=8, head_dim=128), d_ff=8192, vocab=128256.
"""
from repro_torch.models.config import BlockSlot, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=128_256,
    slots=(BlockSlot(),),
    rope_theta=500_000.0, tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab=128, dtype="float32", remat="none")
