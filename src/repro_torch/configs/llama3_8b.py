"""llama3-8b [dense]: GQA, 128k vocab [arXiv:2407.21783].

32L, d=4096, 32H (GQA kv=8, head_dim=128), d_ff=14336, vocab=128256.
"""
from repro_torch.models.config import BlockSlot, ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128_256,
    slots=(BlockSlot(),),
    rope_theta=500_000.0, tie_embeddings=False,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab=128, dtype="float32", remat="none")
