"""gemma2-9b [dense]: local/global alternating attention, logit softcaps.

42L, d=3584, 16H (GQA kv=8, head_dim=256), d_ff=14336, vocab=256000
[arXiv:2408.00118]. Sliding window 4096 on local (even) layers.
"""
from repro_torch.models.config import BlockSlot, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab=256_000,
    slots=(BlockSlot(window=4096), BlockSlot()),
    rope_theta=10_000.0, attn_softcap=50.0, logit_softcap=30.0,
    use_post_norm=True, scale_embed=True, tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab=128, slots=(BlockSlot(window=8), BlockSlot()),
    dtype="float32", remat="none")
