"""pixtral-12b [vlm]: pixtral-ViT + mistral-nemo text decoder
[hf:mistralai/Pixtral-12B-2409]. The ViT frontend is a STUB: a batch
carries precomputed patch embeddings ``prefix_embeds`` (B, n_patches,
d_model), which ``SyntheticLM`` draws.

40L, d=5120, 32H (GQA kv=8, head_dim=128), d_ff=14336, vocab=131072.
"""
from repro_torch.models.config import BlockSlot, ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131_072,
    slots=(BlockSlot(),),
    n_patches=256,
    rope_theta=1_000_000_000.0, tie_embeddings=False,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab=128, n_patches=8, dtype="float32", remat="none")
