"""whisper-base [audio]: enc-dec, conv frontend stubbed to frame embeddings.

6L enc + 6L dec, d=512, 8H MHA, d_ff=2048, vocab=51865 [arXiv:2212.04356].
Decoder positions are architecturally capped at 448 learned positions.
"""
from repro_torch.models.config import BlockSlot, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab=51865,
    slots=(BlockSlot(cross_attn=True),),
    enc_layers=6, enc_d_model=512, enc_n_heads=8, enc_d_ff=2048,
    enc_seq=1500, max_target_positions=448,
    norm_type="layer", mlp_type="gelu", pos_embed="learned",
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab=128, enc_layers=2, enc_d_model=64, enc_n_heads=4, enc_d_ff=128,
    enc_seq=16, max_target_positions=32, dtype="float32", remat="none")
