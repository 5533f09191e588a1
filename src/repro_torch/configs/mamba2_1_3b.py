"""mamba2-1.3b [ssm]: SSD (state-space duality), attention-free
[arXiv:2405.21060].

48L, d=2048, ssm_state=128, expand=2 (d_inner=4096), head_dim=64 (64 ssm
heads), vocab=50280.
"""
from repro_torch.models.config import BlockSlot, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=0, vocab=50_280,
    slots=(BlockSlot(kind="mamba"),),
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1, ssm_conv=4,
    ssd_chunk=256, tie_embeddings=True,
)
# mamba blocks have no FFN: models/lm.py init_slot gives a pure-SSM slot
# (d_ff == 0, no MoE) none, and block_apply returns after the mixer.

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, ssm_state=16, ssm_head_dim=16, ssm_groups=1,
    ssd_chunk=8, vocab=128, dtype="float32", remat="none")
