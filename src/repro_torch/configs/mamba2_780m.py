"""mamba2-780m [ssm]: 48L d_model=1536 attn-free, ssm_state=128,
vocab=50280, SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from ..models.config import ModelConfig

ARCH_ID = "mamba2-780m"
CONFIG = ModelConfig(
    name=ARCH_ID, family="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv=1,  # attn-free (unused)
    head_dim=64,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
)
