"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from ..models.config import ModelConfig

ARCH_ID = "granite-moe-1b-a400m"
CONFIG = ModelConfig(
    name=ARCH_ID, family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv=8, head_dim=64,
    d_ff=512, vocab=49155, act="silu",
    n_experts=32, top_k=8, moe_every=1,
)
