"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024, 2d RoPE (half-dim rotation) [arXiv:2406.12793; hf]."""
from ..models.config import ModelConfig

ARCH_ID = "chatglm3-6b"
CONFIG = ModelConfig(
    name=ARCH_ID, family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv=2, head_dim=128,
    d_ff=13696, vocab=65024, act="silu",
    rope_fraction=0.5,      # chatglm rotates only half of head_dim
)
