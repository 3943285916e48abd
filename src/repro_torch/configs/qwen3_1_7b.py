"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936, qk_norm [hf:Qwen/Qwen3-8B; hf]."""
from ..models.config import ModelConfig

ARCH_ID = "qwen3-1.7b"
CONFIG = ModelConfig(
    name=ARCH_ID, family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv=8, head_dim=128,
    d_ff=6144, vocab=151936, act="silu",
    qk_norm=True,
)
