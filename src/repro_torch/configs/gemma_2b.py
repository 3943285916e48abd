"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000,
GeGLU, head_dim=256 [arXiv:2403.08295; hf]."""
from ..models.config import ModelConfig

ARCH_ID = "gemma-2b"
CONFIG = ModelConfig(
    name=ARCH_ID, family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv=1, head_dim=256,
    d_ff=16384, vocab=256000, act="gelu",
)
