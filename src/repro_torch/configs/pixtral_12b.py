"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, pixtral-ViT frontend (STUB: precomputed patch embeddings) +
mistral-nemo decoder [hf:mistralai/Pixtral-12B-2409; unverified]."""
from ..models.config import ModelConfig

ARCH_ID = "pixtral-12b"
CONFIG = ModelConfig(
    microbatches=2,
    name=ARCH_ID, family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv=8, head_dim=128,
    d_ff=14336, vocab=131072, act="silu",
    frontend="patches", n_frontend_tokens=1024,
)
