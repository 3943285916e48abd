"""seamless-m4t-medium [audio]: enc-dec multimodal backbone.
12L d_model=1024 16H (GQA kv=16 == MHA) d_ff=4096 vocab=256206
[arXiv:2308.11596; hf].  Audio frontend is a stub: input_specs supplies
precomputed frame embeddings (assignment rule)."""
from ..models.config import ModelConfig

ARCH_ID = "seamless-m4t-medium"
CONFIG = ModelConfig(
    name=ARCH_ID, family="encdec",
    n_enc_layers=12, n_layers=12,
    d_model=1024, n_heads=16, n_kv=16, head_dim=64,
    d_ff=4096, vocab=256206, act="silu",
    frontend="frames",
)
