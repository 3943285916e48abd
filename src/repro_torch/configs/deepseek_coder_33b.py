"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256, llama-arch [arXiv:2401.14196; hf].
Note: 56 heads on a 16-way model axis shard unevenly; GSPMD pads (the waste
is visible in the roofline and addressed in §Perf)."""
from ..models.config import ModelConfig

ARCH_ID = "deepseek-coder-33b"
CONFIG = ModelConfig(
    microbatches=4,
    accum_dtype="bfloat16",
    name=ARCH_ID, family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv=8, head_dim=128,
    d_ff=19200, vocab=32256, act="silu",
)
