"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1 + 1 shared expert, every layer
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from ..models.config import ModelConfig

ARCH_ID = "llama4-scout-17b-a16e"
CONFIG = ModelConfig(
    microbatches=4,
    accum_dtype="bfloat16",
    name=ARCH_ID, family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, head_dim=128,
    d_ff=8192, vocab=202048, act="silu",
    n_experts=16, top_k=1, moe_every=1, n_shared_experts=1,
    optstate_dtype="bfloat16",
)
