"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2 every other layer, attn:mamba 1:7
interleave [arXiv:2403.19887; hf].
ssm_state=128 (our Mamba2-SSD block; published Jamba uses Mamba-1 d_state=16
— we standardize on the SSD formulation for the whole zoo, see DESIGN.md).
Optimizer m/v kept in bf16: 398B params x fp32 m,v would not fit 256 chips."""
from ..models.config import ModelConfig

ARCH_ID = "jamba-1.5-large-398b"
CONFIG = ModelConfig(
    microbatches=8,
    accum_dtype="bfloat16",
    name=ARCH_ID, family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv=8, head_dim=128,
    d_ff=24576, vocab=65536, act="silu",
    n_experts=16, top_k=2, moe_every=2, moe_offset=1,
    attn_every=8, attn_offset=0,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    optstate_dtype="bfloat16",
)
