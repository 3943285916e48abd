"""Model configuration + the assigned shape suite; port of
`repro.models.config`, copied field for field.

One `ModelConfig` describes any member of the zoo (dense / MoE / SSM /
hybrid / enc-dec / VLM-audio-stub).  `repro_torch/configs/<arch>.py` files
instantiate the exact assigned architectures; `reduced()` derives the smoke-
test variant of the same family.  `pdtype` / `cdtype` are `torch.dtype`s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv: int = 4
    head_dim: Optional[int] = None  # default d_model // n_heads
    d_ff: int = 512
    vocab: int = 1000
    act: str = "silu"               # silu (SwiGLU) | gelu (GeGLU)
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0      # chatglm "2d RoPE": rotate only this
                                    # fraction of head_dim (0.5), rest passthru
    qk_norm: bool = False           # qwen3
    tie_embeddings: bool = True

    # MoE
    n_experts: int = 0
    top_k: int = 1
    moe_every: int = 1              # MoE MLP on layers where i % moe_every == moe_offset
    moe_offset: int = 0
    n_shared_experts: int = 0       # llama4-style always-on expert
    moe_capacity_factor: float = 1.25
    moe_group: int = 256    # routing-group tokens (dispatch one-hot ∝ this)

    # SSM / hybrid
    ssm_state: int = 0              # mamba2 d_state (0 = no ssm layers)
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128            # SSD chunk length
    attn_every: int = 0             # hybrid: attention on layers where
                                    # i % attn_every == attn_offset (else mamba)
    attn_offset: int = 0

    # enc-dec
    n_enc_layers: int = 0           # >0 => encoder-decoder
    frontend: Optional[str] = None  # "frames" (audio) | "patches" (vlm) stub
    n_frontend_tokens: int = 0      # patch/frame count prepended (vlm)

    # gradient accumulation (production fit knob; trainer + dry-run honor it)
    microbatches: int = 1
    accum_dtype: str = None   # "bfloat16" = compressed grad accumulation

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    optstate_dtype: str = "float32"  # bf16 for the very largest models
    remat: str = "full"             # none | full
    xent_chunk: int = 512           # chunked softmax-xent block

    # attention memory policy
    attn_q_chunk: int = 1024        # streamed (flash-style) attention q block

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows, padded to a multiple of 256 so the vocab dim
        tiles evenly on any production mesh axis (16/32-way).  Labels are
        always < vocab; padded ids are ordinary never-sampled tokens
        (MaxText-style logical vocab padding)."""
        return -(-self.vocab // 256) * 256

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def layer_kind(self, i: int) -> Tuple[str, str]:
        """(mixer, mlp) kind for layer i: mixer in {attn, mamba},
        mlp in {dense, moe}."""
        if self.family in ("ssm",):
            mixer = "mamba"
        elif self.family == "hybrid":
            mixer = ("attn" if self.attn_every and
                     i % self.attn_every == self.attn_offset else "mamba")
        else:
            mixer = "attn"
        if self.n_experts and i % max(self.moe_every, 1) == self.moe_offset:
            mlp = "moe"
        elif self.d_ff > 0:
            mlp = "dense"
        else:
            mlp = "none"            # mamba2: pure mixer blocks, no MLP
        return mixer, mlp

    def layer_groups(self):
        """Partition layers into a repeating period of distinct kinds for
        scan-over-periods (uniform models get period 1)."""
        kinds = [self.layer_kind(i) for i in range(self.n_layers)]
        # find smallest period p dividing n_layers with kinds repeating
        for p in range(1, self.n_layers + 1):
            if self.n_layers % p:
                continue
            if all(kinds[i] == kinds[i % p] for i in range(self.n_layers)):
                return p, kinds[:p]
        return self.n_layers, kinds

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/topology, tiny dimensions."""
        period, _ = self.layer_groups()
        n_layers = period if period <= 8 else 2 * period
        if self.family in ("ssm",):
            n_layers = 2
        changes = dict(
            n_layers=min(max(n_layers, 2), 16),
            d_model=128,
            n_heads=4, n_kv=min(self.n_kv, 2) if self.n_kv else 2,
            head_dim=32, d_ff=256 if self.d_ff > 0 else 0, vocab=512,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16, ssm_chunk=16,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_frontend_tokens=min(self.n_frontend_tokens, 8),
            param_dtype="float32", compute_dtype="float32",
            xent_chunk=64, attn_q_chunk=64, remat="none",
        )
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (shape) cell: what to lower and at what size."""
    name: str                  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic (ssm/hybrid)."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("full-attention arch: 500k decode needs sub-quadratic "
                       "attention (skip per assignment)")
    return True, ""
