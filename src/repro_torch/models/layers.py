"""Shared neural layers: params-as-data, norms, RoPE, gated MLPs; port of
`repro.models.layers` (serving only: `chunked_xent` belongs to training,
ROADMAP item 16c).

Models are functions over flat param dicts ("path" -> tensor).  Each param
is declared once as a ParamDef carrying shape, dtype, init scale and
*logical* sharding axes, the same paths and shapes as the reference's, so
the reference's weights carry across by name (`convert.lm_params_from_numpy`).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig


class ParamDef(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype
    logical: Tuple[Optional[str], ...]
    scale: float = 1.0          # normal stddev multiplier; 0 => zeros, -1 => ones


ParamDefs = Dict[str, ParamDef]


class ShapeDtype(NamedTuple):
    """A tensor's shape and dtype with no storage (the counterpart of
    `jax.ShapeDtypeStruct`)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def init_params(defs: ParamDefs, generator: torch.Generator
                ) -> Dict[str, torch.Tensor]:
    """Draw every param on the generator's device, in sorted path order as
    the reference does.  The stream is torch's, not `jax.random`'s: the
    values differ from the reference's, the scales do not."""
    dev = generator.device
    out = {}
    for path, d in sorted(defs.items()):
        if d.scale == 0.0:
            out[path] = torch.zeros(d.shape, dtype=d.dtype, device=dev)
        elif d.scale == -1.0:
            out[path] = torch.ones(d.shape, dtype=d.dtype, device=dev)
        else:
            fan_in = d.shape[0] if len(d.shape) > 1 else max(d.shape[0], 1)
            std = d.scale / math.sqrt(fan_in)
            out[path] = (torch.randn(d.shape, generator=generator,
                                     dtype=torch.float32, device=dev)
                         * std).to(d.dtype)
    return out


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """In float32, then cast back to x's dtype before the weight."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w.to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, fraction: float, theta: float, device=None):
    """Frequencies for the rotated sub-dimension (chatglm's '2d RoPE' rotates
    only the first half of head_dim: fraction=0.5; standard: fraction=1).
    Formed on `device` by kernels alone: no host-to-device copy, which
    would wait for the card."""
    rot = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    base = torch.full((), theta, dtype=torch.float32, device=device)
    return rot, 1.0 / torch.pow(base, exps)


def rope_tables(positions: torch.Tensor, head_dim: int, fraction: float,
                theta: float):
    """(cos, sin) of the rotation at `positions` (broadcastable to (..., S)),
    each (..., S, 1, rot/2) float32, or None when nothing rotates.  A
    forward computes them once and passes them to every layer."""
    rot, inv = rope_freqs(head_dim, fraction, theta, device=positions.device)
    if rot == 0:
        return None
    ang = positions[..., None].to(torch.float32) * inv        # (..., S, rot/2)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, fraction: float,
               theta: float, tables=None) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S); `tables`,
    when given, is `rope_tables` at those positions.

    Rotates *interleaved* pairs (x[..., 0::2], x[..., 1::2]) restacked in
    place, as the reference does — not the half-split of most PyTorch
    code — over the first `rot` entries of D; the rest pass through."""
    D = x.shape[-1]
    if tables is None:
        tables = rope_tables(positions, D, fraction, theta)
    if tables is None:
        return x
    cos, sin = tables
    rot = 2 * cos.shape[-1]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------
def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None,
             prefix: str = "mlp", stack: Tuple[int, ...] = ()) -> ParamDefs:
    ff = d_ff or cfg.d_ff
    L = ("layers",) * len(stack)
    return {
        f"{prefix}/wg": ParamDef(stack + (cfg.d_model, ff), cfg.pdtype,
                                 L + ("fsdp", "ff")),
        f"{prefix}/wu": ParamDef(stack + (cfg.d_model, ff), cfg.pdtype,
                                 L + ("fsdp", "ff")),
        f"{prefix}/wo": ParamDef(stack + (ff, cfg.d_model), cfg.pdtype,
                                 L + ("ff", "fsdp")),
    }


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "silu":
        return F.silu(x)
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp_apply(cfg: ModelConfig, p: Mapping[str, torch.Tensor],
              x: torch.Tensor, prefix: str = "mlp") -> torch.Tensor:
    g = _act(cfg, x @ p[f"{prefix}/wg"].to(cfg.cdtype))
    u = x @ p[f"{prefix}/wu"].to(cfg.cdtype)
    return (g * u) @ p[f"{prefix}/wo"].to(cfg.cdtype)


# ---------------------------------------------------------------------------
# embeddings and the last position's logits
# ---------------------------------------------------------------------------
def embed_defs(cfg: ModelConfig) -> ParamDefs:
    V = cfg.padded_vocab
    defs = {"embed/tok": ParamDef((V, cfg.d_model), cfg.pdtype,
                                  ("vocab", "fsdp"), scale=1.0)}
    if not cfg.tie_embeddings:
        defs["embed/out"] = ParamDef((cfg.d_model, V), cfg.pdtype,
                                     ("fsdp", "vocab"))
    return defs


def host_scalar(value, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as a Python float: an operand that costs
    no host-to-device copy (a copy from pageable memory waits for the
    card).  A tensor times it computes as times the rounded scalar."""
    return float(torch.as_tensor(value, dtype=torch.float32).to(dtype))


def embed_tokens(cfg: ModelConfig, p, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the table, × √d_model — both in the compute dtype (√d_model
    is taken in float32 and cast, as the reference does)."""
    emb = p["embed/tok"].to(cfg.cdtype)
    scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32))
    return emb[tokens] * host_scalar(scale, cfg.cdtype)


def _out_matrix(cfg: ModelConfig, p) -> torch.Tensor:
    if cfg.tie_embeddings:
        return p["embed/tok"].to(cfg.cdtype).T
    return p["embed/out"].to(cfg.cdtype)


def logits_last(cfg: ModelConfig, p, h: torch.Tensor) -> torch.Tensor:
    """Logits over the padded vocabulary for the last position only: h
    (B, D) -> (B, padded_vocab)."""
    return h @ _out_matrix(cfg, p)
