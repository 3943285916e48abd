"""Attention: GQA/MQA with RoPE (+partial) and qk_norm, q-chunk-streamed
causal attention for prefill, and one-token decode against a (B, S, kv, d)
cache; port of `repro.models.attention` on one device.

With no mesh the reference takes its head-parallel branch
(`heads_shardable` is True), so prefill repeats K/V to the full head count.
Scores are accumulated and kept in float32, as the reference's
`preferred_element_type` keeps them: the operands are cast to float32
before the product (a bfloat16 product cast afterwards would round the
scores to bfloat16 first).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from .config import ModelConfig
from .layers import (ParamDef, ParamDefs, ShapeDtype, apply_rope,
                     host_scalar, rms_norm, rope_tables)

NEG_INF = -1e30


def attn_defs(cfg: ModelConfig, prefix: str = "attn",
              stack: Tuple[int, ...] = (), cross: bool = False) -> ParamDefs:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    L = ("layers",) * len(stack)
    defs = {
        f"{prefix}/wq": ParamDef(stack + (D, H, hd), cfg.pdtype,
                                 L + ("fsdp", "heads", "head_dim")),
        f"{prefix}/wk": ParamDef(stack + (D, KV, hd), cfg.pdtype,
                                 L + ("fsdp", "kv_heads", "head_dim")),
        f"{prefix}/wv": ParamDef(stack + (D, KV, hd), cfg.pdtype,
                                 L + ("fsdp", "kv_heads", "head_dim")),
        f"{prefix}/wo": ParamDef(stack + (H, hd, D), cfg.pdtype,
                                 L + ("heads", "head_dim", "fsdp")),
    }
    if cfg.qk_norm and not cross:
        defs[f"{prefix}/qnorm"] = ParamDef(stack + (hd,), cfg.pdtype,
                                           L + (None,), scale=-1.0)
        defs[f"{prefix}/knorm"] = ParamDef(stack + (hd,), cfg.pdtype,
                                           L + (None,), scale=-1.0)
    return defs


def _heads(x, w):
    """x (B, S, D) by a (D, H, k) weight -> (B, S, H, k)."""
    D, H, k = w.shape
    return (x @ w.reshape(D, H * k)).view(*x.shape[:-1], H, k)


def _merge_heads(out, w):
    """out (B, S, H, k) by a (H, k, D) weight -> (B, S, D)."""
    H, k, D = w.shape
    return out.reshape(*out.shape[:-2], H * k) @ w.reshape(H * k, D)


def _project_qkv(cfg, p, x, kv_x, prefix, positions, kv_positions,
                 rope: bool = True, tables=None):
    """q, k, v of x (k, v of kv_x); `tables`, when given, is `rope_tables`
    at positions that are also kv_positions (self-attention)."""
    q = _heads(x, p[f"{prefix}/wq"].to(cfg.cdtype))
    k = _heads(kv_x, p[f"{prefix}/wk"].to(cfg.cdtype))
    v = _heads(kv_x, p[f"{prefix}/wv"].to(cfg.cdtype))
    if cfg.qk_norm and f"{prefix}/qnorm" in p:
        q = rms_norm(q, p[f"{prefix}/qnorm"], cfg.norm_eps)
        k = rms_norm(k, p[f"{prefix}/knorm"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta,
                       tables)
        k = apply_rope(k, kv_positions, cfg.rope_fraction, cfg.rope_theta,
                       tables)
    return q, k, v


def self_tables(cfg: ModelConfig, positions: torch.Tensor):
    """`rope_tables` of self-attention at `positions`, shared by every
    layer of a forward."""
    return rope_tables(positions, cfg.head_dim, cfg.rope_fraction,
                       cfg.rope_theta)


def _scale(cfg: ModelConfig) -> float:
    """1/√head_dim in float32, as a host scalar."""
    return host_scalar(1.0 / torch.sqrt(torch.tensor(
        float(cfg.head_dim), dtype=torch.float32)), torch.float32)


def _gqa_scores(q, k):
    """q: (B,Sq,H,d)  k: (B,Sk,KV,d) -> float32 scores (B, KV, G, Sq, Sk)."""
    B, Sq, H, d = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, d).permute(0, 2, 3, 1, 4)
    return qg.float() @ k.float().permute(0, 2, 3, 1)[:, :, None]


def _gqa_out(probs, v):
    """probs: (B,KV,G,Sq,Sk)  v: (B,Sk,KV,d) -> (B,Sq,H,d)."""
    B, KV, G, Sq, Sk = probs.shape
    out = probs @ v.permute(0, 2, 1, 3)[:, :, None]         # (B,KV,G,Sq,d)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, KV * G, -1)


def attention(cfg: ModelConfig, p: Mapping[str, torch.Tensor],
              x: torch.Tensor, prefix: str = "attn", causal: bool = True,
              positions: Optional[torch.Tensor] = None,
              rope: bool = True, tables=None) -> torch.Tensor:
    """Causal self-attention for prefill, streamed over query chunks of
    `cfg.attn_q_chunk`: each chunk's softmax is exact (its whole key row is
    there), so peak memory is (B, H, qc, S).  A loop stands in for the
    reference's scan (serving has no backward, so nothing to recompute);
    padded query positions sit at S + 1, as the reference pads them.
    `tables`, when given, is `self_tables` at the default positions."""
    B, S, D = x.shape
    kv_positions = torch.arange(S, device=x.device)[None, :]
    if positions is None:
        positions = kv_positions
    else:
        tables = None
    q, k, v = _project_qkv(cfg, p, x, x, prefix, positions, kv_positions,
                           rope=rope, tables=tables)
    scale = _scale(cfg)
    G = cfg.n_heads // cfg.n_kv
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    kf = k.float().permute(0, 2, 3, 1)                      # (B, H, d, S)
    vh = v.permute(0, 2, 1, 3)                              # (B, H, S, d)
    qc = min(cfg.attn_q_chunk, S)
    n = -(-S // qc)
    pad = n * qc - S
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
        positions = torch.nn.functional.pad(positions, (0, pad), value=S + 1)
    positions = positions.expand(B, n * qc)
    kv_pos = torch.arange(S, device=x.device)
    outs = []
    for c in range(n):
        qb = q[:, c * qc:(c + 1) * qc]
        pb = positions[:, c * qc:(c + 1) * qc]
        scores = (qb.float().permute(0, 2, 1, 3) @ kf) * scale   # (B,H,qc,S)
        if causal:
            mask = pb[:, None, :, None] >= kv_pos[None, None, None, :]
            scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(cfg.cdtype)
        outs.append((probs @ vh).permute(0, 2, 1, 3))
    out = torch.cat(outs, dim=1)[:, :S]
    return _merge_heads(out, p[f"{prefix}/wo"].to(cfg.cdtype))


# ---------------------------------------------------------------------------
# decode path: a (B, S, kv, d) cache written in place
# ---------------------------------------------------------------------------
def init_cache_shapes(cfg: ModelConfig, batch: int, seq_len: int,
                      dtype=None) -> Dict[str, ShapeDtype]:
    dt = dtype or cfg.cdtype
    shape = (batch, seq_len, cfg.n_kv, cfg.head_dim)
    return {"k": ShapeDtype(shape, dt), "v": ShapeDtype(shape, dt)}


def decode_attention(cfg: ModelConfig, p: Mapping[str, torch.Tensor],
                     x: torch.Tensor, cache: Dict[str, torch.Tensor],
                     pos: int, prefix: str = "attn",
                     update_cache: bool = True, rope: bool = True,
                     tables=None) -> Tuple[torch.Tensor, Dict]:
    """One-token attention against a (B, S, kv, d) cache.  The new (k, v)
    is written at `pos` by index, in place (the reference's masked select
    over all S, kept there for a sequence-sharded cache, reads and writes
    the whole cache a step for the same values); positions past `pos` are
    masked out of the softmax.  `tables`, when given, is `self_tables` at
    `pos`."""
    B = x.shape[0]
    pos = int(pos)
    S = cache["k"].shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(cfg, p, x, x, prefix, positions, positions,
                                   rope=rope, tables=tables)
    if update_cache:
        cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
    k, v = cache["k"], cache["v"]
    scores = _gqa_scores(q, k.to(cfg.cdtype)) * _scale(cfg)
    valid = torch.arange(S, device=x.device) <= pos
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(cfg.cdtype)
    out = _gqa_out(probs, v.to(cfg.cdtype))
    return _merge_heads(out, p[f"{prefix}/wo"].to(cfg.cdtype)), cache
