"""Attention: GQA/MQA with RoPE (+partial) and qk_norm, q-chunk-streamed
self- and cross-attention for train/prefill, and one-token decode against a
(B, S, kv, d) cache; port of `repro.models.attention`.

Under a mesh context (`repro_torch.sharding.use_mesh_rules`) attention
takes the reference's two branches: head parallelism when the heads divide
the axes that "heads" maps to (`heads_shardable`), K/V repeated to the full
head count; otherwise context parallelism, GQA scores and output over the
key sequence with no repeat.  With no mesh `heads_shardable` is True, so
prefill repeats K/V, as the reference does.  The `sharding.constrain`
calls sit where the reference's do; with no mesh they return their
argument.  Scores are accumulated and kept in float32, as the reference's
`preferred_element_type` keeps them: the operands are cast to float32
before the product (a bfloat16 product cast afterwards would round the
scores to bfloat16 first).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from .. import sharding
from .config import ModelConfig
from .layers import (ParamDef, ParamDefs, ShapeDtype, apply_rope,
                     host_scalar, remat, rms_norm, rope_tables)

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
    y = x @ w.reshape(D, H * k)
    if y.dim() == 3:     # sharded: the head split must not cut a shard
        y = sharding.constrain(y, "batch", "seq", None)
    return y.view(*x.shape[:-1], H, k)


def _merge_heads(out, w):
    """out (B, S, H, k) by a (H, k, D) weight -> (B, S, D)."""
    H, k, D = w.shape
    # one (rows, H·k) product, as matmul folds it: a DTensor's view may
    # carry strides that keep matmul from folding (a batched product,
    # rounded otherwise)
    y = out.reshape(-1, H * k) @ w.reshape(H * k, D)
    return y.view(*out.shape[:-2], D)


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


def heads_shardable(cfg: ModelConfig) -> bool:
    """True iff n_heads divides evenly over the mesh axes assigned to
    'heads' — decides head-TP vs context-parallel attention.  True with no
    mesh context."""
    mesh = sharding.current_mesh()
    if mesh is None:
        return True
    part = sharding.spec_for(("heads",), mesh)[0]
    if part is None:
        return False
    sizes = sharding.axis_sizes(mesh)
    n = 1
    for a in (part if isinstance(part, tuple) else (part,)):
        n *= sizes[a]
    return n > 1 and cfg.n_heads % n == 0


def attention(cfg: ModelConfig, p: Mapping[str, torch.Tensor],
              x: torch.Tensor, prefix: str = "attn",
              kv_x: Optional[torch.Tensor] = None, causal: bool = True,
              positions: Optional[torch.Tensor] = None,
              rope: bool = True, tables=None) -> torch.Tensor:
    """Full attention for train/prefill, streamed over query chunks of
    `cfg.attn_q_chunk`: each chunk's softmax is exact (its whole key row is
    there), so peak memory is (B, H, qc, Sk).  With `kv_x` it is
    cross-attention (keys and values from kv_x, no rope, no mask).  A loop
    stands in for the reference's scan; each chunk is recomputed in the
    backward (`remat`), so its float32 scores are never stored.  Padded
    query positions sit at Sk + 1, as the reference pads them.  `tables`,
    when given, is `self_tables` at the default positions."""
    B, S, D = x.shape
    cross = kv_x is not None
    kv_src = kv_x if cross else x
    Sk = kv_src.shape[1]
    kv_positions = torch.arange(Sk, device=x.device)[None, :]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    else:
        tables = None
    q, k, v = _project_qkv(cfg, p, x, kv_src, prefix, positions, kv_positions,
                           rope=rope and not cross, tables=tables)
    scale = _scale(cfg)
    G = cfg.n_heads // cfg.n_kv
    head_tp = heads_shardable(cfg)
    if head_tp:
        # head tensor parallelism: K/V repeated to the full heads, so the
        # products keep one head tiling
        if G > 1:
            k = torch.repeat_interleave(k, G, dim=2)
            v = torch.repeat_interleave(v, G, dim=2)
        q = sharding.constrain(q, "batch", None, "heads", None)
        k = sharding.constrain(k, "batch", None, "heads", None)
        v = sharding.constrain(v, "batch", None, "heads", None)
        kf = k.float().permute(0, 2, 3, 1)                  # (B, H, d, Sk)
        vh = v.permute(0, 2, 1, 3)                          # (B, H, Sk, d)
    else:
        # context parallelism: the heads do not divide the model axis
        # (gemma's 8, deepseek's 56 on 16); the key sequence is sharded
        # instead, and softmax and probs·V reduce over it
        q = sharding.constrain(q, "batch", None, None, None)
        k = sharding.constrain(k, "batch", "seq", "kv_heads", None)
        v = sharding.constrain(v, "batch", "seq", "kv_heads", None)
    qc = min(cfg.attn_q_chunk, S)
    n = -(-S // qc)
    pad = n * qc - S
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
        positions = torch.nn.functional.pad(positions, (0, pad),
                                            value=Sk + 1)
    positions = positions.expand(B, n * qc)
    kv_pos = torch.arange(Sk, device=x.device)
    masked = causal and not cross

    def chunk_out(qb, pb):
        scores = (qb.float().permute(0, 2, 1, 3) @ kf) * scale  # (B,H,qc,Sk)
        scores = sharding.constrain(scores, "batch", "heads", None, None)
        if masked:
            mask = pb[:, None, :, None] >= kv_pos[None, None, None, :]
            scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(cfg.cdtype)
        return (probs @ vh).permute(0, 2, 1, 3)

    def chunk_out_cp(qb, pb):
        scores = _gqa_scores(qb, k) * scale                  # (B,KV,G,qc,Sk)
        scores = sharding.constrain(scores, "batch", None, None, None, "seq")
        if masked:
            mask = (pb[:, None, None, :, None]
                    >= kv_pos[None, None, None, None, :])
            scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(cfg.cdtype)
        return _gqa_out(probs, v)

    body = chunk_out if head_tp else chunk_out_cp
    outs = [remat(body, q[:, c * qc:(c + 1) * qc],
                  positions[:, c * qc:(c + 1) * qc]) for c in range(n)]
    out = torch.cat(outs, dim=1)[:, :S]
    out = sharding.constrain(out, "batch", None,
                             "heads" if head_tp else None, None)
    return _merge_heads(out, p[f"{prefix}/wo"].to(cfg.cdtype))


# ---------------------------------------------------------------------------
# decode path: a (B, S, kv, d) cache written in place
# ---------------------------------------------------------------------------
def init_cache_shapes(cfg: ModelConfig, batch: int, seq_len: int,
                      dtype=None) -> Dict[str, ShapeDtype]:
    dt = dtype or cfg.cdtype
    shape = (batch, seq_len, cfg.n_kv, cfg.head_dim)
    return {"k": ShapeDtype(shape, dt), "v": ShapeDtype(shape, dt)}


def cache_pspec():
    """Specs of a layer's {k, v} cache under the active mesh rules."""
    spec = sharding.spec_for(("cache_batch", "cache_seq", "kv_heads", None))
    return {"k": spec, "v": spec}


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
    `pos`.  Under a mesh context the write is the reference's masked
    select over all S, which stays local to each shard of a
    sequence-sharded cache; it replaces the dict's entries."""
    B = x.shape[0]
    pos = int(pos)
    S = cache["k"].shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(cfg, p, x, x, prefix, positions, positions,
                                   rope=rope, tables=tables)
    if update_cache and sharding.current_mesh() is not None:
        at = torch.arange(S, device=x.device)[None, :, None, None] == pos
        cache["k"] = torch.where(at, k_new.to(cache["k"].dtype), cache["k"])
        cache["v"] = torch.where(at, v_new.to(cache["v"].dtype), cache["v"])
    elif update_cache:
        cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
    k = sharding.constrain(cache["k"], "cache_batch", "cache_seq",
                           "kv_heads", None)
    v = sharding.constrain(cache["v"], "cache_batch", "cache_seq",
                           "kv_heads", None)
    scores = _gqa_scores(q, k.to(cfg.cdtype)) * _scale(cfg)
    # the flash-decode pattern: scores stay sequence-sharded
    scores = sharding.constrain(scores, "cache_batch", None, None, None,
                                "cache_seq")
    valid = torch.arange(S, device=x.device) <= pos
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(cfg.cdtype)
    out = _gqa_out(probs, v.to(cfg.cdtype))
    out = sharding.constrain(out, "cache_batch", None, None, None)
    return _merge_heads(out, p[f"{prefix}/wo"].to(cfg.cdtype)), cache
