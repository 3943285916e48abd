"""Decoder-only LM assembly for dense attention models: pre-norm blocks run
as a loop over layers; port of `repro.models.transformer` for
(attn, dense) layers.

The parameters keep the reference's stacked layout: `blk{pos}/...` paths
with a leading axis over the periods of `ModelConfig.layer_groups()` (a
dense model has period 1, so the axis runs over the layers).  The
reference's scan over periods, its remat and its sharding constraints have
no counterpart here: on one device a serving forward has neither a mesh
nor a backward.  MoE, mamba and encoder–decoder blocks are still to port
(ROADMAP item 16b).
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from .attention import (attention, attn_defs, decode_attention,
                        init_cache_shapes, self_tables)
from .config import ModelConfig
from .layers import (ParamDef, ParamDefs, embed_defs, embed_tokens,
                     logits_last, mlp_apply, mlp_defs, rms_norm)

DENSE = ("attn", "dense")


def check_dense(cfg: ModelConfig) -> None:
    """Raise for a config whose blocks this port cannot run yet."""
    kinds = {cfg.layer_kind(i) for i in range(cfg.n_layers)}
    if cfg.is_encdec or cfg.frontend or kinds != {DENSE}:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (layer kinds "
            f"{sorted(kinds)}, encoder layers {cfg.n_enc_layers}, frontend "
            f"{cfg.frontend!r}) needs MoE, mamba, encoder-decoder or "
            f"frontend blocks, which the port does not have yet (ROADMAP "
            f"item 16)")


def _block_defs(cfg: ModelConfig, pos: int, n_periods: int) -> ParamDefs:
    stack = (n_periods,)
    pre = f"blk{pos}"
    defs: ParamDefs = {
        f"{pre}/norm1": ParamDef(stack + (cfg.d_model,), cfg.pdtype,
                                 ("layers", None), scale=-1.0),
        f"{pre}/norm2": ParamDef(stack + (cfg.d_model,), cfg.pdtype,
                                 ("layers", None), scale=-1.0),
    }
    defs.update(attn_defs(cfg, prefix=f"{pre}/attn", stack=stack))
    defs.update(mlp_defs(cfg, prefix=f"{pre}/mlp", stack=stack))
    return defs


def lm_param_defs(cfg: ModelConfig) -> ParamDefs:
    check_dense(cfg)
    period, _ = cfg.layer_groups()
    n_periods = cfg.n_layers // period
    defs = dict(embed_defs(cfg))
    defs["final_norm"] = ParamDef((cfg.d_model,), cfg.pdtype, (None,),
                                  scale=-1.0)
    for pos in range(period):
        defs.update(_block_defs(cfg, pos, n_periods))
    return defs


def _layer_params(params: Mapping[str, torch.Tensor], period: int,
                  i: int) -> Dict[str, torch.Tensor]:
    """Layer i's params, unstacked: the `blk{pos}/` paths of its place in
    the period (`ModelConfig.layer_groups()`), at its period's index, with
    the prefix dropped."""
    r, pos = divmod(i, period)
    pre = f"blk{pos}/"
    return {k[len(pre):]: v[r] for k, v in params.items()
            if k.startswith(pre)}


def _block_apply(cfg: ModelConfig, p_blk, x, use_rope: bool, tables=None):
    """One pre-norm (attn, dense) block over the whole sequence."""
    h = rms_norm(x, p_blk["norm1"], cfg.norm_eps)
    x = x + attention(cfg, p_blk, h, prefix="attn", causal=True,
                      rope=use_rope, tables=tables)
    h = rms_norm(x, p_blk["norm2"], cfg.norm_eps)
    return x + mlp_apply(cfg, p_blk, h, prefix="mlp")


def lm_backbone(cfg: ModelConfig, params: Mapping[str, torch.Tensor],
                x: torch.Tensor, use_rope: bool = True) -> torch.Tensor:
    """Run all blocks in order. x: (B, S, D) -> h (B, S, D)."""
    tables = (self_tables(cfg, torch.arange(x.shape[1], device=x.device)
                          [None, :]) if use_rope else None)
    period, _ = cfg.layer_groups()
    for i in range(cfg.n_layers):
        x = _block_apply(cfg, _layer_params(params, period, i), x, use_rope,
                         tables)
    return x


def lm_prefill(cfg: ModelConfig, params, tokens: torch.Tensor,
               use_rope: bool = True) -> torch.Tensor:
    """One forward over the whole prompt: the last position's logits
    (B, padded_vocab).  Fills no cache; decode writes its own."""
    x = embed_tokens(cfg, params, tokens)
    h = lm_backbone(cfg, params, x, use_rope)
    h = rms_norm(h[:, -1, :], params["final_norm"], cfg.norm_eps)
    return logits_last(cfg, params, h)


def lm_cache_shapes(cfg: ModelConfig, batch: int, seq_len: int):
    """One {k, v} entry per layer, unstacked, as the reference's."""
    check_dense(cfg)
    return tuple(init_cache_shapes(cfg, batch, seq_len)
                 for _ in range(cfg.n_layers))


def lm_decode_step(cfg: ModelConfig, params, caches, tokens: torch.Tensor,
                   pos: int, use_rope: bool = True
                   ) -> Tuple[torch.Tensor, Tuple]:
    """One decode step.  tokens: (B, 1) integer; caches as
    `lm_cache_shapes`, each layer's written at `pos` in place.  Returns
    (logits (B, padded_vocab), caches)."""
    x = embed_tokens(cfg, params, tokens)
    tables = (self_tables(cfg, torch.full((x.shape[0], 1), int(pos),
                                          dtype=torch.int32, device=x.device))
              if use_rope else None)
    period, _ = cfg.layer_groups()
    for i in range(cfg.n_layers):
        p_blk = _layer_params(params, period, i)
        h = rms_norm(x, p_blk["norm1"], cfg.norm_eps)
        h, _ = decode_attention(cfg, p_blk, h, caches[i], pos, prefix="attn",
                                rope=use_rope, tables=tables)
        x = x + h
        h = rms_norm(x, p_blk["norm2"], cfg.norm_eps)
        x = x + mlp_apply(cfg, p_blk, h, prefix="mlp")
    h = rms_norm(x[:, 0, :], params["final_norm"], cfg.norm_eps)
    return logits_last(cfg, params, h), tuple(caches)
