"""Decoder-only LM assembly: pre-norm blocks of every (mixer, mlp) kind,
run as a loop over periods; port of `repro.models.transformer`.

The parameters keep the reference's stacked layout: `blk{pos}/...` paths
with a leading axis over the periods of `ModelConfig.layer_groups()` (a
uniform model has period 1, so the axis runs over the layers; jamba's
attn:mamba 1:7 interleave with MoE every other layer has period 8).  A
block's mixer is attention or mamba, its MLP dense, MoE or none.  With
`cfg.remat == "full"` each period is recomputed in the backward, as the
reference's `jax.checkpoint` of its period body.  The reference's
`sharding.constrain` sites are kept; with no mesh context they return
their argument.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from .. import sharding
from . import moe as moe_mod
from .attention import (attention, attn_defs, cache_pspec, decode_attention,
                        init_cache_shapes, self_tables)
from .config import ModelConfig
from .layers import (ParamDef, ParamDefs, chunked_xent, embed_defs,
                     embed_tokens, logits_last, mlp_apply, mlp_defs, remat,
                     rms_norm)
from .mamba import (init_mamba_cache_shapes, mamba_apply, mamba_cache_pspec,
                    mamba_decode_step, mamba_defs)


def _block_defs(cfg: ModelConfig, pos: int, kind: Tuple[str, str],
                n_periods: int) -> ParamDefs:
    mixer, mlp = kind
    stack = (n_periods,)
    pre = f"blk{pos}"
    defs: ParamDefs = {
        f"{pre}/norm1": ParamDef(stack + (cfg.d_model,), cfg.pdtype,
                                 ("layers", None), scale=-1.0),
    }
    if mlp != "none":
        defs[f"{pre}/norm2"] = ParamDef(stack + (cfg.d_model,), cfg.pdtype,
                                        ("layers", None), scale=-1.0)
    if mixer == "attn":
        defs.update(attn_defs(cfg, prefix=f"{pre}/attn", stack=stack))
    else:
        defs.update(mamba_defs(cfg, prefix=f"{pre}/mamba", stack=stack))
    if mlp == "moe":
        defs.update(moe_mod.moe_defs(cfg, prefix=f"{pre}/moe", stack=stack))
    elif mlp == "dense":
        defs.update(mlp_defs(cfg, prefix=f"{pre}/mlp", stack=stack))
    return defs


def lm_param_defs(cfg: ModelConfig) -> ParamDefs:
    period, kinds = cfg.layer_groups()
    n_periods = cfg.n_layers // period
    defs = dict(embed_defs(cfg))
    defs["final_norm"] = ParamDef((cfg.d_model,), cfg.pdtype, (None,),
                                  scale=-1.0)
    if cfg.frontend:
        # modality stub: projection from precomputed frontend embeddings
        defs["frontend/proj"] = ParamDef((cfg.d_model, cfg.d_model),
                                         cfg.pdtype, ("fsdp", "embed"))
    for pos, kind in enumerate(kinds):
        defs.update(_block_defs(cfg, pos, kind, n_periods))
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


def _block_apply(cfg: ModelConfig, kind: Tuple[str, str], p_blk, x,
                 moe_impl: str, use_rope: bool, tables=None):
    """One pre-norm block over the whole sequence -> (x, its MoE aux)."""
    mixer, mlp = kind
    h = rms_norm(x, p_blk["norm1"], cfg.norm_eps)
    if mixer == "attn":
        h = attention(cfg, p_blk, h, prefix="attn", causal=True,
                      rope=use_rope, tables=tables)
    else:
        h = mamba_apply(cfg, p_blk, h, prefix="mamba")
    x = sharding.constrain(x + h, "batch", "seq", None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mlp == "none":
        return x, aux
    h = rms_norm(x, p_blk["norm2"], cfg.norm_eps)
    if mlp == "moe":
        h, aux = moe_mod.moe_apply(cfg, p_blk, h, prefix="moe", impl=moe_impl)
    else:
        h = mlp_apply(cfg, p_blk, h, prefix="mlp")
    return sharding.constrain(x + h, "batch", "seq", None), aux


def lm_backbone(cfg: ModelConfig, params: Mapping[str, torch.Tensor],
                x: torch.Tensor, moe_impl: str = "einsum",
                use_rope: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run all blocks, period by period. x: (B,S,D) -> (h, moe_aux)."""
    period, kinds = cfg.layer_groups()
    tables = (self_tables(cfg, torch.arange(x.shape[1], device=x.device)
                          [None, :]) if use_rope else None)

    def period_body(x, r):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for pos, kind in enumerate(kinds):
            x, a = _block_apply(cfg, kind,
                                _layer_params(params, period,
                                              r * period + pos),
                                x, moe_impl, use_rope, tables)
            aux = aux + a
        return x, aux

    auxs = []
    for r in range(cfg.n_layers // period):
        x, a = (remat(period_body, x, r) if cfg.remat == "full"
                else period_body(x, r))
        auxs.append(a)
    return x, torch.stack(auxs).sum()


def _merge_frontend(cfg: ModelConfig, params, x_tok, frontend_embeds):
    """VLM stub: project precomputed patch embeddings and prepend them."""
    cd = cfg.cdtype
    fe = frontend_embeds.to(cd) @ params["frontend/proj"].to(cd)
    return torch.cat([fe, x_tok], dim=1)


def lm_loss(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            moe_impl: str = "einsum", use_rope: bool = True) -> torch.Tensor:
    """Next-token loss.  batch: tokens (B,S) integer, labels (B,S) integer
    (-1 = pad); optional patches (B,P,D) for VLM stubs, whose positions
    carry label -1.  Includes 0.01 × the blocks' MoE aux loss."""
    x = embed_tokens(cfg, params, batch["tokens"])
    labels = batch["labels"]
    if cfg.frontend == "patches" and "patches" in batch:
        x = _merge_frontend(cfg, params, x, batch["patches"])
        pad_lab = torch.full(batch["patches"].shape[:2], -1,
                             dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad_lab, labels], dim=1)
    h, moe_aux = lm_backbone(cfg, params, x, moe_impl, use_rope)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return chunked_xent(cfg, params, h, labels) + 0.01 * moe_aux


# ---------------------------------------------------------------------------
# serving: prefill + decode with per-layer caches
# ---------------------------------------------------------------------------
def lm_prefill(cfg: ModelConfig, params, tokens: torch.Tensor,
               moe_impl: str = "einsum", use_rope: bool = True,
               patches=None) -> torch.Tensor:
    """One forward over the whole prompt (patch stand-ins first, when
    given): the last position's logits (B, padded_vocab).  Fills no cache;
    decode writes its own."""
    x = embed_tokens(cfg, params, tokens)
    if patches is not None:
        x = _merge_frontend(cfg, params, x, patches)
    h, _ = lm_backbone(cfg, params, x, moe_impl, use_rope)
    h = rms_norm(h[:, -1, :], params["final_norm"], cfg.norm_eps)
    return logits_last(cfg, params, h)


def lm_cache_shapes(cfg: ModelConfig, batch: int, seq_len: int):
    """One entry per layer, unstacked, as the reference's: {k, v} for an
    attention layer, {conv_x, conv_B, conv_C, ssm} for a mamba layer."""
    return tuple(init_cache_shapes(cfg, batch, seq_len)
                 if cfg.layer_kind(i)[0] == "attn"
                 else init_mamba_cache_shapes(cfg, batch)
                 for i in range(cfg.n_layers))


def lm_cache_pspecs(cfg: ModelConfig):
    """Specs of `lm_cache_shapes`'s tree under the active mesh rules."""
    return tuple(cache_pspec() if cfg.layer_kind(i)[0] == "attn"
                 else mamba_cache_pspec() for i in range(cfg.n_layers))


def lm_decode_step(cfg: ModelConfig, params, caches, tokens: torch.Tensor,
                   pos: int, moe_impl: str = "einsum", use_rope: bool = True
                   ) -> Tuple[torch.Tensor, Tuple]:
    """One decode step.  tokens: (B, 1) integer; caches as
    `lm_cache_shapes`, each layer's written in place (attention at `pos`).
    Returns (logits (B, padded_vocab), caches)."""
    x = embed_tokens(cfg, params, tokens)
    tables = (self_tables(cfg, torch.full((x.shape[0], 1), int(pos),
                                          dtype=torch.int32, device=x.device))
              if use_rope else None)
    period, kinds = cfg.layer_groups()
    for i in range(cfg.n_layers):
        mixer, mlp = kinds[i % period]
        p_blk = _layer_params(params, period, i)
        h = rms_norm(x, p_blk["norm1"], cfg.norm_eps)
        if mixer == "attn":
            h, _ = decode_attention(cfg, p_blk, h, caches[i], pos,
                                    prefix="attn", rope=use_rope,
                                    tables=tables)
        else:
            h, _ = mamba_decode_step(cfg, p_blk, h, caches[i],
                                     prefix="mamba")
        x = x + h
        if mlp != "none":
            h = rms_norm(x, p_blk["norm2"], cfg.norm_eps)
            if mlp == "moe":
                h, _ = moe_mod.moe_apply(cfg, p_blk, h, prefix="moe",
                                         impl=moe_impl)
            else:
                h = mlp_apply(cfg, p_blk, h, prefix="mlp")
            x = x + h
    h = rms_norm(x[:, 0, :], params["final_norm"], cfg.norm_eps)
    return logits_last(cfg, params, h), tuple(caches)
