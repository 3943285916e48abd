"""Encoder-decoder backbone (seamless-m4t): audio-frontend stub -> encoder,
token decoder with cross-attention; port of `repro.models.encdec` (its
`sharding.constrain` sites kept).  The modality frontend is a stub: the caller supplies precomputed
frame embeddings (B, S_src, d_model).

Serving keeps the reference's cross caches as they are: its engine never
fills them, so they stay zero at `src_len` (4,096 by default) and decode
attends to them at position src_len - 1.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from .. import sharding
from .attention import (attention, attn_defs, cache_pspec, decode_attention,
                        init_cache_shapes, self_tables)
from .config import ModelConfig
from .layers import (ParamDef, ParamDefs, ShapeDtype, chunked_xent,
                     embed_defs, embed_tokens, logits_last, mlp_apply,
                     mlp_defs, remat, rms_norm)


def encdec_param_defs(cfg: ModelConfig) -> ParamDefs:
    Le, Ld = cfg.n_enc_layers, cfg.n_layers
    defs = dict(embed_defs(cfg))
    defs["frontend/proj"] = ParamDef((cfg.d_model, cfg.d_model), cfg.pdtype,
                                     ("fsdp", "embed"))
    defs["enc_final_norm"] = ParamDef((cfg.d_model,), cfg.pdtype, (None,),
                                      scale=-1.0)
    defs["final_norm"] = ParamDef((cfg.d_model,), cfg.pdtype, (None,),
                                  scale=-1.0)

    def norm(L):
        return ParamDef((L, cfg.d_model), cfg.pdtype, ("layers", None),
                        scale=-1.0)
    defs.update({"enc/norm1": norm(Le), "enc/norm2": norm(Le),
                 **attn_defs(cfg, prefix="enc/attn", stack=(Le,)),
                 **mlp_defs(cfg, prefix="enc/mlp", stack=(Le,))})
    defs.update({"dec/norm1": norm(Ld), "dec/norm2": norm(Ld),
                 "dec/norm3": norm(Ld),
                 **attn_defs(cfg, prefix="dec/self", stack=(Ld,)),
                 **attn_defs(cfg, prefix="dec/cross", stack=(Ld,),
                             cross=True),
                 **mlp_defs(cfg, prefix="dec/mlp", stack=(Ld,))})
    return defs


def _layer(params: Mapping[str, torch.Tensor], pre: str, i: int
           ) -> Dict[str, torch.Tensor]:
    """Layer i of the stacked `pre` paths ("enc/" or "dec/"), prefix
    dropped."""
    return {k[len(pre):]: v[i] for k, v in params.items()
            if k.startswith(pre)}


def _tables(cfg: ModelConfig, S: int, device):
    return self_tables(cfg, torch.arange(S, device=device)[None, :])


def encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_src, D) stub embeddings -> encoder states."""
    cd = cfg.cdtype
    x = sharding.constrain(frames.to(cd) @ params["frontend/proj"].to(cd),
                           "batch", "seq", None)
    tables = _tables(cfg, x.shape[1], x.device)

    def body(x, i):
        p = _layer(params, "enc/", i)
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + attention(cfg, p, h, prefix="attn", causal=False,
                          tables=tables)
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        return sharding.constrain(x + mlp_apply(cfg, p, h, prefix="mlp"),
                                  "batch", "seq", None)

    for i in range(cfg.n_enc_layers):
        x = remat(body, x, i) if cfg.remat == "full" else body(x, i)
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def decode_train(cfg: ModelConfig, params, tokens: torch.Tensor,
                 memory: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder pass -> hidden states (B, S_tgt, D)."""
    x = embed_tokens(cfg, params, tokens)
    tables = _tables(cfg, x.shape[1], x.device)

    def body(x, i):
        p = _layer(params, "dec/", i)
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + attention(cfg, p, h, prefix="self", causal=True,
                          tables=tables)
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        x = x + attention(cfg, p, h, prefix="cross", kv_x=memory,
                          causal=False)
        h = rms_norm(x, p["norm3"], cfg.norm_eps)
        return sharding.constrain(x + mlp_apply(cfg, p, h, prefix="mlp"),
                                  "batch", "seq", None)

    for i in range(cfg.n_layers):
        x = remat(body, x, i) if cfg.remat == "full" else body(x, i)
    return x


def encdec_loss(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    memory = encode(cfg, params, batch["frames"])
    h = decode_train(cfg, params, batch["tokens"], memory)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return chunked_xent(cfg, params, h, batch["labels"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def encdec_cache_shapes(cfg: ModelConfig, batch: int, seq_len: int,
                        src_len: int):
    """Per-layer self caches and fixed cross K/V, as the reference's."""
    cross = (batch, src_len, cfg.n_kv, cfg.head_dim)
    return {
        "self": tuple(init_cache_shapes(cfg, batch, seq_len)
                      for _ in range(cfg.n_layers)),
        "cross": tuple({"k": ShapeDtype(cross, cfg.cdtype),
                        "v": ShapeDtype(cross, cfg.cdtype)}
                       for _ in range(cfg.n_layers)),
    }


def encdec_cache_pspecs(cfg: ModelConfig):
    """Specs of `encdec_cache_shapes`'s tree under the active mesh rules:
    self caches as a decoder's, cross K/V sharded over the source frames."""
    cross = sharding.spec_for(("cache_batch", "frames", "kv_heads", None))
    return {"self": tuple(cache_pspec() for _ in range(cfg.n_layers)),
            "cross": tuple({"k": cross, "v": cross}
                           for _ in range(cfg.n_layers))}


def encdec_decode_step(cfg: ModelConfig, params, caches, tokens: torch.Tensor,
                       pos: int):
    """One decoder token against its self cache (written at `pos` in
    place) and the fixed cross K/V, read at src_len - 1 with no rope."""
    x = embed_tokens(cfg, params, tokens)
    tables = self_tables(cfg, torch.full((x.shape[0], 1), int(pos),
                                         dtype=torch.int32, device=x.device))
    for i in range(cfg.n_layers):
        p = _layer(params, "dec/", i)
        self_c, cross_c = caches["self"][i], caches["cross"][i]
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        h, _ = decode_attention(cfg, p, h, self_c, pos, prefix="self",
                                tables=tables)
        x = x + h
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        h, _ = decode_attention(cfg, p, h, cross_c, cross_c["k"].shape[1] - 1,
                                prefix="cross", update_cache=False,
                                rope=False)
        x = x + h
        h = rms_norm(x, p["norm3"], cfg.norm_eps)
        x = x + mlp_apply(cfg, p, h, prefix="mlp")
    h = rms_norm(x[:, 0, :], params["final_norm"], cfg.norm_eps)
    return logits_last(cfg, params, h), caches
