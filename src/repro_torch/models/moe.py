"""Mixture-of-Experts layer; port of `repro.models.moe` (its
`sharding.constrain` sites kept: with no mesh they return their argument).

Two dispatch implementations with the same router and the same
capacity/drop policy (tested equal):

  * "einsum" — one-hot dispatch/combine over token groups of
    `cfg.moe_group`, the reference's baseline.
  * "gather" — index dispatch: each kept (token, slot) is written by index
    into an (E·C + 1, d) buffer whose last row takes every dropped slot,
    and read back by index.  An index write, not an add, so the result
    does not depend on the order of the writes.

Capacity: C = ceil(g · top_k · cf / E) per group of g = min(moe_group, T)
tokens; (token, slot) pairs past an expert's capacity are dropped
(contribute 0) in both.  Ranks within an expert are counted slot-major:
every slot-0 pick of a group comes before any slot-1 pick.  At decode T is
the batch, so a decoded token's drops depend on its batch mates, as in the
reference.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from .. import sharding
from .config import ModelConfig
from .layers import ParamDef, ParamDefs, _act


def moe_defs(cfg: ModelConfig, prefix: str = "moe",
             stack: Tuple[int, ...] = ()) -> ParamDefs:
    E, D, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
    L = ("layers",) * len(stack)
    defs = {
        f"{prefix}/router": ParamDef(stack + (D, E), torch.float32,
                                     L + ("fsdp", None)),
        f"{prefix}/wg": ParamDef(stack + (E, D, F_), cfg.pdtype,
                                 L + ("experts", "expert_fsdp", None)),
        f"{prefix}/wu": ParamDef(stack + (E, D, F_), cfg.pdtype,
                                 L + ("experts", "expert_fsdp", None)),
        f"{prefix}/wo": ParamDef(stack + (E, F_, D), cfg.pdtype,
                                 L + ("experts", None, "expert_fsdp")),
    }
    for s in range(cfg.n_shared_experts):
        defs.update({
            f"{prefix}/shared{s}/wg": ParamDef(stack + (D, F_), cfg.pdtype,
                                               L + ("fsdp", "ff")),
            f"{prefix}/shared{s}/wu": ParamDef(stack + (D, F_), cfg.pdtype,
                                               L + ("fsdp", "ff")),
            f"{prefix}/shared{s}/wo": ParamDef(stack + (F_, D), cfg.pdtype,
                                               L + ("ff", "fsdp")),
        })
    return defs


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, in
    `lax.top_k`'s order: descending, and on an exact tie the lower index
    first (a stable descending sort; `torch.topk` promises no order among
    ties)."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(probs, -1, idx), idx


def _route(cfg: ModelConfig, p, prefix, xf: torch.Tensor):
    """xf: (..., d) -> (gates (...,k), experts (...,k), probs (...,E))."""
    logits = xf.float() @ p[f"{prefix}/router"]
    probs = torch.softmax(logits, dim=-1)
    gates, experts = top_k(probs, cfg.top_k)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return gates, experts, probs


def _expert_ranks(cfg: ModelConfig, experts: torch.Tensor):
    """experts: (..., T, k) -> (one-hot (..., T, k, E) int32, the rank of
    each (token, slot) within its expert (..., T, k)), counted slot-major
    (all slot-0 assignments first, mirroring Mesh-TF)."""
    E, k = cfg.n_experts, cfg.top_k
    *lead, T, _ = experts.shape
    onehot = F.one_hot(experts.long(), E).to(torch.int32)        # (...,T,k,E)
    flat = onehot.transpose(-3, -2).reshape(*lead, k * T, E)
    ranks = torch.cumsum(flat, dim=-2, dtype=torch.int32) - flat
    rank_tok = (ranks.reshape(*lead, k, T, E).transpose(-3, -2)
                * onehot).sum(-1)                                # (...,T,k)
    return onehot, rank_tok


def _expert_ffn(cfg: ModelConfig, p, prefix, xin: torch.Tensor
                ) -> torch.Tensor:
    """xin: (G, E, C, d) -> (G, E, C, d): each expert's gated MLP on its
    G·C rows, one batched product an expert weight.  Under a mesh the
    groups keep the batch sharding and the experts are sharded over
    "model", so the (…, F) hidden is sharded on both."""
    G, E, C, D = xin.shape
    xin = sharding.constrain(xin, "batch", "experts", None, None)
    x = xin.transpose(0, 1).reshape(E, G * C, D)
    g = _act(cfg, torch.bmm(x, p[f"{prefix}/wg"].to(cfg.cdtype)))
    u = torch.bmm(x, p[f"{prefix}/wu"].to(cfg.cdtype))
    h = sharding.constrain(g * u, "experts", "batch", None)
    out = torch.bmm(h, p[f"{prefix}/wo"].to(cfg.cdtype))
    return out.reshape(E, G, C, D).transpose(0, 1)


def _groups(cfg: ModelConfig, x: torch.Tensor):
    """(G, g, C) of x (B, S, d): groups of g = min(moe_group, T) tokens and
    each expert's capacity in a group."""
    T = x.shape[0] * x.shape[1]
    g = min(cfg.moe_group, T)
    if T % g:
        raise ValueError(f"MoE: {T} tokens do not split into groups of {g}")
    C = max(1, int(-(-g * cfg.top_k * cfg.moe_capacity_factor
                     // cfg.n_experts)))
    return T // g, g, C


def moe_einsum(cfg: ModelConfig, p, x: torch.Tensor, prefix: str = "moe"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Baseline grouped one-hot dispatch.  x: (B,S,d) -> ((B,S,d), aux)."""
    B, S, D = x.shape
    G, g, C = _groups(cfg, x)
    E = cfg.n_experts
    xf = x.reshape(G, g, D)
    gates, experts, probs = _route(cfg, p, prefix, xf)
    onehot, rank = _expert_ranks(cfg, experts)                   # (G,g,k,E)
    keep = rank < C
    poh = F.one_hot(rank.clamp(0, C - 1).long(), C).float()      # (G,g,k,C)
    d = ((onehot * keep[..., None]).float()[..., None]
         * poh[:, :, :, None, :])                                # (G,g,k,E,C)
    dispatch = d.sum(2)
    combine = (d * gates[..., None, None]).sum(2)                # (G,g,E,C)
    xin = torch.einsum("gsec,gsd->gecd", dispatch.to(cfg.cdtype), xf)
    out = _expert_ffn(cfg, p, prefix, xin)                       # (G,E,C,d)
    y = torch.einsum("gecd,gsec->gsd", out, combine.to(cfg.cdtype))
    aux = _load_balance_loss(cfg, probs.reshape(-1, E),
                             experts.reshape(-1, cfg.top_k))
    return _with_shared(cfg, p, prefix, x, y.reshape(B, S, D)), aux


def moe_gather(cfg: ModelConfig, p, x: torch.Tensor, prefix: str = "moe"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index dispatch — the same routing decisions, no one-hot products."""
    B, S, D = x.shape
    G, g, C = _groups(cfg, x)
    E, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(G, g, D)
    gates, experts, probs = _route(cfg, p, prefix, xf)
    _, rank = _expert_ranks(cfg, experts)
    keep = rank < C
    slot = torch.where(keep, experts.long() * C + rank,
                       E * C).reshape(G, g * k)
    grp = torch.arange(G, device=x.device)[:, None].expand(G, g * k)
    src = xf[:, :, None, :].expand(G, g, k, D).reshape(G, g * k, D)
    buf = xf.new_zeros((G, E * C + 1, D), dtype=cfg.cdtype)
    buf = buf.index_put((grp, slot), src.to(cfg.cdtype))
    xin = buf[:, :E * C].reshape(G, E, C, D)
    out = _expert_ffn(cfg, p, prefix, xin).reshape(G, E * C, D)
    outp = torch.cat([out, out.new_zeros((G, 1, D))], dim=1)
    picked = outp[grp, slot].reshape(G, g, k, D)
    y = (picked * (gates * keep).to(cfg.cdtype)[..., None]).sum(2)
    aux = _load_balance_loss(cfg, probs.reshape(-1, E),
                             experts.reshape(-1, k))
    return _with_shared(cfg, p, prefix, x, y.reshape(B, S, D)), aux


def _with_shared(cfg: ModelConfig, p, prefix, x, y):
    """y plus the always-on shared experts' output on x."""
    for s in range(cfg.n_shared_experts):
        gg = _act(cfg, x @ p[f"{prefix}/shared{s}/wg"].to(cfg.cdtype))
        u = x @ p[f"{prefix}/shared{s}/wu"].to(cfg.cdtype)
        h = sharding.constrain(gg * u, "batch", None, "ff")
        y = y + h @ p[f"{prefix}/shared{s}/wo"].to(cfg.cdtype)
    return y


def _load_balance_loss(cfg: ModelConfig, probs, experts) -> torch.Tensor:
    """Switch-style aux loss: E · Σ_e f_e · p̄_e."""
    E = cfg.n_experts
    hits = F.one_hot(experts.long(), E).float().sum(1)          # (T,E)
    f = hits.mean(0) / cfg.top_k
    return E * (f * probs.mean(0)).sum()


def moe_apply(cfg: ModelConfig, p: Mapping[str, torch.Tensor],
              x: torch.Tensor, prefix: str = "moe", impl: str = "einsum"):
    fn = moe_einsum if impl == "einsum" else moe_gather
    return fn(cfg, p, x, prefix)
