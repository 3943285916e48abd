"""Mamba2 (SSD — state-space duality, Dao & Gu 2024); port of
`repro.models.mamba` (its `sharding.constrain` sites kept: with no mesh
they return their argument).

Train/prefill runs the chunked SSD form: within a chunk of length Q a
decay-masked quadratic "attention", across chunks a recurrent state
h ∈ (B, nh, hp, N) carried by a loop over chunks (the reference's
`lax.scan`), which hands each chunk the state from *before* it.  Decode is
the O(1) single-step recurrence

    h_t = exp(Δt·a) ⊙ h_{t-1} + Δt · x_t ⊗ B_t,     y_t = C_t · h_t + D·x_t,

writing the layer's cache in place.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from .. import sharding
from .config import ModelConfig
from .layers import ParamDef, ParamDefs, ShapeDtype, rms_norm


def dims(cfg: ModelConfig):
    di = cfg.ssm_expand * cfg.d_model
    nh = di // cfg.ssm_head_dim
    return di, nh, cfg.ssm_state


def mamba_defs(cfg: ModelConfig, prefix: str = "mamba",
               stack: Tuple[int, ...] = ()) -> ParamDefs:
    D = cfg.d_model
    di, nh, N = dims(cfg)
    K = cfg.ssm_conv
    L = ("layers",) * len(stack)
    f32 = torch.float32
    return {
        f"{prefix}/wz": ParamDef(stack + (D, di), cfg.pdtype, L + ("fsdp", "ff")),
        f"{prefix}/wx": ParamDef(stack + (D, di), cfg.pdtype, L + ("fsdp", "ff")),
        f"{prefix}/wB": ParamDef(stack + (D, N), cfg.pdtype, L + ("fsdp", None)),
        f"{prefix}/wC": ParamDef(stack + (D, N), cfg.pdtype, L + ("fsdp", None)),
        f"{prefix}/wdt": ParamDef(stack + (D, nh), cfg.pdtype, L + ("fsdp", None)),
        f"{prefix}/conv_x": ParamDef(stack + (K, di), cfg.pdtype,
                                     L + (None, "ff"), scale=-1.0),
        f"{prefix}/conv_B": ParamDef(stack + (K, N), cfg.pdtype,
                                     L + (None, None), scale=-1.0),
        f"{prefix}/conv_C": ParamDef(stack + (K, N), cfg.pdtype,
                                     L + (None, None), scale=-1.0),
        f"{prefix}/dt_bias": ParamDef(stack + (nh,), f32, L + (None,),
                                      scale=0.0),
        f"{prefix}/A_log": ParamDef(stack + (nh,), f32, L + (None,),
                                    scale=0.0),
        f"{prefix}/Dskip": ParamDef(stack + (nh,), f32, L + (None,),
                                    scale=-1.0),
        f"{prefix}/norm": ParamDef(stack + (di,), cfg.pdtype,
                                   L + ("ff",), scale=-1.0),
        f"{prefix}/wo": ParamDef(stack + (di, D), cfg.pdtype, L + ("ff", "fsdp")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via K shifted adds, in the reference's order.
    x: (B,S,C), w: (K,C)."""
    K = w.shape[0]
    y = x * w[-1]
    for k in range(1, K):
        shifted = F.pad(x, (0, 0, k, 0))[:, :-k, :]
        y = y + shifted * w[K - 1 - k]
    return y


def _project(cfg, p, prefix, x):
    cd = cfg.cdtype
    return tuple(x @ p[f"{prefix}/{w}"].to(cd)
                 for w in ("wz", "wx", "wB", "wC", "wdt"))


def mamba_apply(cfg: ModelConfig, p: Mapping[str, torch.Tensor],
                x: torch.Tensor, prefix: str = "mamba") -> torch.Tensor:
    """Chunked SSD forward (train/prefill).  x: (B,S,D) -> (B,S,D)."""
    B, S, D = x.shape
    di, nh, N = dims(cfg)
    hp = cfg.ssm_head_dim
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"mamba: sequence {S} is not a multiple of the "
                         f"chunk {Q}")
    nc = S // Q
    cd, f32 = cfg.cdtype, torch.float32

    z, xs, Bm, Cm, dt = _project(cfg, p, prefix, x)
    # inside the mixer the model axis holds d_inner channels (z/x) and
    # the heads (dt, and the chunk tensors it drives), never the sequence
    z = sharding.constrain(z, "batch", None, "ff")
    xs = sharding.constrain(xs, "batch", None, "ff")
    dt = sharding.constrain(dt, "batch", None, "ssm_heads")
    xs = F.silu(_causal_conv(xs, p[f"{prefix}/conv_x"].to(cd)))
    Bm = F.silu(_causal_conv(Bm, p[f"{prefix}/conv_B"].to(cd)))
    Cm = F.silu(_causal_conv(Cm, p[f"{prefix}/conv_C"].to(cd)))
    dt = F.softplus(dt.float() + p[f"{prefix}/dt_bias"])         # (B,S,nh)
    a = -torch.exp(p[f"{prefix}/A_log"])                          # (nh,)
    da = dt * a                                                   # <= 0

    xh = sharding.constrain(xs.reshape(B, S, nh, hp),
                            "batch", None, "ssm_heads", None)
    cum = torch.cumsum(da.reshape(B, nc, Q, nh), dim=2)          # (B,nc,Q,nh)
    seg_end = cum[:, :, -1, :]                                   # (B,nc,nh)
    xc = xh.reshape(B, nc, Q, nh, hp)
    dtc = dt.reshape(B, nc, Q, nh)
    Bc = Bm.reshape(B, nc, Q, N)
    Cc = Cm.reshape(B, nc, Q, N)

    # ---- intra-chunk (quadratic within chunk, decay-masked) ----
    # L[i,j] = exp(cum_i - cum_j) for i >= j, else 0.  The exponent is
    # masked BEFORE exp: the upper triangle's positive differences would
    # overflow, and the gradient through a `where` after the exp is NaN.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,Q,Q,nh)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    diff = torch.where(causal[None, None, :, :, None], diff, -1e30)
    Lmask = torch.exp(diff).to(cd)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    att = cb[..., None] * Lmask * dtc.to(cd)[:, :, None, :, :]
    # the reference's products accumulate in float32
    # (preferred_element_type); the operands' float32 products are exact
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att.to(f32), xc.to(f32))

    # ---- chunk states + inter-chunk recurrence ----
    decay_out = torch.exp(seg_end[:, :, None, :] - cum)          # (B,nc,Q,nh)
    state_c = torch.einsum("bcjhp,bcjn->bchpn",
                           (dtc * decay_out)[..., None] * xc.to(f32),
                           Bc.to(f32))                       # (B,nc,nh,hp,N)
    h = torch.zeros((B, nh, hp, N), dtype=f32, device=x.device)
    h_before = []
    for c in range(nc):
        h_before.append(h)                  # the state before chunk c
        h = h * torch.exp(seg_end[:, c])[:, :, None, None] + state_c[:, c]
    h_before = torch.stack(h_before, dim=1)                  # (B,nc,nh,hp,N)

    y_inter = (torch.einsum("bcin,bchpn->bcihp", Cc.to(f32), h_before)
               * torch.exp(cum)[..., None])
    y = (y_intra + y_inter).reshape(B, S, nh, hp)
    y = y + p[f"{prefix}/Dskip"][None, None, :, None] * xh.to(f32)
    y = y.reshape(B, S, di).to(cd)

    y = y * F.silu(z)
    y = rms_norm(y, p[f"{prefix}/norm"], cfg.norm_eps)
    return y @ p[f"{prefix}/wo"].to(cd)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_mamba_cache_shapes(cfg: ModelConfig, batch: int, dtype=None
                            ) -> Dict[str, ShapeDtype]:
    di, nh, N = dims(cfg)
    dt = dtype or cfg.cdtype
    K = cfg.ssm_conv
    return {
        "conv_x": ShapeDtype((batch, K - 1, di), dt),
        "conv_B": ShapeDtype((batch, K - 1, N), dt),
        "conv_C": ShapeDtype((batch, K - 1, N), dt),
        "ssm": ShapeDtype((batch, nh, cfg.ssm_head_dim, N), torch.float32),
    }


def mamba_cache_pspec():
    """Specs of a layer's mamba cache under the active mesh rules."""
    return {
        "conv_x": sharding.spec_for(("cache_batch", None, "ff")),
        "conv_B": sharding.spec_for(("cache_batch", None, None)),
        "conv_C": sharding.spec_for(("cache_batch", None, None)),
        "ssm": sharding.spec_for(("cache_batch", "ssm_heads", None, None)),
    }


def _conv_step(x_t, state, w):
    """x_t: (B,C); state: (B,K-1,C); w: (K,C) -> (y_t, new_state)."""
    full = torch.cat([state, x_t[:, None, :]], dim=1)             # (B,K,C)
    y = torch.einsum("bkc,kc->bc", full, w)
    return y, full[:, 1:, :]


def mamba_decode_step(cfg: ModelConfig, p: Mapping[str, torch.Tensor],
                      x: torch.Tensor, cache: Dict[str, torch.Tensor],
                      prefix: str = "mamba"):
    """x: (B,1,D) -> (y (B,1,D), cache), the cache's four tensors
    overwritten in place with the new state."""
    B = x.shape[0]
    di, nh, N = dims(cfg)
    hp = cfg.ssm_head_dim
    cd, f32 = cfg.cdtype, torch.float32
    z, xs, Bm, Cm, dt = _project(cfg, p, prefix, x[:, 0, :])
    xs, cx = _conv_step(xs, cache["conv_x"].to(cd),
                        p[f"{prefix}/conv_x"].to(cd))
    Bm, cB = _conv_step(Bm, cache["conv_B"].to(cd),
                        p[f"{prefix}/conv_B"].to(cd))
    Cm, cC = _conv_step(Cm, cache["conv_C"].to(cd),
                        p[f"{prefix}/conv_C"].to(cd))
    xs, Bm, Cm = F.silu(xs), F.silu(Bm), F.silu(Cm)
    dt = F.softplus(dt.float() + p[f"{prefix}/dt_bias"])
    a = -torch.exp(p[f"{prefix}/A_log"])
    da = torch.exp(dt * a)                                        # (B,nh)

    xh = xs.reshape(B, nh, hp).to(f32)
    h = cache["ssm"] * da[:, :, None, None] + (
        (dt[:, :, None] * xh)[..., None] * Bm.to(f32)[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", Cm.to(f32), h)
    y = y + p[f"{prefix}/Dskip"][None, :, None] * xh
    y = y.reshape(B, 1, di).to(cd)
    y = y * F.silu(z)[:, None, :]
    y = rms_norm(y, p[f"{prefix}/norm"], cfg.norm_eps)
    out = y @ p[f"{prefix}/wo"].to(cd)
    for name, new in (("conv_x", cx), ("conv_B", cB), ("conv_C", cC),
                      ("ssm", h)):
        cache[name].copy_(new)
    return out, cache
