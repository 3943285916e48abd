"""Shared neural layers: params-as-data, norms, RoPE, gated MLPs, chunked
xent; port of `repro.models.layers`.

Models are functions over flat param dicts ("path" -> tensor).  Each param
is declared once as a ParamDef carrying shape, dtype, init scale and
*logical* sharding axes, the same paths and shapes as the reference's, so
the reference's weights carry across by name (`convert.lm_params_from_numpy`).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import sharding
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


def tree_tensors(tree):
    """Every tensor of a cache tree (tuples of dicts, or the enc-dec
    {"self": ..., "cross": ...}), in a fixed order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_tensors(tree[k])
    else:
        for child in tree:
            yield from tree_tensors(child)


def zeros_like_shapes(tree, device):
    """A tree of `ShapeDtype`s -> the same tree of zeroed tensors."""
    if isinstance(tree, ShapeDtype):
        return torch.zeros(tree.shape, dtype=tree.dtype, device=device)
    if isinstance(tree, dict):
        return {k: zeros_like_shapes(v, device) for k, v in tree.items()}
    return tuple(zeros_like_shapes(v, device) for v in tree)


def remat(fn, *args):
    """fn(*args), its activations recomputed in the backward (the
    reference's `jax.checkpoint`) when autograd is recording; a plain call
    otherwise (serving, under `inference_mode`)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def abstract_params(defs: ParamDefs) -> Dict[str, torch.Tensor]:
    """Every param as a `meta` tensor of its shape and dtype: no storage
    (the reference's ShapeDtypeStruct stand-ins)."""
    return {p: torch.empty(d.shape, dtype=d.dtype, device="meta")
            for p, d in defs.items()}


def param_pspecs(defs: ParamDefs) -> Dict[str, sharding.Spec]:
    """Specs from logical axes, shape-fitted under the active mesh
    (divisibility fallback + axis dedup happen here, not at use sites)."""
    return {p: sharding.spec_for(d.logical, shape=d.shape)
            for p, d in defs.items()}


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
    h = sharding.constrain(g * u, "batch", None, "ff")
    return h @ p[f"{prefix}/wo"].to(cfg.cdtype)


# ---------------------------------------------------------------------------
# embeddings, the last position's logits and chunked softmax cross-entropy
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
    # F.embedding, not indexing: its backward sums a row's gradients in a
    # fixed order (indexing's `index_put_` accumulate did not repeat on
    # several CPU threads), so a resumed training run repeats bit for bit
    return sharding.constrain(
        F.embedding(tokens, emb) * host_scalar(scale, cfg.cdtype),
        "batch", "seq", None)


def _out_matrix(cfg: ModelConfig, p) -> torch.Tensor:
    if cfg.tie_embeddings:
        return p["embed/tok"].to(cfg.cdtype).T
    return p["embed/out"].to(cfg.cdtype)


def logits_last(cfg: ModelConfig, p, h: torch.Tensor) -> torch.Tensor:
    """Logits over the padded vocabulary for the last position only: h
    (B, D) -> (B, padded_vocab)."""
    return sharding.constrain(h @ _out_matrix(cfg, p), "batch", "vocab")


def _chunk_loss(cfg: ModelConfig, out_w, hb, lb):
    """One chunk's summed cross-entropy over its valid labels, and their
    count, both float32."""
    logits = sharding.constrain((hb @ out_w).float(),  # (B, C, V)
                                "batch", None, "vocab")
    lse = torch.logsumexp(logits, dim=-1)
    lbl = lb.clamp(0, cfg.vocab - 1).long()
    if sharding.current_mesh() is None:
        picked = torch.gather(logits, -1, lbl[..., None])[..., 0]
    else:
        # vocab-sharded logits: a masked sum over the vocab stays local to
        # each shard (a sum of one value and zeros: the same value)
        vocab = torch.arange(logits.shape[-1], device=lb.device)
        picked = torch.where(vocab == lbl[..., None], logits, 0.0).sum(-1)
    valid = (lb >= 0).float()
    return ((lse - picked) * valid).sum(), valid.sum()


def chunked_xent(cfg: ModelConfig, p, h: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy without materializing (B, S, V).

    A loop over sequence chunks of `cfg.xent_chunk` (the reference's scan):
    per chunk the logits, their logsumexp and the label's logit, summed in
    float32; labels of -1 count for nothing.  Each chunk is recomputed in
    the backward (`remat`), so the (B, C, V) logits are never stored."""
    B, S, D = h.shape
    C = min(cfg.xent_chunk, S)
    n = -(-S // C)
    pad = n * C - S
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    out_w = _out_matrix(cfg, p)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n):
        t, k = remat(functools.partial(_chunk_loss, cfg), out_w,
                     h[:, c * C:(c + 1) * C], labels[:, c * C:(c + 1) * C])
        tot, cnt = tot + t, cnt + k
    return tot / cnt.clamp(min=1.0)
