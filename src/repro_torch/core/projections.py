"""Blockwise projections onto the simple-constraint polytopes (paper §3.2);
port of `repro.core.projections`.

  box        C = { 0 <= x <= ub }
  simplex    C = { x >= 0, Σx <= s }
  simplex_eq C = { x >= 0, Σx  = s }
  boxcut     C = { 0 <= x <= ub, Σx <= s }

The threshold τ is found by fixed-count bisection, row-wise over (n, w)
slabs, with the reference's arithmetic step for step.  A `mask` keeps
padded entries out: they come back 0 and never enter a sum.  These plain
versions run on any device; the slab sweep of the solver goes through the
fused kernel in `repro_torch.kernels` instead.
"""
from __future__ import annotations

import torch

_NEG = -1e30  # effective -inf that stays finite in f32 arithmetic


def _clip(v: torch.Tensor, ub: torch.Tensor) -> torch.Tensor:
    """clip(v, 0, ub) as jnp.clip computes it: min(max(v, 0), ub)."""
    return torch.minimum(torch.clamp_min(v, 0.0), ub)


def _boxcut_sum(v, tau, ub, mask):
    """f(τ) = Σ_j clip(v_j − τ, 0, ub_j) over real entries."""
    x = _clip(v - tau[..., None], ub)
    return torch.where(mask, x, torch.zeros_like(x)).sum(dim=-1)


def project_box(v, ub, mask):
    x = _clip(v, torch.broadcast_to(ub, v.shape))
    return torch.where(mask, x, torch.zeros_like(x))


def project_boxcut(v, ub, s, mask, iters: int = 40, equality: bool = False):
    """Batched projection onto { 0 <= x <= ub, Σx <= s } (or Σx = s).

    v: (..., w); ub: broadcastable to v; s: (...,); mask: (..., w).
    """
    v = torch.where(mask, v, torch.full_like(v, _NEG))
    ub = torch.broadcast_to(ub, v.shape)
    f0 = _boxcut_sum(v, torch.zeros(v.shape[:-1], dtype=v.dtype,
                                    device=v.device), ub, mask)
    need_cut = f0 > s if not equality else torch.ones_like(f0, dtype=torch.bool)
    hi = v.amax(dim=-1)
    if equality:
        lo = torch.where(mask, v - ub, torch.full_like(v, -_NEG)).amin(dim=-1) - 1.0
    else:
        lo = torch.zeros_like(hi)
    lo = torch.minimum(lo, hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_big = _boxcut_sum(v, mid, ub, mask) > s
        lo = torch.where(too_big, mid, lo)
        hi = torch.where(too_big, hi, mid)
    tau = 0.5 * (lo + hi)
    if not equality:
        tau = torch.where(need_cut, tau, torch.zeros_like(tau))
    x = _clip(v - tau[..., None], ub)
    return torch.where(mask, x, torch.zeros_like(x))


def project(kind: str, v, ub, s, mask, iters: int = 40):
    """Dispatch on the projection kind."""
    if kind == "box":
        return project_box(v, ub, mask)
    if kind == "simplex":
        big = torch.full_like(v, torch.finfo(v.dtype).max / 4)
        return project_boxcut(v, big, s, mask, iters=iters)
    if kind == "simplex_eq":
        # every coordinate of {x >= 0, Σx = s} is bounded by s, which keeps
        # the equality bracket at data scale (see the reference)
        ub_eq = torch.broadcast_to(torch.as_tensor(s, dtype=v.dtype)[..., None],
                                   v.shape)
        return project_boxcut(v, ub_eq, s, mask, iters=iters, equality=True)
    if kind == "boxcut":
        return project_boxcut(v, ub, s, mask, iters=iters)
    raise ValueError(f"unknown projection kind: {kind!r}")
