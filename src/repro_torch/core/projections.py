"""Blockwise projections onto the simple-constraint polytopes (paper §3.2);
port of `repro.core.projections`.

  box        C = { 0 <= x <= ub }
  simplex    C = { x >= 0, Σx <= s }
  simplex_eq C = { x >= 0, Σx  = s }
  boxcut     C = { 0 <= x <= ub, Σx <= s }
  boxcut_newton  boxcut, τ by safeguarded Newton steps

The threshold τ is found by fixed-count bisection (or safeguarded Newton),
row-wise over (n, w) slabs, with the reference's arithmetic step for step.  A `mask` keeps
padded entries out: they come back 0 and never enter a sum.  These plain
versions run on any device; the slab sweep of the solver goes through the
fused kernel in `repro_torch.kernels` for the kinds that have one (box,
simplex, boxcut) and through `project` for the others.  `ProjectionMap`
gives each slab (block id) its kind and iteration count;
`project_boxcut_exact_1d` is the tests' exact host oracle.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
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


def project_boxcut_newton(v, ub, s, mask, iters: int = 12):
    """Safeguarded-Newton variant of the box-cut projection.

    f(τ) = Σ clip(v−τ, 0, ub) is piecewise linear with slope −|{j : 0 <
    v_j − τ < ub_j}|, so Newton lands exactly once the active set settles;
    each step is kept inside the bisection bracket, so the worst case is a
    bisection.  Same semantics as `project_boxcut` with equality=False.
    """
    v = torch.where(mask, v, torch.full_like(v, _NEG))
    ub = torch.broadcast_to(ub, v.shape)
    f0 = _boxcut_sum(v, torch.zeros(v.shape[:-1], dtype=v.dtype,
                                    device=v.device), ub, mask)
    need_cut = f0 > s
    hi = v.amax(dim=-1)
    lo = torch.minimum(torch.zeros_like(hi), hi)
    tau = 0.5 * (lo + hi)
    for _ in range(iters):
        t = v - tau[..., None]
        f = torch.where(mask, _clip(t, ub), torch.zeros_like(t)).sum(dim=-1)
        slope = (mask & (t > 0.0) & (t < ub)).sum(dim=-1).to(v.dtype)
        too_big = f > s
        lo = torch.where(too_big, tau, lo)
        hi = torch.where(too_big, hi, tau)
        newton = tau + (f - s) / torch.clamp_min(slope, 1.0)
        ok = (newton > lo) & (newton < hi) & (slope > 0)
        tau = torch.where(ok, newton, 0.5 * (lo + hi))
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
    if kind == "boxcut_newton":
        return project_boxcut_newton(v, ub, s, mask, iters=min(iters, 12))
    raise ValueError(f"unknown projection kind: {kind!r}")


def project_boxcut_exact_1d(v, ub, s, equality: bool = False):
    """Exact projection of one row onto {0<=x<=ub, Σx<=s} (or Σx = s) via
    the breakpoints of f(τ) = Σ clip(v−τ, 0, ub), which is piecewise
    linear and non-increasing with breakpoints at {v_j − ub_j, v_j}.
    Host numpy in float64, O(w log w): the tests' independent oracle."""
    v = np.asarray(v, dtype=np.float64)
    ub = np.broadcast_to(np.asarray(ub, dtype=np.float64), v.shape)

    def f(tau):
        return np.clip(v - tau, 0.0, ub).sum()

    if not equality and f(0.0) <= s:
        return np.clip(v, 0.0, ub)
    # with the cut active every x_j <= Σx <= s, so clamping ub at s is
    # exact and keeps the breakpoints at the data's scale
    ub = np.minimum(ub, max(s, 0.0))
    bps = np.unique(np.concatenate([v - ub, v]))
    vals = np.array([f(t) for t in bps])
    if s >= vals[0]:
        # below the first breakpoint every entry sits at its ub: f is flat
        # at Σub, and s >= Σub puts τ there
        tau = bps[0]
    elif s <= vals[-1]:
        tau = bps[-1]
    else:
        k = int(np.searchsorted(-vals, -s, side="right")) - 1
        t0, t1, f0, f1 = bps[k], bps[k + 1], vals[k], vals[k + 1]
        tau = t0 if f0 == f1 else t0 + (f0 - s) * (t1 - t0) / (f0 - f1)
    if not equality:
        tau = max(tau, 0.0)
    return np.clip(v - tau, 0.0, ub)


class ProjectionMap:
    """Block ids (slab indices) to projection ops (paper §4): every slab
    takes `kind` and `iters` unless `overrides` names it, with a kind or
    a `(kind, iters)` pair."""

    def __init__(self, kind: str = "boxcut", overrides: Optional[dict] = None,
                 iters: int = 40):
        self.kind = kind
        self.overrides = dict(overrides or {})
        self.iters = iters

    def kind_for(self, block_id: int) -> str:
        ov = self.overrides.get(block_id, self.kind)
        return ov[0] if isinstance(ov, tuple) else ov

    def iters_for(self, block_id: int) -> int:
        ov = self.overrides.get(block_id)
        return ov[1] if isinstance(ov, tuple) else self.iters

    def project(self, block_id: int, v, ub, s, mask):
        return project(self.kind_for(block_id), v, ub, s, mask,
                       iters=self.iters_for(block_id))
