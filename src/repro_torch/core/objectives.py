"""Dual value and gradient of the matching LP (paper §3-§4); port of
`repro.core.objectives`, value-carrying aligned mode only.

    g(λ) = min_{x∈C} cᵀx + (γ/2)‖x‖² + λᵀ(Ax − b),   ∇g(λ) = A x*(λ) − b

One evaluation is two stages, each a hand-written kernel on the card:
  1. the x-carry sweep: per slab, x*(λ), cᵀx and ‖x‖² (`slab_xcarry`,
     kernel `dual_x`), each slab writing its x into its slice of one flat
     (E,) buffer in slab-concatenation order;
  2. the value-carrying reduction Ax from that buffer through the plan's
     static `a_dm` copy (`ops.ax_aligned_x`, kernel `ax_reduce_x`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels import ops as kops
from .instance import build_ax_plan
from .types import AxPlan, LPData, Slab

AX_MODES = ("scatter", "sorted", "aligned", "aligned_gvals")


class ObjectiveAux(NamedTuple):
    primal_obj: torch.Tensor   # cᵀx*(λ)
    x_sq: torch.Tensor         # ‖x‖²
    ax: torch.Tensor           # (m, J)  A x*(λ)
    infeas: torch.Tensor       # ‖(Ax−b)₊‖₂


def slab_xcarry(slab: Slab, lam, gamma, proj_kind: str, proj_iters: int = 40,
                out: Optional[torch.Tensor] = None):
    """Gvals-free per-slab forward pass: (x*, cᵀx, ‖x‖²).  `out` (n, w)
    receives x when given.  The reference's coupling-row `shift` hook comes
    with the formulations (ROADMAP queue A item 11)."""
    return kops.dual_x_full(slab, lam, gamma, proj_kind, proj_iters, out=out)


class MatchingObjective:
    """Paper §4 `ObjectiveFunction` facade over an LP on one device.

    Only `ax_mode="aligned"` (the value-carrying x-only path) is ported;
    the other reference modes raise NotImplementedError.
    """

    def __init__(self, lp: LPData, proj_kind: str = "boxcut",
                 proj_iters: int = 40, ax_mode: str = "aligned",
                 ax_plan: Optional[AxPlan] = None):
        if ax_mode not in AX_MODES:
            raise ValueError(f"ax_mode must be one of {AX_MODES}, got {ax_mode!r}")
        if ax_mode != "aligned":
            raise NotImplementedError(
                f"ax_mode={ax_mode!r} is not ported yet (ROADMAP queue A "
                f"item 9); the port runs ax_mode='aligned'")
        self.lp = lp
        self.proj_kind = proj_kind
        self.proj_iters = proj_iters
        self.ax_mode = ax_mode
        device = lp.b.device
        if ax_plan is None:
            from ..convert import lp_to_numpy, plan_to_torch  # convert imports core
            ax_plan = plan_to_torch(build_ax_plan(lp_to_numpy(lp)), device)
        self._plan = ax_plan
        # the flat (E,) x buffer every evaluation's sweep writes into, and
        # each slab's (n, w) view of it
        self._offsets = []
        off = 0
        for s in lp.slabs:
            self._offsets.append(off)
            off += s.n * s.width
        self._xbuf = torch.empty(off, dtype=lp.slabs[0].c_vals.dtype
                                 if lp.slabs else torch.float32,
                                 device=device)

    @property
    def dual_shape(self) -> Tuple[int, int]:
        return (self.lp.m, self.lp.num_destinations)

    def _forward(self, lam, gamma):
        """The slab sweep and the Ax reduction: (Ax, cᵀx, ‖x‖²)."""
        c_x = torch.zeros((), dtype=lam.dtype, device=lam.device)
        x_sq = torch.zeros((), dtype=lam.dtype, device=lam.device)
        for slab, off in zip(self.lp.slabs, self._offsets):
            view = self._xbuf[off:off + slab.n * slab.width].view(
                slab.n, slab.width)
            _, c_s, sq_s = slab_xcarry(slab, lam, gamma, self.proj_kind,
                                       self.proj_iters, out=view)
            c_x = c_x + c_s
            x_sq = x_sq + sq_s
        ax = kops.ax_aligned_x(self._plan, self._xbuf, out_dtype=lam.dtype)
        return ax, c_x, x_sq

    def calculate(self, lam, gamma):
        ax, c_x, x_sq = self._forward(lam, gamma)
        grad = ax - self.lp.b
        g = c_x + 0.5 * gamma * x_sq + torch.sum(lam * grad)
        infeas = torch.linalg.vector_norm(torch.clamp_min(grad, 0.0))
        return g, grad, ObjectiveAux(primal_obj=c_x, x_sq=x_sq, ax=ax,
                                     infeas=infeas)

    def primal(self, lam, gamma):
        """The (padded) primal solution x*(λ), slab by slab."""
        return [slab_xcarry(s, lam, gamma, self.proj_kind, self.proj_iters)[0]
                for s in self.lp.slabs]

    def primal_rows(self, lam, gamma, slab_index: int, rows) -> torch.Tensor:
        """x*(λ) for a subset of one slab's source rows — the serving path.
        Every operation is row-local, so the result equals the matching
        rows of `primal` bit for bit."""
        slab = self.lp.slabs[slab_index]
        rows = torch.as_tensor(rows, device=slab.c_vals.device).long()
        sub = Slab(*(leaf.index_select(0, rows) for leaf in slab))
        return slab_xcarry(sub, lam, gamma, self.proj_kind,
                           self.proj_iters)[0]
