"""Public entry points of the port's kernels (port of `repro.kernels.ops`).

  proj_boxcut     batched box-cut projection of an (n, w) slab (K5)
  dual_grad_slab  x*(λ), gvals, cᵀx, ‖x‖² of one slab (K3)
  dual_grad_full  the same with the projection-kind dispatch
  dual_xstar      x*(λ) of one slab through K3
  dual_x_full     x*(λ), cᵀx, ‖x‖² of one slab, gvals-free (K1), with the
                  projection-kind dispatch of the reference's `dual_x_full`
  ax_reduce_bucket  (r, m) gvals gather row-sum of one plan bucket (K4)
  ax_aligned      (m, J) Ax from an index-only plan and the flat (E, m)
                  gvals (K4, one call a plan)
  ax_aligned_x    (m, J) Ax from a value-carrying plan and the flat (E,) x
                  (K2, one call a plan)
  plan_work       the work table both Ax kernels run on, built once a plan

Each launches its hand-written kernel for tensors on the card and runs the
plain version for tensors on the CPU (see `dual_grad.py`, `ax_reduce.py`,
`proj.py`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.types import AxPlan, Slab
from . import ax_reduce as _ax_reduce
from . import dual_grad as _dual_grad
from . import proj as _proj
from .ax_reduce import AxWork, plan_work  # noqa: F401
from .dual_grad import DEFAULT_ITERS


def proj_boxcut(v, ub, s, mask, iters: int = DEFAULT_ITERS):
    """Batched box-cut projection (kernel: proj_boxcut)."""
    return _proj.proj_boxcut(v, ub, s, mask, iters=iters)


# the projection kinds the sweep kernels (K1, K3) take; the others
# (simplex_eq, boxcut_newton) have no kernel, in the reference either
KERNEL_KINDS = ("boxcut", "simplex", "box")


def _kind_slab(slab: Slab, proj_kind: str) -> Slab:
    """The kernels' projection-kind dispatch: simplex runs as box-cut with
    ub = 1e30; box and boxcut pass through (box keeps the slab's budget s,
    as in the reference); every other kind raises NotImplementedError."""
    if proj_kind == "simplex":
        return slab._replace(ub=torch.full_like(slab.ub, 1e30))
    if proj_kind not in KERNEL_KINDS:
        raise NotImplementedError(
            f"the kernels support boxcut/simplex/box, got {proj_kind}")
    return slab


def dual_grad_slab(slab: Slab, lam, gamma, iters: int = DEFAULT_ITERS,
                   out: Optional[torch.Tensor] = None,
                   gvals_out: Optional[torch.Tensor] = None):
    """Fused (x*, gvals, cᵀx, ‖x‖²) for one slab (kernel: dual_grad_slab).
    `out` (n, w) and `gvals_out` (n, w, m) receive x and gvals when
    given."""
    return _dual_grad.dual_grad_slab(
        slab.a_vals, slab.c_vals, slab.dest_idx, slab.mask, slab.ub, slab.s,
        lam, gamma, iters=iters, out=out, gvals_out=gvals_out)


def dual_grad_full(slab: Slab, lam, gamma, proj_kind: str = "boxcut",
                   iters: int = DEFAULT_ITERS,
                   out: Optional[torch.Tensor] = None,
                   gvals_out: Optional[torch.Tensor] = None):
    """`dual_grad_slab` with the projection-kind dispatch: the entry point
    of the gvals sweep (`core.objectives.slab_xgvals`)."""
    return dual_grad_slab(_kind_slab(slab, proj_kind), lam, gamma,
                          iters=iters, out=out, gvals_out=gvals_out)


def dual_xstar(slab: Slab, lam, gamma, proj_kind: str = "boxcut",
               iters: int = DEFAULT_ITERS):
    """x*(λ) for one slab via the fused gvals kernel, as the reference's."""
    return dual_grad_full(slab, lam, gamma, proj_kind, iters)[0]


def dual_x_full(slab: Slab, lam, gamma, proj_kind: str = "boxcut",
                iters: int = DEFAULT_ITERS,
                out: Optional[torch.Tensor] = None):
    """Fused (x*, cᵀx, ‖x‖²) for one slab (kernel: dual_x_slab), with the
    projection-kind dispatch.  `out` (n, w) receives x when given."""
    slab = _kind_slab(slab, proj_kind)
    return _dual_grad.dual_x_slab(
        slab.a_vals, slab.c_vals, slab.dest_idx, slab.mask, slab.ub, slab.s,
        lam, gamma, iters=iters, out=out)


def ax_reduce_bucket(gvals, edge_idx, mask):
    """(r, m) float32 masked gather row-sum of one bucket, in bucket row
    order, as the reference's entry point returns it (kernel:
    ax_reduce_bucket, into a scratch (m, r) buffer)."""
    r = edge_idx.shape[0]
    out = torch.empty((gvals.shape[1], r), dtype=torch.float32,
                      device=gvals.device)
    rows = torch.arange(r, dtype=torch.int32, device=gvals.device)
    return _ax_reduce.ax_reduce_bucket(gvals, edge_idx, mask, rows, out).T


def ax_aligned(plan: AxPlan, gvals: torch.Tensor, out_dtype=None,
               work: Optional[AxWork] = None) -> torch.Tensor:
    """Scatter-free (m, J) Ax from the (E, m) gvals (edge order = slab
    concatenation order, the plan's edge space) over an index-only plan.

    On the card one kernel call takes every bucket (the items, then the
    second pass), driven by the plan's work table `work` (`plan_work(plan)`,
    built here when not given).  The plan
    covers each destination exactly once, so the buffer needs no
    initialisation and no `inv_perm` gather.
    """
    out = torch.empty((gvals.shape[1], plan.num_destinations),
                      dtype=torch.float32, device=gvals.device)
    _ax_reduce.ax_reduce_plan(gvals, plan, out, work)
    return out.to(out_dtype or gvals.dtype)


def ax_aligned_x(plan: AxPlan, x: torch.Tensor, out_dtype=None,
                 work: Optional[AxWork] = None) -> torch.Tensor:
    """Scatter-free (m, J) Ax from the (E,) x vector (edge order = slab
    concatenation order, the plan's edge space) over a value-carrying
    plan.

    On the card one kernel call takes every bucket (the items, then the
    second pass), driven by the plan's work table `work` (`plan_work(plan)`,
    built here when not given).  The plan
    covers each destination exactly once, so the buffer needs no
    initialisation.
    """
    if any(b.a_dm is None for b in plan.buckets):
        raise ValueError("ax_aligned_x needs a value-carrying plan; rebuild "
                         "with build_ax_plan(lp, carry_values=True)")
    m = plan.buckets[0].a_dm.shape[-1]
    out = torch.empty((m, plan.num_destinations), dtype=torch.float32,
                      device=x.device)
    _ax_reduce.ax_reduce_plan_x(x, plan, out, work)
    return out.to(out_dtype or x.dtype)
