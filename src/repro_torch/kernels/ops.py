"""Public entry points of the port's kernels (port of `repro.kernels.ops`,
the x-carry aligned path only).

  dual_x_full    x*(λ), cᵀx, ‖x‖² of one slab, with the projection-kind
                 dispatch of the reference's `dual_x_full`
  ax_aligned_x   (m, J) Ax from a value-carrying plan and the flat (E,) x

Each launches its hand-written kernel for tensors on the card and runs the
plain version for tensors on the CPU (see `dual_grad.py`, `ax_reduce.py`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.types import AxPlan, Slab
from .ax_reduce import ax_reduce_bucket_x
from .dual_grad import DEFAULT_ITERS, dual_x_slab


def dual_x_full(slab: Slab, lam, gamma, proj_kind: str = "boxcut",
                iters: int = DEFAULT_ITERS,
                out: Optional[torch.Tensor] = None):
    """Fused (x*, cᵀx, ‖x‖²) for one slab (kernel: dual_x_slab).

    simplex runs as box-cut with ub = 1e30; box and boxcut pass through
    (box keeps the slab's budget s, as in the reference); every other kind
    raises NotImplementedError.
    """
    if proj_kind == "simplex":
        slab = slab._replace(ub=torch.full_like(slab.ub, 1e30))
    elif proj_kind not in ("boxcut", "box"):
        raise NotImplementedError(
            f"the dual_x kernel supports boxcut/simplex/box, got {proj_kind}")
    return dual_x_slab(slab.a_vals, slab.c_vals, slab.dest_idx, slab.mask,
                       slab.ub, slab.s, lam, gamma, iters=iters, out=out)


def ax_aligned_x(plan: AxPlan, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Scatter-free (m, J) Ax from the (E,) x vector (edge order = slab
    concatenation order, the plan's edge space).

    Every bucket's kernel writes its destinations' columns of one (m, J)
    float32 buffer; the plan covers each destination exactly once, so the
    buffer needs no initialisation.
    """
    m = plan.buckets[0].a_dm.shape[-1]
    out = torch.empty((m, plan.num_destinations), dtype=torch.float32,
                      device=x.device)
    for b in plan.buckets:
        ax_reduce_bucket_x(x, b.a_dm, b.edge_idx, b.mask, b.dest_ids, out)
    return out.to(out_dtype or x.dtype)
