"""assignment_eq — full assignment: every source allocates its whole
budget, Σ_j x_ij = s_i, against capacitated destinations; port of
`repro.formulations.assignment`.

The block is `simplex_eq`, which has no kernel (in the reference either):
its slabs run the plain sweep (`core.objectives._plain_sweep`) while the
Ax reduction still runs the plan's kernel.

The equality forces the mass Σ_i s_i onto the destinations, so the
instance's rhs (calibrated for Σx <= s) would leave the LP infeasible.
The spec floors each capacity at `headroom` × the load of the
even-spread assignment x_ij = s_i / deg_i, which is block-feasible, so
b' = max(b, headroom · even_spread_load) is feasible by construction.
"""
from __future__ import annotations

import numpy as np

from ..convert import to_numpy
from .registry import register
from .spec import BlockConstraint, DestCapacityFamily, Formulation


def even_spread_load(lp) -> np.ndarray:
    """(m, J) per-destination load of the even-spread assignment
    x_ij = s_i / deg_i, in float64.  Sums by `np.bincount`; its float32
    rhs equals the reference's (`np.add.at`) bit for bit on the tests'
    instances."""
    m, J = tuple(lp.b.shape)
    load = np.zeros((m, J))
    for slab in lp.slabs:
        a = to_numpy(slab.a_vals).astype(np.float64)          # (n, w, m)
        dest = to_numpy(slab.dest_idx).reshape(-1)
        mk = to_numpy(slab.mask).astype(bool)
        deg = np.maximum(mk.sum(axis=-1), 1)
        per_edge = (to_numpy(slab.s).astype(np.float64) / deg)[:, None] * mk
        for k in range(m):
            load[k] += np.bincount(dest, weights=(a[..., k] * per_edge)
                                   .reshape(-1), minlength=J)
    return load


@register("assignment_eq")
def assignment_eq(lp, *, headroom: float = 1.25,
                  proj_iters: int = 60) -> Formulation:
    """Full-assignment matching: Σ_j x_ij = s_i blocks against capacities
    b' = max(b, headroom · even_spread_load) (module docstring).  The
    equality's τ may be negative and its bracket is wider, so the
    bisection takes more steps than the inequality's 40."""
    if headroom < 1.0:
        raise ValueError(
            f"headroom must be >= 1 (feasibility certificate), got "
            f"{headroom!r}")
    rhs = np.maximum(to_numpy(lp.b).astype(np.float64),
                     headroom * even_spread_load(lp))
    return Formulation(
        name="assignment_eq",
        families=(DestCapacityFamily(rhs=rhs.astype(np.float32)),),
        block=BlockConstraint(kind="simplex_eq", iters=proj_iters),
        description="per-source FULL assignment (Σ_j x_ij = s_i); "
                    "capacities floored at headroom x even-spread load")
