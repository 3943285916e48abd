"""multi_budget — per-destination capacities AND two global budget rows at
once; port of `repro.formulations.multi_budget`.

Destinations are capacitated (the A x <= b rows), and the campaign as a
whole carries

  * a global count cap   Σ_ij x_ij          <= count_cap  (impressions)
  * a global value cap   Σ_ij value_ij·x_ij <= value_cap  (spend, the
    edge's objective value doubling as its unit spend: the "value"
    weight −c)

Both coupling rows ride the sweep's shift hook.  Default caps bind: the
count cap is a fraction of Σ_i s_i, the value cap a fraction of the greedy
value bound Σ_i s_i · max_j value_ij.  x = 0 stays feasible.
"""
from __future__ import annotations

import numpy as np

from ..convert import to_numpy
from .registry import register
from .spec import (BlockConstraint, DestCapacityFamily, Formulation,
                   GlobalBudgetFamily)


def _budget_defaults(lp) -> tuple:
    """(Σ_i s_i, Σ_i s_i · max_j value_ij) from the packed slabs."""
    total_s = 0.0
    value_ub = 0.0
    for slab in lp.slabs:
        s = to_numpy(slab.s).astype(np.float64)
        total_s += float(s.sum())
        # c = −value on real edges, 0 on padding: max(−c) is the best value
        vmax = np.maximum(-to_numpy(slab.c_vals).astype(np.float64),
                          0.0).max(axis=-1)
        value_ub += float((s * vmax).sum())
    return total_s, value_ub


@register("multi_budget")
def multi_budget(lp, *, count_cap: float = None, value_cap: float = None,
                 count_frac: float = 0.4, value_frac: float = 0.4,
                 proj_kind: str = "boxcut",
                 proj_iters: int = 40) -> Formulation:
    """Matching + simultaneous global count and value caps (module doc)."""
    if count_cap is None or value_cap is None:
        total_s, value_ub = _budget_defaults(lp)
        if count_cap is None:
            count_cap = count_frac * total_s
        if value_cap is None:
            value_cap = value_frac * value_ub
    return Formulation(
        name="multi_budget",
        families=(
            DestCapacityFamily(),
            GlobalBudgetFamily(limit=float(count_cap), weight="count",
                               label="count_cap"),
            GlobalBudgetFamily(limit=float(value_cap), weight="value",
                               label="value_cap"),
        ),
        block=BlockConstraint(kind=proj_kind, iters=proj_iters),
        description="per-destination capacity + global count cap + global "
                    "value (spend) cap, all active simultaneously")
