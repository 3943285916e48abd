"""The two hand-written objectives as declarative specs; port of
`repro.formulations.matching`.  `matching` compiles to an objective that
equals `MatchingObjective` operation for operation, and `global_count` to
`GlobalCountObjective`'s (tests/test_torch_formulations.py holds both bit
for bit)."""
from __future__ import annotations

from ..convert import to_numpy
from .registry import register
from .spec import (BlockConstraint, DestCapacityFamily, Formulation,
                   GlobalBudgetFamily)


@register("matching")
def matching(lp, *, proj_kind: str = "boxcut", proj_iters: int = 40,
             overrides: dict = None) -> Formulation:
    """Paper §3 matching LP: per-destination capacities, box-cut blocks."""
    return Formulation(
        name="matching",
        families=(DestCapacityFamily(),),
        block=BlockConstraint(kind=proj_kind, iters=proj_iters,
                              overrides=overrides),
        description="per-destination capacity rows; blockwise box-cut "
                    "(Σ_j x_ij <= s_i, 0 <= x <= ub)")


@register("global_count")
def global_count(lp, *, count: float = None, count_frac: float = 0.5,
                 proj_kind: str = "boxcut",
                 proj_iters: int = 40) -> Formulation:
    """Matching + one global count row Σ_ij x_ij <= count.  Default count
    = count_frac · Σ_i s_i, so that the row binds."""
    if count is None:
        total_s = sum(float(to_numpy(s.s).sum()) for s in lp.slabs)
        count = count_frac * total_s
    return Formulation(
        name="global_count",
        families=(DestCapacityFamily(),
                  GlobalBudgetFamily(limit=float(count), weight="count",
                                     label="count")),
        block=BlockConstraint(kind=proj_kind, iters=proj_iters),
        description="matching + one global count row Σx <= count")
