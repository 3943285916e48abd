"""Formulations (DESIGN.md §5); port of `repro.formulations`.

Declarative `Formulation` specs (capacity rows, global budget rows, the
blockwise set) compiled onto the port's objective and solve loop:

    from repro_torch.formulations import make_objective
    obj = make_objective("multi_budget", lp, row_norm=True)
    res = Maximizer(cfg).maximize(obj, criteria=crit)

Built-ins: `matching`, `global_count`, `multi_budget`, `assignment_eq`.
Importing a built-in's module registers it.
"""
from .spec import (BlockConstraint, DestCapacityFamily, Formulation,
                   GlobalBudgetFamily, WEIGHT_KINDS)
from .registry import build, get, make_objective, names, register
from .compiler import ComposedObjective, compile_formulation

from . import matching as _matching            # noqa: F401
from . import multi_budget as _multi_budget    # noqa: F401
from . import assignment as _assignment        # noqa: F401

__all__ = [
    "BlockConstraint", "DestCapacityFamily", "Formulation",
    "GlobalBudgetFamily", "WEIGHT_KINDS",
    "build", "get", "make_objective", "names", "register",
    "ComposedObjective", "compile_formulation",
]
