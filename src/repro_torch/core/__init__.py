"""The port's solver core (counterpart of `repro.core`):

  Maximizer.maximize(obj, λ0)        -> SolveResult
  MatchingObjective.calculate(λ, γ)  -> (g, ∇g, aux)   (any ax_mode)
  GlobalCountObjective               the same with one global count row
"""
from .types import (AxBucket, AxPlan, ConvergenceCheck, HealthConfig,
                    IterStats, LPData, Slab, SolveConfig, SolveResult,
                    SolveState, StopReason, StoppingCriteria)
from .projections import project, project_box, project_boxcut
from .objectives import (AX_MODES, GlobalCountObjective, MatchingObjective,
                         ObjectiveAux, dual_value_and_grad, slab_xcarry,
                         slab_xgvals)
from .maximizer import Maximizer, SolveEngine, maximize
from .update_rules import (UpdateRule, gamma_at, get_rule, max_step_at,
                           register_rule, rule_names)
from .preconditioning import (precondition, primal_scale, row_normalize,
                              row_norms, undo_primal_scaling,
                              undo_row_scaling)
from .instance import (InstanceSpec, LPValidationError, build_ax_plan,
                       generate, pack_slabs, validate_lp)

__all__ = [
    "AxBucket", "AxPlan", "ConvergenceCheck", "HealthConfig", "IterStats",
    "LPData", "Slab", "SolveConfig", "SolveResult", "SolveState",
    "StopReason", "StoppingCriteria",
    "project", "project_box", "project_boxcut",
    "AX_MODES", "GlobalCountObjective", "MatchingObjective", "ObjectiveAux",
    "dual_value_and_grad", "slab_xcarry", "slab_xgvals",
    "Maximizer", "SolveEngine", "maximize",
    "UpdateRule", "gamma_at", "get_rule", "max_step_at", "register_rule",
    "rule_names",
    "precondition", "primal_scale", "row_normalize", "row_norms",
    "undo_primal_scaling", "undo_row_scaling",
    "InstanceSpec", "LPValidationError", "build_ax_plan", "generate",
    "pack_slabs", "validate_lp",
]
