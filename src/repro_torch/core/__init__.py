"""The port's solver core (counterpart of `repro.core`):

  Maximizer.maximize(obj, λ0)        -> SolveResult
  MatchingObjective.calculate(λ, γ)  -> (g, ∇g, aux)   (any ax_mode)
  GlobalCountObjective               the same with one global count row
  ProjectionMap                      each slab's projection kind and steps
  solve_distributed(lp, cfg, grid)   the same solve over torch.distributed
                                     ranks (one all-reduce a step)
  baseline_numpy                     the pure-numpy CPU solver, the parity
                                     and speed baseline (not imported here)
"""
from .types import (AxBucket, AxPlan, ConvergenceCheck, HealthConfig,
                    HealthRecord, IterStats, LPData, Slab, SolveConfig,
                    SolveResult, SolveState, StopReason, StoppingCriteria)
from .projections import (ProjectionMap, project, project_box,
                          project_boxcut, project_boxcut_exact_1d,
                          project_boxcut_newton)
from .objectives import (AX_MODES, GlobalCountObjective, MatchingObjective,
                         ObjectiveAux, dual_value_and_grad, slab_xcarry,
                         slab_xgvals, slab_xstar)
from .maximizer import Maximizer, SolveEngine, maximize
from .update_rules import (LOCAL, DualReduce, UpdateRule, gamma_at,
                           get_rule, max_step_at, register_rule, rule_names)
from .preconditioning import (gram_condition_number, precondition,
                              primal_scale, row_normalize, row_norms,
                              undo_primal_scaling, undo_row_scaling)
from .instance import (InstanceSpec, LPValidationError, build_ax_plan,
                       build_sharded_ax_plan, generate, pack_slabs, to_dense,
                       validate_lp)
from .distributed import (DistributedMatchingObjective, ShardedDualReduce,
                          pad_for_sharding, pad_slab_rows, place_lp,
                          solve_distributed)

__all__ = [
    "AxBucket", "AxPlan", "ConvergenceCheck", "HealthConfig", "HealthRecord",
    "IterStats", "LPData", "Slab", "SolveConfig", "SolveResult", "SolveState",
    "StopReason", "StoppingCriteria",
    "ProjectionMap", "project", "project_box", "project_boxcut",
    "project_boxcut_exact_1d", "project_boxcut_newton",
    "AX_MODES", "GlobalCountObjective", "MatchingObjective", "ObjectiveAux",
    "dual_value_and_grad", "slab_xcarry", "slab_xgvals", "slab_xstar",
    "Maximizer", "SolveEngine", "maximize",
    "DualReduce", "LOCAL", "UpdateRule", "gamma_at", "get_rule",
    "max_step_at", "register_rule", "rule_names",
    "gram_condition_number", "precondition", "primal_scale",
    "row_normalize", "row_norms", "undo_primal_scaling", "undo_row_scaling",
    "InstanceSpec", "LPValidationError", "build_ax_plan",
    "build_sharded_ax_plan", "generate", "pack_slabs", "to_dense",
    "validate_lp",
    "DistributedMatchingObjective", "ShardedDualReduce", "pad_for_sharding",
    "pad_slab_rows", "place_lp", "solve_distributed",
]
