"""Quickstart: solve a matching LP with the operator-centric API (paper §4);
the port of the reference's `examples/quickstart.py`.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Builds a synthetic Appendix-B instance, applies the §5.1 enhancements
(Jacobi row normalization + γ continuation), solves with the AGD Maximizer
under tolerance-based stopping criteria (the iteration count is a cap, not
a schedule), and checks the recovered primal's per-source simplex.  The
objective runs `ax_mode="scatter"` (K3 and a destination-keyed sum), the
mode the reference's default runs.
"""
import numpy as np
import torch

from ..convert import lp_to_torch, resolve_device
from ..core import (InstanceSpec, MatchingObjective, Maximizer, SolveConfig,
                    StoppingCriteria, generate, precondition)
from ._common import emit, fail, launch_counts, launches_since, parser


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    before = launch_counts()

    # 1. an LP instance (paper Appendix B generator)
    spec = InstanceSpec(num_sources=2000, num_destinations=100,
                        avg_nnz_per_row=25, seed=0)
    lp = lp_to_torch(generate(spec), dev)
    edges = sum(int(s.mask.sum()) for s in lp.slabs)
    widths = [s.width for s in lp.slabs]
    print(f"LP: {lp.num_sources} sources x {lp.num_destinations} "
          f"destinations, {edges} edges, slab widths {widths}")

    # 2. §5.1 enhancements: Jacobi row normalization
    lp_pc, _ = precondition(lp, row_norm=True)

    # 3. a tolerance-terminated solve: it stops at the first check where
    # the dual has stabilized AND the iterate is primal-feasible to
    # tolerance — 1200 is only a cap
    obj = MatchingObjective(lp_pc, proj_kind="boxcut", ax_mode="scatter")
    config = SolveConfig(iterations=1200, gamma=0.05,
                         gamma_init=0.8, gamma_decay_every=25,
                         max_step=20.0, initial_step=1e-3)
    criteria = StoppingCriteria(tol_rel_dual=1e-6, tol_infeas=1e-1,
                                check_every=50)
    result = Maximizer(config).maximize(obj, criteria=criteria)

    d = np.asarray(result.stats.dual_obj)
    print(f"dual objective: {d[0]:.4f} -> {d[-1]:.4f}")
    print(f"stopped after {result.iterations_run}/{config.iterations} "
          f"iterations ({result.stop_reason.value})")
    infeas = float(result.stats.infeas[-1])
    gamma_final = float(result.stats.gamma[-1])
    print(f"final infeasibility ||(Ax-b)+||: {infeas:.2e}")
    print(f"final gamma: {gamma_final:.4f}")

    # 4. recover the primal allocation x*(λ) and check its simplex
    xs = obj.primal(result.lam, torch.tensor(config.gamma, device=dev))
    total = sum(float(x.sum()) for x in xs)
    print(f"total allocation sum(x) = {total:.2f} "
          f"(per-source budget s = {spec.budget_s})")
    for x, slab in zip(xs, lp_pc.slabs):
        row_sums = torch.where(slab.mask, x, torch.zeros_like(x)).sum(-1)
        if not bool((row_sums <= spec.budget_s * 1.001).all()):
            fail("simplex violated!")
    print("per-source simplex constraints: OK")
    return emit({
        "example": "quickstart", "device": str(dev), "edges": edges,
        "slab_widths": widths, "dual_first": float(d[0]),
        "dual_final": float(d[-1]), "iterations_run": result.iterations_run,
        "iterations_cap": config.iterations,
        "stop_reason": result.stop_reason.value,
        "converged": bool(result.converged), "infeas_final": infeas,
        "gamma_final": gamma_final, "total_allocation": total,
        "simplex_ok": True, "launches": launches_since(before)}, args)


if __name__ == "__main__":
    main()
