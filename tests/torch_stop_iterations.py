"""Where the perf_lp/tol_agd solve stops, reference against port, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_stop_iterations.py

The instance is the `--quick` one of `benchmarks/perf_lp.py` (2,000 x 1,000,
nu = 4, seed 42, row-normalized, boxcut with 20 bisection steps, agd at
gamma 0.01, tol_rel_dual 1e-6 and tol_infeas_rel 1e-4 checked every 25).
At that tolerance the stopping check moves with the summation order alone,
so the reference and the port run under each of their ax modes; the
reference's spread is what `chip_smoke.py` holds the port's stopping
iteration to.  Not collected by pytest: it takes a few minutes.
"""
import jax
import jax.numpy as jnp

from repro import formulations
from repro.core import (InstanceSpec, MatchingObjective, Maximizer,
                        SolveConfig, StoppingCriteria, generate)
from repro.core.preconditioning import precondition

import repro_torch.core as tcore
from repro_torch.convert import lp_to_torch

SPEC = dict(num_sources=2000, num_destinations=1000, avg_nnz_per_row=4.0,
            seed=42)
CONFIG = dict(iterations=30000, gamma=0.01, max_step=1e-1, initial_step=1e-5)
CRITERIA = dict(tol_rel_dual=1e-6, tol_infeas_rel=1e-4, check_every=25)


def show(tag, res):
    print(f"{tag}: {res.stop_reason.value} after {res.iterations_run} "
          f"iterations, dual {float(res.stats.dual_obj[-1]):.6f}", flush=True)


def main():
    lp_host = generate(InstanceSpec(**SPEC))
    lp, _ = precondition(jax.tree.map(jnp.asarray, lp_host), row_norm=True)
    for mode in ("aligned", "aligned_gvals", "sorted", "scatter"):
        obj = MatchingObjective(lp, proj_kind="boxcut", proj_iters=20,
                                ax_mode=mode)
        show(f"reference ax_mode={mode}", Maximizer(SolveConfig(**CONFIG))
             .maximize(obj, criteria=StoppingCriteria(**CRITERIA)))
    obj = formulations.make_objective("matching", lp_host,
                                      params={"proj_iters": 20},
                                      ax_mode="aligned", row_norm=True)
    show("reference formulations.make_objective(matching, aligned)",
         Maximizer(SolveConfig(**CONFIG)).maximize(
             obj, criteria=StoppingCriteria(**CRITERIA)))

    lp_t, _ = tcore.precondition(
        lp_to_torch(tcore.generate(tcore.InstanceSpec(**SPEC)), "cpu"),
        row_norm=True)
    for mode in ("aligned", "aligned_gvals", "sorted", "scatter"):
        obj = tcore.MatchingObjective(lp_t, proj_kind="boxcut",
                                      proj_iters=20, ax_mode=mode)
        show(f"port ax_mode={mode}, cpu",
             tcore.Maximizer(tcore.SolveConfig(**CONFIG)).maximize(
                 obj, criteria=tcore.StoppingCriteria(**CRITERIA)))


if __name__ == "__main__":
    main()
