"""Where the perf_lp/tol_agd, tol_pdhg and tol_bb solves stop, reference
against port, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_stop_iterations.py \
        [--formulation NAME] [agd] [pdhg] [bb]

The instance is the `--quick` one of `benchmarks/perf_lp.py` (2,000 x 1,000,
nu = 4, seed 42, row-normalized, boxcut with 20 bisection steps, gamma
0.01, tol_rel_dual 1e-6 and tol_infeas_rel 1e-4 checked every 25), under
each named update rule (all three by default).  At that tolerance the
stopping check moves with the summation order alone, so the reference and
the port run under each of their ax modes; the reference's spread is what
`chip_smoke.py` holds the port's stopping iteration to.  Then each
engine runs on the other package's objective (aligned): the reference's
rule on the port's float32 evaluation of g and its gradient, and the
port's rule on the reference's, which tells a fault of the rule from the
objective's summation order.

`--formulation` (default matching) names a registered formulation: the
other formulations run as the reference's perf_lp/tol_<rule>_<name> rows
do, compiled from the un-preconditioned instance with row_norm, with the
formulation's default projection steps, in each package's ax modes.  Not
collected by pytest: it takes several minutes (an hour and more for bb
on global_count).
"""
import argparse

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro import formulations
from repro.core import (InstanceSpec, MatchingObjective, Maximizer,
                        SolveConfig, StoppingCriteria, generate)
from repro.core.objectives import ObjectiveAux
from repro.core.preconditioning import precondition

import repro_torch.core as tcore
from repro_torch import formulations as tformulations
from repro_torch.convert import lp_to_torch

SPEC = dict(num_sources=2000, num_destinations=1000, avg_nnz_per_row=4.0,
            seed=42)
CONFIG = dict(iterations=30000, gamma=0.01, max_step=1e-1, initial_step=1e-5)
CRITERIA = dict(tol_rel_dual=1e-6, tol_infeas_rel=1e-4, check_every=25)


def show(tag, res):
    print(f"{tag}: {res.stop_reason.value} after {res.iterations_run} "
          f"iterations, dual {float(res.stats.dual_obj[-1]):.6f}", flush=True)


class PortObjectiveForReference:
    """The port's objective behind the reference engine's `calculate`."""

    def __init__(self, tobj, lp):
        self.tobj, self.lp, self.dual_shape = tobj, lp, tobj.dual_shape

    def calculate(self, lam, gamma):
        def host(lam, gamma):
            g, grad, aux = self.tobj.calculate(
                torch.from_numpy(np.array(lam)),
                torch.tensor(np.float32(gamma)))
            return (g.numpy(), grad.numpy(), aux.primal_obj.numpy(),
                    aux.x_sq.numpy(), aux.infeas.numpy())
        f32 = jax.ShapeDtypeStruct((), jnp.float32)
        g, grad, c_x, x_sq, infeas = jax.pure_callback(
            host, (f32, jax.ShapeDtypeStruct(self.dual_shape, jnp.float32),
                   f32, f32, f32), lam, gamma)
        return g, grad, ObjectiveAux(primal_obj=c_x, x_sq=x_sq, ax=None,
                                     infeas=infeas)


class ReferenceObjectiveForPort:
    """The reference's objective behind the port engine's `calculate`."""

    def __init__(self, robj, lp_t):
        self.calc = jax.jit(robj.calculate)
        self.lp, self.dual_shape = lp_t, robj.dual_shape

    def calculate(self, lam, gamma):
        g, grad, aux = self.calc(jnp.asarray(lam.numpy()),
                                 jnp.float32(gamma.item()))
        t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
        return t(g), t(grad), tcore.ObjectiveAux(
            primal_obj=t(aux.primal_obj), x_sq=t(aux.x_sq), ax=t(aux.ax),
            infeas=t(aux.infeas))


MODES = ("aligned", "aligned_gvals", "sorted", "scatter")


def formulation(name, rules):
    """The stops of formulation `name` under each rule: the reference's and
    the port's objective in each ax mode, then each engine on the other
    package's objective (aligned)."""
    lp_host = generate(InstanceSpec(**SPEC))
    lp_t_host = lp_to_torch(tcore.generate(tcore.InstanceSpec(**SPEC)), "cpu")

    def ref_obj(mode):
        return formulations.make_objective(name, lp_host, ax_mode=mode,
                                           row_norm=True)

    def port_obj(mode):
        return tformulations.make_objective(name, lp_t_host, ax_mode=mode,
                                            row_norm=True)

    for rule in rules:
        for mode in MODES:
            show(f"{rule} {name} reference ax_mode={mode}",
                 Maximizer(SolveConfig(**CONFIG), algorithm=rule).maximize(
                     ref_obj(mode), criteria=StoppingCriteria(**CRITERIA)))
        for mode in MODES:
            show(f"{rule} {name} port ax_mode={mode}, cpu",
                 tcore.Maximizer(tcore.SolveConfig(**CONFIG),
                                 algorithm=rule).maximize(
                     port_obj(mode),
                     criteria=tcore.StoppingCriteria(**CRITERIA)))
        robj, tobj = ref_obj("aligned"), port_obj("aligned")
        show(f"{rule} {name} reference engine on the port's objective",
             Maximizer(SolveConfig(**CONFIG), algorithm=rule).maximize(
                 PortObjectiveForReference(tobj, robj.lp),
                 criteria=StoppingCriteria(**CRITERIA)))
        show(f"{rule} {name} port engine on the reference's objective",
             tcore.Maximizer(tcore.SolveConfig(**CONFIG),
                             algorithm=rule).maximize(
                 ReferenceObjectiveForPort(robj, tobj.lp),
                 criteria=tcore.StoppingCriteria(**CRITERIA)))


def main(rules=("agd", "pdhg", "bb")):
    lp_host = generate(InstanceSpec(**SPEC))
    lp, _ = precondition(jax.tree.map(jnp.asarray, lp_host), row_norm=True)
    lp_t, _ = tcore.precondition(
        lp_to_torch(tcore.generate(tcore.InstanceSpec(**SPEC)), "cpu"),
        row_norm=True)
    for rule in rules:
        for mode in ("aligned", "aligned_gvals", "sorted", "scatter"):
            obj = MatchingObjective(lp, proj_kind="boxcut", proj_iters=20,
                                    ax_mode=mode)
            show(f"{rule} reference ax_mode={mode}",
                 Maximizer(SolveConfig(**CONFIG), algorithm=rule).maximize(
                     obj, criteria=StoppingCriteria(**CRITERIA)))
        obj = formulations.make_objective("matching", lp_host,
                                          params={"proj_iters": 20},
                                          ax_mode="aligned", row_norm=True)
        show(f"{rule} reference formulations.make_objective(matching, "
             f"aligned)",
             Maximizer(SolveConfig(**CONFIG), algorithm=rule).maximize(
                 obj, criteria=StoppingCriteria(**CRITERIA)))
        for mode in ("aligned", "aligned_gvals", "sorted", "scatter"):
            obj = tcore.MatchingObjective(lp_t, proj_kind="boxcut",
                                          proj_iters=20, ax_mode=mode)
            show(f"{rule} port ax_mode={mode}, cpu",
                 tcore.Maximizer(tcore.SolveConfig(**CONFIG),
                                 algorithm=rule).maximize(
                     obj, criteria=tcore.StoppingCriteria(**CRITERIA)))
        robj = MatchingObjective(lp, proj_kind="boxcut", proj_iters=20,
                                 ax_mode="aligned")
        tobj = tcore.MatchingObjective(lp_t, proj_kind="boxcut",
                                       proj_iters=20, ax_mode="aligned")
        show(f"{rule} reference engine on the port's objective",
             Maximizer(SolveConfig(**CONFIG), algorithm=rule).maximize(
                 PortObjectiveForReference(tobj, lp),
                 criteria=StoppingCriteria(**CRITERIA)))
        show(f"{rule} port engine on the reference's objective",
             tcore.Maximizer(tcore.SolveConfig(**CONFIG),
                             algorithm=rule).maximize(
                 ReferenceObjectiveForPort(robj, lp_t),
                 criteria=tcore.StoppingCriteria(**CRITERIA)))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--formulation", default="matching",
                    choices=tformulations.names())
    ap.add_argument("rules", nargs="*", default=["agd", "pdhg", "bb"])
    opts = ap.parse_args()
    if opts.formulation == "matching":
        main(tuple(opts.rules))
    else:
        formulation(opts.formulation, tuple(opts.rules))
