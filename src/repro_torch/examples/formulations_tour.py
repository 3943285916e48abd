"""Tour of the formulation subsystem: every registered formulation, one
instance, one unchanged engine (DESIGN.md §5); the port of the reference's
`examples/formulations_tour.py`.

    PYTHONPATH=src python -m repro_torch.examples.formulations_tour [--quick]

Builds one Appendix-B instance, then compiles and solves EVERY registered
formulation on it — `matching`, `global_count`, `multi_budget`,
`assignment_eq`, plus anything user code registered — each through the
same tolerance-terminated engine on the aligned Ax layout (K1 + K2).  Each
row prints the dual-row layout, iterations to stop and the coupling-row
usage.  Then `multi_budget` again with both caps tightened below
matching's unconstrained usage, so that both coupling rows bind.

Exits non-zero if a formulation does not converge or the tightened rows do
not bind.
"""
import time

import torch

from .. import formulations
from ..convert import lp_to_torch, resolve_device
from ..core import (InstanceSpec, Maximizer, SolveConfig, StoppingCriteria,
                    generate)
from ._common import emit, fail, launch_counts, launches_since, parser


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="small instance + looser tolerance (CI smoke)")
    ap.add_argument("--sources", type=int, default=None)
    ap.add_argument("--destinations", type=int, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    before = launch_counts()

    I = args.sources or (800 if args.quick else 5_000)
    J = args.destinations or (40 if args.quick else 200)
    spec = InstanceSpec(num_sources=I, num_destinations=J,
                        avg_nnz_per_row=12, seed=7, num_families=2)
    lp = lp_to_torch(generate(spec), dev)
    edges = sum(int(s.mask.sum()) for s in lp.slabs)
    print(f"instance: {I} sources x {J} destinations x {lp.m} families, "
          f"{edges} edges")
    print(f"registered formulations: {', '.join(formulations.names())}\n")

    cfg = SolveConfig(iterations=2000 if args.quick else 4000, gamma=0.05,
                      gamma_init=0.8, gamma_decay_every=25,
                      max_step=20.0, initial_step=1e-3)
    crit = StoppingCriteria(tol_rel_dual=1e-5 if args.quick else 1e-6,
                            check_every=50)
    gamma = torch.tensor(cfg.gamma, device=dev)
    rows, failures = {}, []

    def run(name, obj):
        blocks = ", ".join(f"{k}[{v.start}:{v.stop}]"
                           for k, v in obj.row_slices().items())
        t0 = time.perf_counter()
        res = Maximizer(cfg).maximize(obj, criteria=crit)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        dual = float(res.stats.dual_obj[-1])
        infeas = float(res.stats.infeas[-1])
        print(f"{name:>14}: λ = [{blocks}]")
        print(f"{'':>14}  {res.iterations_run} iters in {dt:.1f}s "
              f"({res.stop_reason.value}), dual {dual:.3f}, infeas "
              f"{infeas:.2e}")
        usage = obj.global_usage(res.lam, gamma)
        for label, (used, limit) in usage.items():
            print(f"{'':>14}  coupling row {label}: {used:.2f} / {limit:.2f}"
                  f" ({'binding' if used > 0.95 * limit else 'slack'})")
        if not res.converged:
            failures.append(name)
        print()
        rows[name] = {
            "iterations_run": res.iterations_run,
            "stop_reason": res.stop_reason.value,
            "converged": bool(res.converged), "seconds": dt,
            "dual_final": dual, "infeas_final": infeas,
            "usage": {k: [float(u), float(l)] for k, (u, l) in usage.items()},
            "binding": {k: bool(u > 0.95 * l)
                        for k, (u, l) in usage.items()}}
        return res

    results = {}
    for name in formulations.names():
        obj = formulations.make_objective(name, lp, ax_mode="aligned",
                                          row_norm=True)
        results[name] = (obj, run(name, obj))

    # encore: multi_budget's caps BELOW matching's unconstrained usage, so
    # that both coupling rows bite (capacity + count + spend caps at once)
    m_obj, m_res = results["matching"]
    xs = m_obj.primal(m_res.lam, gamma)
    count_used = sum(float(x.sum()) for x in xs)
    value_used = -float(m_res.stats.primal_obj[-1])   # c = −value
    tight = formulations.make_objective(
        "multi_budget", lp,
        params=dict(count_cap=0.5 * count_used, value_cap=0.75 * value_used),
        ax_mode="aligned", row_norm=True)
    res_t = run("multi_budget*", tight)
    usage = tight.global_usage(res_t.lam, gamma)
    print(f"(*caps tightened to 50% count / 75% value of matching's "
          f"unconstrained usage {count_used:.1f} / {value_used:.1f} — "
          f"both rows now bind)")
    bind = all(used > 0.9 * lim for used, lim in usage.values())
    result = {"example": "formulations_tour", "device": str(dev),
              "sources": I, "destinations": J, "families": lp.m,
              "edges": edges, "formulations": rows,
              "matching_usage": [count_used, value_used],
              "tightened_bind": bool(bind), "not_converged": failures,
              "launches": launches_since(before)}
    if failures:
        fail(f"NOT CONVERGED: {', '.join(failures)}")
    if not bind:
        fail(f"tightened caps did not bind: {usage}")
    print("all formulations converged through the one shared engine")
    return emit(result, args)


if __name__ == "__main__":
    main()
