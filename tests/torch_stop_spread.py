"""Where allocation_server's solve stops, in the reference's two paths and
in the port, over instance seeds.

    PYTHONPATH=src python tests/torch_stop_spread.py \
        [--sources 5000] [--destinations 200] [--tol 1e-6] \
        [--seeds 11 1 2 3] [--paths ref ref_pallas port] [--jobs 4]

The solve is the example's (`examples/allocation_server.py::_solve`): the
multi_budget formulation, aligned, row-normalized, agd at max_step 20,
tol_rel_dual checked every 50 iterations, 4,000 iterations at most.  Paths:
`ref` the reference's plain sweep (its CPU default), `ref_pallas` the
reference's kernel path (`use_pallas=True`, the Pallas kernels in interpret
mode: the path the port's kernels translate), `port` the port on the CPU.
Each (path, seed) runs in a process of its own, JAX on the CPU, one
thread; the table gives the stop, whether it converged, the final dual and
the last check's relative change.  The defaults are the example's default
size: the reference's plain sweep stops at 1,850, its kernel path and the
port run to the cap.
"""
import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def solve(path, sources, destinations, seed, tol):
    spec = dict(num_sources=sources, num_destinations=destinations,
                avg_nnz_per_row=10, seed=seed, num_families=2)
    cfg = dict(iterations=4000, gamma=0.05, gamma_init=0.8,
               gamma_decay_every=25, max_step=20.0, initial_step=1e-3)
    if path == "port":
        import torch
        from repro_torch import formulations
        from repro_torch.convert import lp_to_torch
        from repro_torch.core import (InstanceSpec, Maximizer, SolveConfig,
                                      StoppingCriteria, generate)
        torch.set_num_threads(1)
        lp = lp_to_torch(generate(InstanceSpec(**spec)), "cpu")
        kw = {}
    else:
        import jax
        import jax.numpy as jnp
        from repro import formulations
        from repro.core import (InstanceSpec, Maximizer, SolveConfig,
                                StoppingCriteria, generate)
        lp = jax.tree.map(jnp.asarray, generate(InstanceSpec(**spec)))
        kw = {"use_pallas": path == "ref_pallas"}
    obj = formulations.make_objective("multi_budget", lp, ax_mode="aligned",
                                      row_norm=True, **kw)
    res = Maximizer(SolveConfig(**cfg)).maximize(
        obj, criteria=StoppingCriteria(tol_rel_dual=tol, check_every=50))
    return {"path": path, "seed": seed, "sources": sources,
            "destinations": destinations, "tol": tol,
            "iterations_run": res.iterations_run,
            "converged": bool(res.converged),
            "dual_final": float(res.stats.dual_obj[-1]),
            "rel_dual_last": float(res.diagnostics[-1].rel_dual)}


def run_one(path, args, seed):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false")
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--one", path,
         "--sources", str(args.sources), "--destinations",
         str(args.destinations), "--tol", str(args.tol), "--seeds",
         str(seed)], env=env, cwd=ROOT, capture_output=True, text=True,
        check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sources", type=int, default=5000)
    ap.add_argument("--destinations", type=int, default=200)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--seeds", type=int, nargs="+", default=[11, 1, 2, 3])
    ap.add_argument("--paths", nargs="+", default=["ref", "ref_pallas",
                                                   "port"])
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(solve(args.one, args.sources, args.destinations,
                               args.seeds[0], args.tol)))
        return
    cases = [(p, s) for s in args.seeds for p in args.paths]
    with ThreadPoolExecutor(args.jobs) as pool:
        rows = list(pool.map(lambda c: run_one(c[0], args, c[1]), cases))
    print(f"{'seed':>5} {'path':>10} {'stop':>5} {'converged':>9} "
          f"{'final dual':>14} {'last rel':>9}")
    for r in rows:
        print(f"{r['seed']:>5} {r['path']:>10} {r['iterations_run']:>5} "
              f"{str(r['converged']):>9} {r['dual_final']:>14.4f} "
              f"{r['rel_dual_last']:>9.2e}")
    for r in rows:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
