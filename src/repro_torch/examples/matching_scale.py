"""End-to-end run of the paper's own workload; the port of the
reference's `examples/matching_scale.py`:

  Appendix-B instance -> Jacobi row-normalization -> γ continuation ->
  AGD dual ascent -> the dual trajectory,

then the same solve through the distributed path
(`core.distributed.solve_distributed`) on a process group of this
process's ranks, checking that the trajectories agree (paper Figs. 1-2).

    PYTHONPATH=src python -m repro_torch.examples.matching_scale [--sources 100000]

Started plainly, the group is one rank of this process (NCCL on the card,
gloo on the CPU), brought up here and destroyed at exit; a group that is
already up (torchrun, a caller) is used as it is, on a (world, 1) grid.
"""
import gc
import time

import numpy as np
import torch
import torch.distributed as dist

from ..convert import lp_to_torch, resolve_device
from ..core import (InstanceSpec, MatchingObjective, Maximizer, SolveConfig,
                    generate, precondition, solve_distributed)
from ..launch.mesh import make_grid
from ._common import emit, fail, launch_counts, launches_since, parser


def _one_rank_group(dev: torch.device) -> bool:
    """Bring up a one-rank group in this process unless one is up; True
    when this call brought it up (and its caller must destroy it)."""
    if dist.is_initialized():
        return False
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    return True


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--sources", type=int, default=100_000)
    ap.add_argument("--destinations", type=int, default=2_000)
    ap.add_argument("--iterations", type=int, default=300)
    ap.add_argument("--ax-mode", default="aligned",
                    choices=["scatter", "sorted", "aligned",
                             "aligned_gvals"],
                    help="Ax reduction layout (DESIGN.md §3); 'aligned' is "
                         "the x-carry path (K1 + K2), 'aligned_gvals' its "
                         "gvals-based predecessor (K3 + K4)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    before = launch_counts()

    spec = InstanceSpec(num_sources=args.sources,
                        num_destinations=args.destinations,
                        avg_nnz_per_row=max(args.sources * 0.001, 8),
                        seed=42)
    t0 = time.perf_counter()
    lp = lp_to_torch(generate(spec), dev)
    edges = sum(int(s.mask.sum()) for s in lp.slabs)
    t_gen = time.perf_counter() - t0
    print(f"instance: {args.sources} x {args.destinations}, {edges} edges, "
          f"generated in {t_gen:.1f}s")

    lp_pc, _ = precondition(lp, row_norm=True)
    cfg = SolveConfig(iterations=args.iterations, gamma=0.01,
                      gamma_init=0.16, gamma_decay_every=25,   # paper Fig. 5
                      max_step=1e-1, initial_step=1e-5)
    obj = MatchingObjective(lp_pc, ax_mode=args.ax_mode)
    t0 = time.perf_counter()
    res = Maximizer(cfg).maximize(obj)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    d = np.asarray(res.stats.dual_obj, np.float64)
    print(f"solve: {dt:.2f}s total, {dt / cfg.iterations * 1e3:.1f} ms/iter")
    infeas = float(res.stats.infeas[-1])
    print(f"dual objective {d[0]:.2f} -> {d[-1]:.2f}; "
          f"infeasibility {infeas:.3e}")
    del obj

    # the distributed path on this process's ranks
    owned = _one_rank_group(dev)
    try:
        grid = make_grid((dist.get_world_size(), 1), ("data", "model"))
        t0 = time.perf_counter()
        res_d = solve_distributed(
            lp_pc, cfg, grid,
            ax_mode=args.ax_mode if args.ax_mode != "sorted" else "scatter")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt_d = time.perf_counter() - t0
        d_d = np.asarray(res_d.stats.dual_obj, np.float64)
        world = dist.get_world_size()
        del grid, res_d
    finally:
        if owned:
            gc.collect()       # the objective's groups go first
            dist.destroy_process_group()
    rel = float((np.abs(d_d - d) / np.abs(d)).max())
    print(f"distributed-vs-reference max rel err: {rel:.2e} "
          f"(paper criterion < 1e-2)")
    result = {"example": "matching_scale", "device": str(dev),
              "sources": args.sources, "destinations": args.destinations,
              "edges": edges, "ax_mode": args.ax_mode,
              "generate_seconds": t_gen, "solve_seconds": dt,
              "ms_per_iteration": dt / cfg.iterations * 1e3,
              "distributed_seconds": dt_d, "ranks": world,
              "iterations_run": res.iterations_run,
              "dual_first": float(d[0]), "dual_final": float(d[-1]),
              "dual_trajectory": d.tolist(),
              "distributed_trajectory": d_d.tolist(),
              "infeas_final": infeas, "distributed_rel_err": rel,
              "launches": launches_since(before)}
    if not rel < 1e-2:
        fail(f"distributed and single-device duals differ by {rel:.2e} "
             f"relative (criterion < 1e-2)")
    return emit(result, args)


if __name__ == "__main__":
    main()
