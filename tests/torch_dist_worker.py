"""One rank of the port's multi-process tests (`test_torch_distributed.py`):

    python tests/torch_dist_worker.py CASE RANK WORLD STORE OUT SPEC

brings up a gloo group of WORLD ranks over the FileStore at STORE (no
TCP port, so that test workers running side by side never meet), runs
CASE with the JSON SPEC on the test instance (50 x 10, nu = 10, seed 7,
row-normalized), writes `OUT/rank<RANK>.npz` and tears the group down.
`test_torch_census.py` runs its `observed` case.
Imports torch and the port only.
"""
import datetime
import gc
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.convert import lp_to_torch  # noqa: E402
from repro_torch.core import (DistributedMatchingObjective, InstanceSpec,  # noqa: E402
                              SolveConfig, StoppingCriteria, generate,
                              precondition, solve_distributed)
from repro_torch.launch.mesh import init_ranks, make_grid  # noqa: E402

# the reference test's solve, and the same at the step cap at which the
# two packages' float32 trajectories stay together (test_torch_distributed)
CONFIGS = {"cfg": dict(iterations=200, gamma=0.1, max_step=10.0,
                       initial_step=1e-3),
           "small": dict(iterations=200, gamma=0.1, max_step=0.05,
                         initial_step=1e-3)}
CFG = CONFIGS["cfg"]


def make_lp():
    spec = InstanceSpec(num_sources=50, num_destinations=10,
                        avg_nnz_per_row=10, seed=7)
    return precondition(lp_to_torch(generate(spec), "cpu"), row_norm=True)[0]


def trajectories(lp, grid, spec, rank):
    """Each config's and ax mode's dual trajectory and final λ, each other
    rule's trajectory at the small step cap, and this rank's block of
    x*(λ) at the first mode's final λ under CFG, with its block index."""
    out = {}
    for name, cfg in CONFIGS.items():
        for mode in spec["modes"]:
            res = solve_distributed(lp, SolveConfig(**cfg), grid,
                                    lambda_axis=spec.get("lambda_axis"),
                                    ax_mode=mode)
            out[f"dual_{name}_{mode}"] = res.stats.dual_obj
            out[f"lam_{name}_{mode}"] = res.lam.numpy()
    for rule in spec.get("rules", ()):
        res = solve_distributed(lp, SolveConfig(**CONFIGS["small"]), grid,
                                lambda_axis=spec.get("lambda_axis"),
                                algorithm=rule, ax_mode="aligned")
        out[f"dual_rule_{rule}"] = res.stats.dual_obj
    obj = DistributedMatchingObjective(lp, grid,
                                       lambda_axis=spec.get("lambda_axis"),
                                       ax_mode=spec["modes"][0])
    lam = torch.as_tensor(out[f"lam_cfg_{spec['modes'][0]}"])
    # λ-sharded, from the rank's own columns of λ, gathered inside (a
    # collective: every rank takes the same path)
    xs = obj.primal(obj.shard_lam(lam), torch.tensor(CFG["gamma"]))
    for i, x in enumerate(xs):
        out[f"x{i}"] = x.numpy()
    out["block"] = np.array(grid.index(obj.source_axes))
    return out


def preempt(lp, grid, spec, rank):
    """agd in chunks of 10, rank 1 alone asked to stop at its 4th poll."""
    polls = [0]

    def preempt_fn():
        polls[0] += 1
        return rank == 1 and polls[0] >= 4

    res = solve_distributed(lp, SolveConfig(**CFG), grid, ax_mode="aligned",
                            criteria=StoppingCriteria(check_every=10),
                            preempt_fn=preempt_fn)
    return {"iterations": np.array(res.iterations_run),
            "reason": np.array(res.stop_reason.value),
            "lam": res.lam.numpy()}


def checkpoint(lp, grid, spec, rank):
    """100 iterations with the λ axis split, a checkpoint of the whole
    state written by rank 0 alone at the end, and the whole final state
    returned."""
    mgr = CheckpointManager(spec["dir"]) if rank == 0 else None

    def save(it, state, meta):
        if mgr is not None and meta["final"]:
            mgr.save(it, state, extra={"gamma_now": meta["gamma_now"],
                                       "g_prev": meta["g_prev"]})

    cfg = SolveConfig(**dict(CFG, iterations=100))
    res = solve_distributed(lp, cfg, grid, lambda_axis="model",
                            ax_mode="aligned",
                            criteria=StoppingCriteria(check_every=25),
                            checkpoint_fn=save)
    st = res.final_state
    return {f"state{i}": t.numpy() for i, t in enumerate(st[:-1])}


def observed(lp, grid, spec, rank):
    """agd in chunks of 10 twice on the same objective, bare and with a
    recording telemetry, a sampler and a profiler on every rank: rank 0
    records, the others get none of them; the `agree` collective runs once
    a chunk boundary on every rank either way.  Returns both runs' λ, the
    records and samples on this rank, the agree calls of the observed
    run, this rank's launch census and the counts it is reckoned from."""
    from repro_torch.launch.census import evaluation_census
    from repro_torch.obs import ListSink, MemorySampler, ProfilerHook, Telemetry
    obj = DistributedMatchingObjective(lp, grid,
                                       lambda_axis=spec.get("lambda_axis"),
                                       ax_mode="aligned")
    cfg = SolveConfig(**dict(CFG, iterations=40))
    crit = StoppingCriteria(tol_grad_norm=0.0, check_every=10)
    bare = obj.solve(cfg, criteria=crit)
    calls = [0]
    agree = obj.agree

    def counting(flags):
        calls[0] += 1
        return agree(flags)

    obj.agree = counting
    sink = ListSink()
    sampler = MemorySampler()
    prof = ProfilerHook(spec["dir"], start_chunk=1, num_chunks=1)
    seen = obj.solve(cfg, criteria=crit,
                     telemetry=Telemetry(sink=sink,
                                         stream=open(os.devnull, "w")),
                     profiler=prof, sampler=sampler)
    local = obj.local
    slabs, plan = local.lp.slabs, local._plan
    return {"lam_bare": bare.lam.numpy(), "lam_seen": seen.lam.numpy(),
            "records": np.array(len(sink.records)),
            "samples": np.array(sampler.watermarks()["memory_samples"]),
            "traces": np.array(len(prof.trace_paths)),
            "agree_calls": np.array(calls[0]),
            "census": np.array(json.dumps(evaluation_census(obj))),
            "slab_real": np.array(sum(int(s.mask.sum()) for s in slabs)),
            "slab_padded": np.array(sum(s.n * s.width for s in slabs)),
            "slab_rows": np.array(sum(s.n for s in slabs)),
            "plan_real": np.array(sum(int(b.mask.sum())
                                      for b in plan.buckets)),
            "plan_entries": np.array(sum(b.mask.numel()
                                         for b in plan.buckets)),
            "plan_rows": np.array(sum(b.dest_ids.numel()
                                      for b in plan.buckets))}


def main():
    case, rank, world, store, out_dir, spec = sys.argv[1:]
    rank, world, spec = int(rank), int(world), json.loads(spec)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        run(case, rank, world, out_dir, spec)
    finally:
        # run() let go of every subgroup; one that outlives the default
        # group is torn down at exit, where gloo may abort the process
        gc.collect()
        dist.destroy_process_group()


def run(case, rank, world, out_dir, spec):
    ranks = init_ranks("cpu")
    assert ranks.grouped and ranks.world == world, ranks
    grid = make_grid(spec["shape"], spec["axes"])
    result = {"trajectories": trajectories, "preempt": preempt,
              "checkpoint": checkpoint, "observed": observed}[case](make_lp(), grid, spec, rank)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **result)


if __name__ == "__main__":
    main()
