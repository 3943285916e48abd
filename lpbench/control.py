"""The readings that the limits of a cell's check are set from, at the
cell's own size, on the card:

    python3 -m lpbench.control --workload <cell> --seeds 1 2 ... \
        --control-seeds 1 2 3 [--out readings.jsonl]

For each of --seeds, --solves cold solves of the program as the window
makes them (the first --solves starts of that seed's run) and the
check's numbers on each answer (the lower readings).  For each of
--control-seeds, the control: the reference's evaluation computed in
bfloat16 (inputs rounded to bfloat16, float32 sums), put in the place of
the program's objective under the program's engine, from the run's first
start, and the same numbers on its answer (the upper readings).  One JSON
line a reading; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import run
from .instance import instance, to_port_lp
from .reference.check import judge
from .reference.lp import ControlObjective, ReferenceLP


def program_readings(config, traffic, raw, seed, solves, device) -> list:
    lp = to_port_lp(raw, config["instance"]["min_width"])
    obj = run.build_objective(config, lp)
    del lp
    out = []
    for k in range(solves):
        lam0 = run.start(obj, traffic, seed, k, device)
        res, dt = run.solve_once(obj, run.settings(config), config["rule"],
                                 lam0)
        gamma = float(res.stats.gamma[-1])
        _, grad, _ = obj.calculate(res.lam, torch.tensor(
            gamma, dtype=torch.float32, device=device))
        ans = {"lam": res.lam, "dual": float(res.stats.dual_obj[-1]),
               "gamma": gamma, "grad": grad.reshape(-1).clone()}
        out.append((ans, {"solve": k, "iterations": int(res.iterations_run),
                          "stop": res.stop_reason.value, "solve_s": dt}))
    del obj, res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def control_reading(config, traffic, raw, seed, dual_rows) -> tuple:
    low = ReferenceLP(raw, config, dtype=torch.bfloat16, acc=torch.float32,
                      bisect_steps=40)
    obj = ControlObjective(low, (dual_rows,) if config["coupling_rows"]
                           else (low.m, low.J))
    lam0 = run.start(obj, traffic, seed, 0, raw.src.device)
    from repro_torch.core.maximizer import Maximizer
    cfg, criteria = run.settings(config)
    t0 = time.perf_counter()
    res = Maximizer(cfg, algorithm=config["rule"]).maximize(
        obj, initial_value=lam0, criteria=criteria)
    dt = time.perf_counter() - t0
    gamma = float(res.stats.gamma[-1])
    _, grad, _ = obj.calculate(res.lam, gamma)
    ans = {"lam": res.lam, "dual": float(res.stats.dual_obj[-1]),
           "gamma": gamma, "grad": grad.reshape(-1).clone()}
    out = {"iterations": int(res.iterations_run),
           "stop": res.stop_reason.value, "solve_s": dt}
    del obj, low
    gc.collect()
    torch.cuda.empty_cache()
    return ans, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--solves", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    _, cell, config, traffic = run.load_cell(args.workload)
    if not torch.cuda.is_available():
        run.log("the readings are taken on a CUDA card")
        return 2
    run.use_program()
    from repro_torch.kernels import _build
    _build.build()
    device = torch.device("cuda:0")
    out = open(args.out, "a") if args.out else None
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t0 = time.perf_counter()
        raw = instance(config["instance"], seed, device)
        ref = ReferenceLP(raw, config)
        dual_rows = ref.num_rows
        readings = []
        if seed in args.seeds:
            readings += [("program", ans, info) for ans, info in
                         program_readings(config, traffic, raw, seed,
                                          args.solves, device)]
        if seed in args.control_seeds:
            ans, info = control_reading(config, traffic, raw, seed,
                                        dual_rows)
            readings.append(("control", ans, info))
        for side, ans, info in readings:
            rec = {"cell": cell["name"], "seed": seed, "side": side,
                   **info, **judge(ref, [ans]),
                   "seconds": time.perf_counter() - t0}
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        del raw, ref
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
