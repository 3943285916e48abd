"""Matching-LP solve launcher of the port:
`python -m repro_torch.launch.solve [--sources N ...]`.

Counterpart of `python -m repro.launch.solve --formulation matching` on one
device: generate the instance, validate it, row-normalize it (§5.1), run
the agd dual ascent through the chunked engine with the `--ax-mode` Ax
reduction (default: the x-carry aligned path), and with `--certify`
extract a repaired primal witness and print the duality-gap certificate.
`--json` prints one result object with the reference's keys (logs move to
stderr).  Runs on the card by default and raises when there is none;
`--device cpu` runs the plain versions.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
import uuid
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..convert import lp_to_torch, resolve_device
from ..core import (InstanceSpec, LPValidationError, MatchingObjective,
                    Maximizer, SolveConfig, StopReason, StoppingCriteria,
                    generate, precondition, validate_lp)


def instance_fingerprint(lp) -> str:
    """Deterministic digest of an LP instance (shapes + rhs + objective),
    byte for byte the reference's `instance_fingerprint`."""
    h = hashlib.sha256()
    h.update(repr((int(lp.m), int(lp.num_destinations),
                   tuple((int(s.n), int(s.width))
                         for s in lp.slabs))).encode())
    h.update(np.ascontiguousarray(np.asarray(lp.b)).tobytes())
    for s in lp.slabs:
        h.update(np.ascontiguousarray(np.asarray(s.c_vals)).tobytes())
    return h.hexdigest()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.solve")
    ap.add_argument("--sources", type=int, default=100_000)
    ap.add_argument("--destinations", type=int, default=1_000)
    ap.add_argument("--nnz-per-row", type=float, default=None)
    ap.add_argument("--ax-mode", default="aligned",
                    choices=["scatter", "sorted", "aligned",
                             "aligned_gvals"],
                    help="Ax reduction layout (default: aligned, the "
                         "value-carrying x-only path; aligned_gvals is the "
                         "gvals-based aligned lowering; scatter the "
                         "scatter-add baseline).  sorted runs as scatter, "
                         "as the reference CLI maps it")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--iterations", type=int, default=200,
                    help="iteration cap (exact count when no tolerance is set)")
    ap.add_argument("--gamma", type=float, default=0.01)
    ap.add_argument("--continuation", action="store_true")
    ap.add_argument("--adaptive-continuation", action="store_true",
                    help="decay gamma on stall instead of on the fixed "
                         "schedule (implies --continuation)")
    ap.add_argument("--no-precondition", action="store_true")
    ap.add_argument("--tol-infeas", type=float, default=None,
                    help="stop when ||(Ax-b)+|| <= TOL (absolute)")
    ap.add_argument("--tol-rel-dual", type=float, default=None,
                    help="stop when |dg|/max(1,|g|) <= TOL between checks")
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="wall-clock cap, checked every --check-every iters")
    ap.add_argument("--check-every", type=int, default=25,
                    help="iterations per chunk between host-side "
                         "convergence checks")
    ap.add_argument("--verbose-checks", action="store_true",
                    help="print the diagnostics stream (one line per check)")
    ap.add_argument("--certify", action="store_true",
                    help="after the solve, extract+repair a feasible primal "
                         "witness and print the duality-gap certificate")
    ap.add_argument("--chunk-rows", type=int, default=4096,
                    help="source rows per extraction chunk for --certify")
    ap.add_argument("--json", action="store_true",
                    help="print one machine-readable result object to "
                         "stdout (all logs move to stderr)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the solve runs (default: the card)")
    return ap


class Outcome(NamedTuple):
    """What one run produced: the printed result and, for callers in the
    same process, the objects behind it."""

    result: dict
    objective: MatchingObjective
    lam: torch.Tensor
    gamma: float
    generate_seconds: float  # host generation and validation
    setup_seconds: float     # transfer, preconditioning, plan packing
    solve_seconds: float     # the solve loop alone, synchronised
    certify_seconds: float   # extraction and certificate (0 without)


class Instance(NamedTuple):
    """A generated, validated instance (host numpy leaves) and what its
    generation took."""

    lp: object
    seconds: float


def generate_instance(args, log=print) -> Instance:
    """Generate and validate the instance the flags describe."""
    spec = InstanceSpec(
        num_sources=args.sources, num_destinations=args.destinations,
        avg_nnz_per_row=args.nnz_per_row or max(args.sources * 0.001, 8),
        seed=args.seed)
    t_gen = time.perf_counter()
    lp_np = generate(spec)
    try:
        validate_lp(lp_np, name="instance")
    except LPValidationError as e:
        raise SystemExit(f"generated instance failed validation:\n{e}")
    seconds = time.perf_counter() - t_gen
    log(f"generated {args.sources}x{args.destinations} in {seconds:.1f}s")
    return Instance(lp_np, seconds)


def run(args, log=print, instance: Optional[Instance] = None) -> Outcome:
    """One solve as the flags describe.  `instance`, when given, is the
    flags' instance generated once by `generate_instance`, so that several
    runs in one process pay the host generation once."""
    device = resolve_device(args.device)
    if instance is None:
        instance = generate_instance(args, log)
    lp_np, generate_seconds = instance
    continuation = args.continuation or args.adaptive_continuation
    cfg = SolveConfig(
        iterations=args.iterations, gamma=args.gamma,
        gamma_init=(16 * args.gamma if continuation else None),
        adaptive_continuation=args.adaptive_continuation,
        max_step=1e-1 if not args.no_precondition else 1e-3,
        initial_step=1e-5)
    criteria = None
    if (args.tol_infeas is not None or args.tol_rel_dual is not None
            or args.max_seconds is not None or args.adaptive_continuation):
        criteria = StoppingCriteria(
            tol_infeas=args.tol_infeas, tol_rel_dual=args.tol_rel_dual,
            max_seconds=args.max_seconds, check_every=args.check_every)

    def on_check(rec):
        if args.verbose_checks:
            log(f"  it {rec.it:6d}  dual {rec.dual_obj:.6f}  "
                f"rel_dual {rec.rel_dual:.2e}  infeas {rec.infeas:.2e}  "
                f"gamma {rec.gamma:.4f}  {rec.elapsed:.1f}s")

    fingerprint = instance_fingerprint(lp_np)
    t0 = time.perf_counter()
    lp = lp_to_torch(lp_np, device)
    del lp_np, instance
    if not args.no_precondition:
        lp, _ = precondition(lp, row_norm=True)
    # the reference CLI's matching path has no "sorted" mode (its
    # permutation would cross shard boundaries) and runs scatter for it
    ax_mode = "scatter" if args.ax_mode == "sorted" else args.ax_mode
    obj = MatchingObjective(lp, ax_mode=ax_mode)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_solve = time.perf_counter()
    res = Maximizer(cfg).maximize(obj, criteria=criteria,
                                  diagnostics_fn=on_check)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_end = time.perf_counter()
    dt = t_end - t0
    d = res.stats.dual_obj
    reason = res.stop_reason.value if res.stop_reason else "?"
    log(f"{res.iterations_run} iterations (agd, ax_mode {ax_mode}) in "
        f"{dt:.2f}s "
        f"({dt / max(res.iterations_run, 1) * 1e3:.1f} ms/iter, set-up "
        f"included); stop reason: {reason}")
    if d.size:
        log(f"dual {d[0]:.3f} -> {d[-1]:.3f}; "
            f"infeas {float(res.stats.infeas[-1]):.3e}; "
            f"gamma {float(res.stats.gamma[-1]):.4f}")
    gamma_last = float(res.stats.gamma[-1]) if d.size else cfg.gamma
    result = {
        "run_id": uuid.uuid4().hex[:12],
        "formulation": "matching",
        "algorithm": "agd",
        "iterations_run": int(res.iterations_run),
        "stop_reason": reason,
        "wall_s": dt,
        "ms_per_iteration": dt / max(res.iterations_run, 1) * 1e3,
        "fingerprint": fingerprint,
        "gamma_final": gamma_last,
        "health_events": 0,
    }
    if d.size:
        result.update(dual_obj_first=float(d[0]), dual_obj_final=float(d[-1]),
                      infeas_final=float(res.stats.infeas[-1]))
    t_cert = time.perf_counter()
    if args.certify:
        from ..primal import certify, format_certificate
        cert = certify(obj, res.lam, np.float32(gamma_last),
                       chunk_rows=args.chunk_rows)
        log(format_certificate(cert))
        result["certificate_valid"] = bool(cert.valid)
    return Outcome(result=result, objective=obj, lam=res.lam,
                   gamma=gamma_last, generate_seconds=generate_seconds,
                   setup_seconds=t_solve - t0, solve_seconds=t_end - t_solve,
                   certify_seconds=time.perf_counter() - t_cert)


def main(argv: Optional[list] = None) -> dict:
    args = build_parser().parse_args(argv)
    out = sys.stderr if args.json else sys.stdout

    def log(msg):
        print(msg, file=out, flush=True)

    result = run(args, log).result
    if args.json:
        print(json.dumps(result, sort_keys=True), flush=True)
    return result


if __name__ == "__main__":
    main()
