"""LP solve launcher of the port:
`python -m repro_torch.launch.solve [--sources N ...]`.

Counterpart of `python -m repro.launch.solve`: generate the instance,
validate it, and build the `--formulation`'s objective: for `matching`
(the default) row-normalize the whole LP (§5.1) and solve it distributed
over every rank (`core.distributed.solve_distributed`: each rank its row
block of the slabs, one all-reduce a step; `--lambda-sharded` splits λ
over the grid's "model" axis), as the reference CLI does; for any other
registered formulation compile it from the un-preconditioned LP with the
row normalization folded in, and solve it on this rank's device.  Then
run the `--algorithm` update rule (agd, pga, pdhg, bb) through the
chunked engine with the `--ax-mode` Ax reduction (default: the x-carry
aligned path), and with `--certify` extract a repaired primal witness and
print the duality-gap certificate over the formulation's constraint
families, over the whole preconditioned LP; `--export-primal DIR` writes
x*(λ) there as `.npz` decision shards (`primal.write_shards`), which an
`AllocationServer` over the same λ reproduces row by row.  `--json`
prints one result object with the reference's keys (logs move to
stderr).  Runs on the card
by default and raises when there is none; `--device cpu` runs the plain
versions.

Ranks: started plainly it is one rank with no process group; under
`python -m torch.distributed.run --nproc-per-node N -m
repro_torch.launch.solve ...` it runs N ranks (NCCL, one card a rank, or
gloo with `--device cpu`) on a (N, 1) grid of axes ("data", "model").
Rank 0 alone logs, prints the result and the certificate, and writes
every file (duals, checkpoints).

Repeated solves: `--save-duals` writes λ with the γ it reached and the
instance's fingerprint; `--warm-start` starts from such a dump and skips
γ-continuation when the dump reached the target γ on this instance.
Fault tolerance (DESIGN.md §9): `--health-guard` (with `--max-retries`)
rolls a bad chunk back; `--checkpoint-dir` saves the solver state every
`--checkpoint-every` iterations and on SIGTERM/SIGINT, and `--resume`
continues from the latest checkpoint, refusing one written for another
instance or another rule.  Under ranks the files hold the whole λ and
state, whatever the number of ranks that wrote them: every rank reads
them and keeps its own part.

Observability (DESIGN.md §11, §13): every line of output goes through a
leveled `Telemetry` logger (`--log-level`; stderr under `--json`).
`--log-jsonl PATH` also records the structured run log (the manifest
with the launch census as `byte_census`, an `execute` and a `host` span a
chunk, check/γ/health/memory events, the metrics digest) for `python -m
repro_torch.launch.report PATH`; `--profile-dir` writes a torch.profiler
trace of a window of chunks; `--metrics-port` serves `/metrics` during
the run; `--max-host-rss-mb` is the host-memory soft guard.  Under ranks
rank 0 alone records.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import json
import signal
import sys
import time
import uuid
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..convert import lp_to_torch
from ..obs import (LEVELS, REGISTRY, JsonlSink, MemorySampler,
                   MetricsExporter, ProfilerHook, Telemetry)
from ..core import (DistributedMatchingObjective, HealthConfig, InstanceSpec,
                    LPValidationError, MatchingObjective, Maximizer,
                    SolveConfig, StopReason, StoppingCriteria, generate,
                    get_rule, precondition, rule_names, validate_lp)
from .. import formulations
from . import census
from .mesh import init_ranks, make_grid


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


def save_duals(path: str, lam, gamma: Optional[float] = None,
               fingerprint: Optional[str] = None) -> None:
    """Write a dual solution to .npz (key 'lam'), with the γ the solve
    reached and the instance fingerprint, as the reference does."""
    extra = {}
    if gamma is not None:
        extra["achieved_gamma"] = np.float64(gamma)
    if fingerprint is not None:
        extra["fingerprint"] = np.asarray(fingerprint)
    if isinstance(lam, torch.Tensor):
        lam = lam.detach().cpu().numpy()
    np.savez(path, lam=np.asarray(lam), **extra)


def load_duals(path: str, expected_shape=None, with_meta: bool = False):
    """Load a `save_duals` dump as a host numpy array, checking its shape;
    `with_meta` also returns {"achieved_gamma", "fingerprint"} where
    present.  A corrupt dump raises ValueError naming the path."""
    try:
        with np.load(path) as z:
            if "lam" not in z.files:
                raise ValueError(
                    f"duals file {path} has no 'lam' array (keys: "
                    f"{sorted(z.files)}); not a --save-duals dump")
            lam = z["lam"]
            meta = {}
            if "achieved_gamma" in z:
                meta["achieved_gamma"] = float(z["achieved_gamma"])
            if "fingerprint" in z:
                meta["fingerprint"] = str(z["fingerprint"])
    except (FileNotFoundError, ValueError):
        raise
    except Exception as e:
        raise ValueError(
            f"duals file {path} is unreadable ({e}); the dump is corrupt "
            f"or truncated — re-run the producing solve with --save-duals"
        ) from e
    if expected_shape is not None and tuple(lam.shape) != tuple(expected_shape):
        raise ValueError(
            f"warm-start duals at {path} have shape {lam.shape}, but this "
            f"solve needs {tuple(expected_shape)} (different instance or "
            f"formulation?)")
    return (lam, meta) if with_meta else lam


def apply_warm_start_policy(cfg: SolveConfig, meta: dict, fingerprint: str):
    """Whether a warm start may skip γ-continuation: only when the dump
    reached this solve's target γ on the same instance.  Returns
    (config, skipped, reason), with the reference's reason strings."""
    continuation = (cfg.gamma_init is not None
                    and cfg.gamma_init > cfg.gamma)
    if not continuation:
        return cfg, False, "no continuation configured"
    g = meta.get("achieved_gamma")
    if g is None:
        return cfg, False, "dump has no achieved-gamma metadata"
    fp = meta.get("fingerprint")
    if fp is not None and fp != fingerprint:
        return cfg, False, "instance fingerprint mismatch"
    if g > cfg.gamma * (1.0 + 1e-6):
        return (cfg, False,
                f"dump stopped at gamma={g:.4g} > target {cfg.gamma:.4g}")
    cfg = dataclasses.replace(cfg, gamma_init=None,
                              adaptive_continuation=False)
    return cfg, True, (f"duals already at gamma={g:.4g} on this instance; "
                       f"continuation skipped")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.solve")
    ap.add_argument("--sources", type=int, default=100_000)
    ap.add_argument("--destinations", type=int, default=1_000)
    ap.add_argument("--nnz-per-row", type=float, default=None)
    ap.add_argument("--formulation", default="matching",
                    choices=formulations.names(),
                    help="registered LP formulation (DESIGN.md §5); "
                         "'matching' row-normalizes and solves the LP "
                         "directly, the others compile onto the same solve "
                         "loop")
    ap.add_argument("--ax-mode", default="aligned",
                    choices=["scatter", "sorted", "aligned",
                             "aligned_gvals"],
                    help="Ax reduction layout (default: aligned, the "
                         "value-carrying x-only path; aligned_gvals is the "
                         "gvals-based aligned lowering; scatter the "
                         "scatter-add baseline).  With --formulation "
                         "matching sorted runs as scatter, as the "
                         "reference CLI maps it")
    ap.add_argument("--algorithm", default="agd", choices=rule_names(),
                    help="dual update rule: agd (the paper's accelerated "
                         "ascent), pdhg (restarted primal-dual), bb "
                         "(spectral step), pga (plain ascent)")
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
                    help="source rows per extraction chunk for "
                         "--export-primal/--certify")
    ap.add_argument("--export-primal", default=None, metavar="DIR",
                    help="after the solve, write x*(lambda) to DIR as .npz "
                         "decision shards, one per --chunk-rows block")
    ap.add_argument("--save-duals", default=None, metavar="PATH",
                    help="write the final lambda to PATH (.npz) after the "
                         "solve")
    ap.add_argument("--warm-start", default=None, metavar="PATH",
                    help="start from a --save-duals dump; continuation is "
                         "skipped when the dump reached the target gamma "
                         "on this instance")
    ap.add_argument("--health-guard", action="store_true",
                    help="check the chunk's health every --check-every "
                         "iterations; roll back and retry with smaller "
                         "steps on NaN/Inf or divergence")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="health-guard retries of a bad chunk before the "
                         "stop reason 'diverged'")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="save the solver state to DIR at chunk boundaries; "
                         "SIGTERM/SIGINT saves a final checkpoint")
    ap.add_argument("--checkpoint-every", type=int, default=100,
                    help="minimum iterations between checkpoints")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in "
                         "--checkpoint-dir (bit for bit the uninterrupted "
                         "run at matched chunk boundaries)")
    ap.add_argument("--json", action="store_true",
                    help="print one machine-readable result object to "
                         "stdout (all logs move to stderr)")
    ap.add_argument("--lambda-sharded", action="store_true",
                    help="split lambda's destinations over the grid's "
                         "'model' axis (all-gather it before the sweep, "
                         "reduce-scatter Ax after); --formulation matching "
                         "only")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the solve runs (default: the card; under "
                         "torch.distributed.run, cuda:LOCAL_RANK)")
    # observability (DESIGN.md §11)
    ap.add_argument("--log-jsonl", default=None, metavar="PATH",
                    help="append the structured run log (manifest, spans, "
                         "check/γ/health events) to PATH as JSON lines; "
                         "render it with `python -m "
                         "repro_torch.launch.report`")
    ap.add_argument("--log-level", default="info", choices=sorted(LEVELS),
                    help="console verbosity; the JSONL log always carries "
                         "the full stream")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the chunk "
                         "window [--profile-start-chunk, "
                         "+--profile-num-chunks) to DIR (opt-in; needs a "
                         "chunked solve)")
    ap.add_argument("--profile-start-chunk", type=int, default=0,
                    help="first chunk index inside the profiler trace")
    ap.add_argument("--profile-num-chunks", type=int, default=1,
                    help="number of chunks the profiler trace spans")
    # resource observability (DESIGN.md §13)
    ap.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT",
                    help="serve live Prometheus /metrics on PORT for the "
                         "duration of the solve (counters, histograms, "
                         "memory gauges; 0 binds an ephemeral port)")
    ap.add_argument("--max-host-rss-mb", type=float, default=None,
                    metavar="MB",
                    help="soft host-memory guard: warn (and emit a flagged "
                         "`memory` event) when this process's RSS crosses "
                         "MB MiB — the measurement hook for the "
                         "larger-than-RSS out-of-core gate")
    return ap


class Outcome(NamedTuple):
    """What one run produced: the printed result and, for callers in the
    same process, the objects behind it."""

    result: dict
    objective: object        # one rank: its MatchingObjective (the whole
                             # LP); several: the DistributedMatchingObjective
    lam: torch.Tensor        # the whole λ
    gamma: float
    generate_seconds: float  # host generation and validation
    setup_seconds: float     # preconditioning, placement, plan packing
    solve_seconds: float     # the solve loop alone, synchronised
    certify_seconds: float   # extraction and certificate (0 without)
    rank: int = 0


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


def solve_config(args):
    """The SolveConfig and StoppingCriteria the flags describe.  Adaptive
    continuation, the health guard, checkpoints and the profiler run
    chunked even with no tolerance, so they get criteria for the
    --check-every cadence."""
    continuation = args.continuation or args.adaptive_continuation
    cfg = SolveConfig(
        iterations=args.iterations, gamma=args.gamma,
        gamma_init=(16 * args.gamma if continuation else None),
        adaptive_continuation=args.adaptive_continuation,
        max_step=1e-1 if not args.no_precondition else 1e-3,
        initial_step=1e-5)
    criteria = None
    if (args.tol_infeas is not None or args.tol_rel_dual is not None
            or args.max_seconds is not None or args.adaptive_continuation
            or args.health_guard or args.checkpoint_dir
            or args.profile_dir):
        criteria = StoppingCriteria(
            tol_infeas=args.tol_infeas, tol_rel_dual=args.tol_rel_dual,
            max_seconds=args.max_seconds, check_every=args.check_every)
    return cfg, criteria


class _Checkpoints:
    """`--checkpoint-dir` / `--resume`: the manager, the restored state,
    and the engine's checkpoint and preempt hooks (SIGTERM/SIGINT stop the
    loop at the next chunk boundary; the engine's final call saves)."""

    def __init__(self, args, fingerprint: str, device, log, writes: bool):
        self.args = args
        self.fingerprint = fingerprint
        self.log = log
        self.writes = writes     # rank 0 alone writes; every rank reads
        self.mgr = CheckpointManager(args.checkpoint_dir, keep_last=3)
        self.state = None
        self.meta = None
        self.last_saved = None
        self.signal_num = None
        self._handlers = {}
        if args.resume:
            self._restore(device)

    def _restore(self, device):
        args = self.args
        step = self.mgr.latest_step()
        if step is None:
            self.log(f"--resume: no checkpoint in {args.checkpoint_dir}; "
                     f"starting fresh")
            return
        flat, extra = self.mgr.restore_flat(step)
        ck_fp = extra.get("fingerprint")
        if ck_fp is not None and ck_fp != self.fingerprint:
            raise SystemExit(
                f"--resume refused: checkpoint step {step} in "
                f"{args.checkpoint_dir} was written for a different "
                f"instance (fingerprint {ck_fp[:12]}.. != this run's "
                f"{self.fingerprint[:12]}..).  Re-run with the original "
                f"generation flags (--sources/--destinations/--nnz-per-row/"
                f"--seed) or point --checkpoint-dir at an empty directory.")
        ck_alg = extra.get("algorithm")
        if ck_alg is not None and ck_alg != args.algorithm:
            raise SystemExit(
                f"--resume refused: checkpoint step {step} in "
                f"{args.checkpoint_dir} was written by update rule "
                f"{ck_alg!r}, but this run uses {args.algorithm!r} (the "
                f"solver state layouts differ).  Re-run with --algorithm "
                f"{ck_alg} or point --checkpoint-dir at an empty directory.")
        self.state = get_rule(args.algorithm).state_from_flat(flat, device)
        self.meta = {"gamma_now": extra.get("gamma_now"),
                     "g_prev": extra.get("g_prev")}
        self.log(f"resumed from checkpoint step {step} in "
                 f"{args.checkpoint_dir} (gamma_now={extra.get('gamma_now')})")

    def save(self, it, state, meta):
        """The engine's checkpoint_fn: every healthy chunk boundary and a
        final call at exit; saves at most every --checkpoint-every
        iterations, and always at the final call.  `state` is whole; every
        rank keeps the same count, rank 0 alone writes."""
        if it == self.last_saved:
            return
        if (not meta.get("final") and self.last_saved is not None
                and it - self.last_saved < self.args.checkpoint_every):
            return
        self.last_saved = it
        if not self.writes:
            return
        self.mgr.save(it, state, extra={
            "it": int(it), "gamma_now": float(meta["gamma_now"]),
            "g_prev": (None if meta["g_prev"] is None
                       else float(meta["g_prev"])),
            "algorithm": meta.get("algorithm", self.args.algorithm),
            "fingerprint": self.fingerprint})
        self.log(f"checkpoint saved: step {it} -> {self.args.checkpoint_dir}")

    def preempted(self) -> bool:
        return self.signal_num is not None

    def _on_signal(self, signum, frame):
        self.signal_num = signum
        self.log(f"received signal {signum}; checkpointing at next chunk "
                 f"boundary")

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._handlers[sig] = signal.signal(sig, self._on_signal)
        return self

    def __exit__(self, *exc):
        for sig, handler in self._handlers.items():
            signal.signal(sig, handler)


def _quiet(msg):
    """The log of a rank other than 0."""


def run(args, log=print, instance: Optional[Instance] = None,
        telemetry: Optional[Telemetry] = None, profiler=None,
        sampler=None) -> Outcome:
    """One solve as the flags describe, on this process's rank
    (`mesh.init_ranks`).  `instance`, when given, is the flags' instance
    generated once by `generate_instance`, so that several runs in one
    process pay the host generation once.

    Output goes to `log`, or with `telemetry` through it (info, warning
    and error records).  `telemetry`, `profiler` and `sampler` default to
    off.  Rank 0 alone logs and records."""
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")
    ranks = init_ranks(args.device)
    device, lead = ranks.device, ranks.rank == 0
    tel = (telemetry if telemetry is not None and lead
           else Telemetry.disabled())
    warn = error = log
    if telemetry is not None:
        log, warn, error = tel.info, tel.warning, tel.error
    if not lead:
        log = warn = error = _quiet
        sampler = None
        if args.formulation != "matching":
            profiler = None   # the distributed solve disarms its own
    if instance is None:
        with tel.span("generate", sources=args.sources,
                      destinations=args.destinations):
            instance = generate_instance(args, log)
    lp_np, generate_seconds = instance
    cfg, criteria = solve_config(args)

    def on_check(rec):
        if args.verbose_checks:
            log(f"  it {rec.it:6d}  dual {rec.dual_obj:.6f}  "
                f"rel_dual {rec.rel_dual:.2e}  infeas {rec.infeas:.2e}  "
                f"gamma {rec.gamma:.4f}  {rec.elapsed:.1f}s")

    fingerprint = instance_fingerprint(lp_np)
    tel.manifest(
        fingerprint=fingerprint, formulation=args.formulation,
        algorithm=args.algorithm, sources=args.sources,
        destinations=args.destinations, seed=args.seed,
        gamma=cfg.gamma, gamma_init=cfg.gamma_init,
        adaptive_continuation=cfg.adaptive_continuation,
        iterations_cap=args.iterations,
        check_every=(criteria.check_every if criteria else None),
        config=dataclasses.asdict(cfg), ax_mode=args.ax_mode,
        device=str(device), ranks=ranks.world,
        device_name=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else None))
    health = (HealthConfig(max_retries=args.max_retries)
              if args.health_guard else None)
    ckpt = (_Checkpoints(args, fingerprint, device, log, writes=lead)
            if args.checkpoint_dir else None)
    t0 = time.perf_counter()
    # the objective's build records its `row_norm` and `ax_plan` spans
    # into the run log
    with tel.activate():
        if args.formulation == "matching":
            # the whole LP on the host, preconditioned on every rank before
            # each keeps its row block, as the reference does
            lp = lp_to_torch(lp_np, "cpu")
            if not args.no_precondition:
                lp, _ = precondition(lp, row_norm=True)
            # the distributed objective has no "sorted" mode (its permutation
            # would cross shard boundaries), and the reference CLI runs scatter
            ax_mode = "scatter" if args.ax_mode == "sorted" else args.ax_mode
            grid = make_grid((ranks.world, 1), ("data", "model"))
            # solve_distributed in its two steps: the objective is kept for the
            # certificate, and set-up and solve loop are timed apart
            obj = DistributedMatchingObjective(
                lp, grid, proj_kind=cfg.projection,
                lambda_axis="model" if args.lambda_sharded else None,
                ax_mode=ax_mode, device=device)
            dual_shape = (lp.m, lp.num_destinations)
            sharded = (", lambda sharded on model" if args.lambda_sharded
                       else "")
            log(f"ranks: {ranks.world} on a ({ranks.world}, 1) grid (data, "
                f"model){sharded}; rank 0 holds "
                f"{sum(s.n for s in obj.lp.slabs)} source rows")
        else:
            ax_mode = args.ax_mode
            form = formulations.build(args.formulation, lp_np)
            obj = formulations.compile_formulation(
                form, lp_to_torch(lp_np, device), ax_mode=ax_mode,
                row_norm=not args.no_precondition)
            dual_shape = obj.dual_shape
            slices = {k: f"{v.start}:{v.stop}"
                      for k, v in obj.row_slices().items()}
            log(f"formulation '{args.formulation}': {obj.dual_shape[0]} dual "
                f"rows ({slices})")
    del lp_np, instance
    lam0 = None
    if args.warm_start and (ckpt is None or ckpt.state is None):
        lam_np, meta = load_duals(args.warm_start, dual_shape,
                                  with_meta=True)
        lam0 = torch.as_tensor(lam_np, dtype=torch.float32, device=device)
        cfg, skipped, why = apply_warm_start_policy(cfg, meta, fingerprint)
        if skipped:
            log(f"warm start: {why}")
            tel.event("resolve", outcome="accept", reason=why)
        elif cfg.gamma_init is not None and cfg.gamma_init > cfg.gamma:
            warn(f"WARNING: --warm-start with --continuation re-runs the γ "
                 f"schedule from gamma_init and will march the loaded λ "
                 f"away from its optimum ({why})")
            tel.event("resolve", outcome="reject", reason=why)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_solve = time.perf_counter()
    hooks = dict(telemetry=tel, profiler=profiler, sampler=sampler)
    if ckpt is not None:
        hooks.update(checkpoint_fn=ckpt.save, preempt_fn=ckpt.preempted,
                     initial_state=ckpt.state, resume_meta=ckpt.meta)
    with ckpt if ckpt is not None else contextlib.nullcontext():
        if isinstance(obj, DistributedMatchingObjective):
            res = obj.solve(cfg, args.algorithm, lam0=lam0,
                            criteria=criteria, diagnostics_fn=on_check,
                            health=health, **hooks)
        else:
            res = Maximizer(cfg, algorithm=args.algorithm).maximize(
                obj, initial_value=lam0, criteria=criteria,
                diagnostics_fn=on_check, health=health, **hooks)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_end = time.perf_counter()
    dt = t_end - t0
    d = res.stats.dual_obj
    reason = res.stop_reason.value if res.stop_reason else "?"
    log(f"{res.iterations_run} iterations ({args.algorithm}, ax_mode "
        f"{ax_mode}) in {dt:.2f}s "
        f"({dt / max(res.iterations_run, 1) * 1e3:.1f} ms/iter, set-up "
        f"included); stop reason: {reason}")
    for rec in res.health:
        warn(f"  health: it {rec.it} {rec.status} -> {rec.action} "
             f"(retry {rec.retries}, step_scale {rec.step_scale:.3g}, "
             f"gamma {rec.gamma:.4g})")
    if res.stop_reason == StopReason.DIVERGED:
        error("solve DIVERGED: health-guard retries exhausted; the duals "
              "are the last state that passed the health checks")
    if d.size:
        log(f"dual {d[0]:.3f} -> {d[-1]:.3f}; "
            f"infeas {float(res.stats.infeas[-1]):.3e}; "
            f"gamma {float(res.stats.gamma[-1]):.4f}")
    if res.stop_reason == StopReason.PREEMPTED:
        warn(f"preempted at iteration {res.iterations_run}; resume with "
             f"--resume --checkpoint-dir {args.checkpoint_dir}")
    gamma_last = float(res.stats.gamma[-1]) if d.size else cfg.gamma
    result = {
        "run_id": tel.run_id if tel.enabled else uuid.uuid4().hex[:12],
        "formulation": args.formulation,
        "algorithm": args.algorithm,
        "iterations_run": int(res.iterations_run),
        "stop_reason": reason,
        "wall_s": dt,
        "ms_per_iteration": dt / max(res.iterations_run, 1) * 1e3,
        "fingerprint": fingerprint,
        "gamma_final": gamma_last,
        "health_events": len(res.health),
    }
    if d.size:
        result.update(dual_obj_first=float(d[0]), dual_obj_final=float(d[-1]),
                      infeas_final=float(res.stats.infeas[-1]))
    if args.save_duals:
        if lead:
            save_duals(args.save_duals, res.lam, gamma=gamma_last,
                       fingerprint=fingerprint)
        log(f"saved duals -> {args.save_duals} (gamma={gamma_last:.4g}, "
            f"fingerprinted)")
        result["saved_duals"] = args.save_duals
    if args.log_jsonl and lead:
        # one evaluation's bytes, operations and collective bytes on this
        # rank, from the objective that ran the solve
        with tel.span("census"):
            tel.manifest(byte_census=census.evaluation_census(obj))
    if isinstance(obj, DistributedMatchingObjective):
        # one rank holds the whole LP: its own objective serves the
        # certificate and the caller; several: rank 0 builds one below
        obj = obj.local if ranks.world == 1 else obj
    t_cert = time.perf_counter()
    extract = args.export_primal or args.certify
    if extract and res.stop_reason == StopReason.PREEMPTED:
        warn("skipping primal export/certification: solve was preempted "
             "mid-trajectory (resume it to completion first)")
    elif extract and lead:
        from ..primal import certify, format_certificate, write_shards
        serve = obj
        if isinstance(obj, DistributedMatchingObjective):
            # over the whole preconditioned LP, as the reference does
            serve = MatchingObjective(lp_to_torch(lp, device),
                                      ax_mode=args.ax_mode)
        gamma_final = np.float32(gamma_last)
        if args.export_primal:
            t_x = time.perf_counter()
            with tel.span("export_primal"):
                paths = write_shards(serve, res.lam, gamma_final,
                                     args.export_primal,
                                     chunk_rows=args.chunk_rows,
                                     sampler=sampler)
            dt_x = time.perf_counter() - t_x
            n_src = sum(s.n for s in serve.lp.slabs)
            log(f"exported {len(paths)} decision shards ({n_src} sources) "
                f"-> {args.export_primal} in {dt_x:.1f}s "
                f"({n_src / max(dt_x, 1e-9):.0f} sources/s)")
            result["export_shards"] = len(paths)
        t_cert = time.perf_counter()
        if args.certify:
            with tel.span("certify"):
                cert = certify(serve, res.lam, gamma_final,
                               chunk_rows=args.chunk_rows, sampler=sampler)
            log(format_certificate(cert))
            result["certificate_valid"] = bool(cert.valid)
    certify_seconds = time.perf_counter() - t_cert
    if sampler is not None:
        # the extraction's and certificate's samples join the engine's
        # watermarks; the run's peaks go to the manifest and the result
        marks = sampler.watermarks()
        tel.manifest(**marks)
        result["peak_rss_bytes"] = marks["peak_rss_bytes"]
        result["peak_hbm_bytes"] = marks["peak_hbm_bytes"]
        if marks["peak_rss_bytes"]:
            log(f"peak host RSS {marks['peak_rss_bytes'] / 2**20:.0f} MiB "
                f"over {marks['memory_samples']} samples")
    return Outcome(result=result, objective=obj, lam=res.lam,
                   gamma=gamma_last, generate_seconds=generate_seconds,
                   setup_seconds=t_solve - t0, solve_seconds=t_end - t_solve,
                   certify_seconds=certify_seconds, rank=ranks.rank)


def main(argv: Optional[list] = None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.lambda_sharded and args.formulation != "matching":
        ap.error("--lambda-sharded is only supported with --formulation "
                 "matching (composed formulations solve on a single "
                 "replicated λ)")
    lead = init_ranks(args.device).rank == 0
    # --json owns stdout: exactly one JSON object; every log line (and the
    # full record stream, with --log-jsonl) goes elsewhere.  Rank 0 alone
    # records; the other ranks run quiet.
    tel = Telemetry.disabled()
    sampler = registry = exporter = None
    # every rank takes the profiler: it makes the loop chunked, and the
    # ranks must chunk alike; the distributed solve lets rank 0 record
    profiler = (ProfilerHook(args.profile_dir,
                             start_chunk=args.profile_start_chunk,
                             num_chunks=args.profile_num_chunks)
                if args.profile_dir else None)
    if lead:
        tel = Telemetry(
            sink=JsonlSink(args.log_jsonl) if args.log_jsonl else None,
            level=args.log_level,
            stream=sys.stderr if args.json else sys.stdout)
        tel.manifest(argv=list(sys.argv[1:] if argv is None else argv))
        # the sampler rides along whenever something reads it: the run log
        # (memory events, manifest watermarks), /metrics or the RSS guard;
        # otherwise the solve makes no resource read at all
        if (args.log_jsonl or args.metrics_port is not None
                or args.max_host_rss_mb is not None):
            registry = REGISTRY
            sampler = MemorySampler(
                registry=registry, telemetry=tel,
                max_host_rss_bytes=(int(args.max_host_rss_mb * 2**20)
                                    if args.max_host_rss_mb is not None
                                    else None),
                device=init_ranks(args.device).device)
        if args.metrics_port is not None:
            exporter = MetricsExporter(registry, args.metrics_port)
            tel.info(f"serving /metrics on {exporter.url}")
    try:
        outcome = run(args, telemetry=tel, profiler=profiler,
                      sampler=sampler)
        if registry is not None:
            # the registry's digest: the series /metrics served, in the log
            tel.event("metrics", series=registry.summary())
        if args.json and outcome.rank == 0:
            print(json.dumps(outcome.result, sort_keys=True), flush=True)
        result = outcome.result
    finally:
        outcome = None
        if exporter is not None:
            exporter.close()
        tel.close()
        if dist.is_initialized():
            # the objective's subgroups go first: one left to the exit's
            # teardown, after the default group, can abort the process
            gc.collect()
            dist.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
