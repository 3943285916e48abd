"""Maximizer — dual ascent of g(λ) over λ >= 0 (paper §5, Appendix B);
port of `repro.core.maximizer`.

The solve loop is convergence-controlled (DESIGN.md §4): the hot path is a
chunk of `check_every` steps during which nothing crosses to the host —
λ, the momentum state, the step and γ are device tensors and each step's
`IterStats` stay on the device.  At the chunk boundary the chunk's stats
are copied to the host once, and a host controller evaluates the
`StoppingCriteria` and, with `SolveConfig.adaptive_continuation`, decays γ
on stall.  With no criteria and no fault-tolerance hook the engine runs
one chunk of the full iteration count.  The chunk is the counterpart of
the reference's jitted `lax.scan`.

Fault tolerance (DESIGN.md §9): with a `HealthConfig` each chunk is
classified from its trailing stats and, with `check_lambda`, from one
finiteness flag per `rule.health_arrays` tensor, appended to the same
stats copy (a chunk still makes one host read).  A bad chunk rolls back
to the last good snapshot and retries with backed-off steps; exhausted
retries stop DIVERGED.  `checkpoint_fn`, `preempt_fn`, `initial_state`
and `resume_meta` give checkpoint/resume.

Observability (DESIGN.md §11, §13): a `Telemetry` gets the reference's
records (solve_start/solve_end, an `execute` and a `host` span a chunk,
check/gamma/health/checkpoint/memory events, the chunk, iteration and
rollback counters); a `ProfilerHook` traces a window of chunks; a
`MemorySampler` is read at every chunk boundary.  A chunk is enqueued
eagerly, so with a recording telemetry the `execute` span waits for the
card (one `torch.cuda.synchronize` a chunk) and the `host` span then
times the chunk boundary's host work: the stats copy and everything the
controller decides from it, up to the next chunk's enqueue or the
loop's exit.  A recording telemetry also gets a `solve` span around the
whole solve (made the thread's `obs.telemetry.current()` recorder for
its duration, so the kernel wrappers' `launch` spans land in it), a
`step` span around each `rule.step` and a `calculate` span around each
evaluation, the `solve.evaluations` counter and the solve's
`kernels.<wrapper>.launches` deltas.  With the defaults (telemetry
disabled, no sampler, no profiler) the engine makes no extra sync, host
read or event, and every hook leaves the trajectory bit for bit as it
was.

Under several ranks (`core.distributed`) every rank runs this loop, and
every host decision must come out the same on each, or the next
collective hangs.  The stopping test and the health verdict read stats
that are all-reduced (ring all-reduce in NCCL and gloo leaves the same
bits on every rank), so they agree by construction; the preempt signal,
the wall clock and, with λ sharded, the finiteness flags are each rank's
own, and `agree` makes them common with one small collective a chunk.
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.telemetry import Telemetry
from .types import (ConvergenceCheck, HealthConfig, HealthRecord, IterStats,
                    SolveConfig, SolveResult, SolveState, StopReason,
                    StoppingCriteria)
from .update_rules import LOCAL, DualReduce, UpdateRule, gamma_at, get_rule


def _copy_state(state: SolveState) -> SolveState:
    """A fresh buffer for every leaf, `extra` included: the snapshot must
    not share a tensor with the live state."""
    extra = state.extra    # () or the rule's NamedTuple of tensors
    if extra:
        extra = type(extra)(*(t.clone() for t in extra))
    return SolveState(*(t.clone() for t in state[:-1]), extra=extra)


def _classify_chunk(health: HealthConfig, arrays_finite: bool, g: float,
                    infeas: float, grad_norm: float, gamma_cur: float,
                    snap_g: Optional[float], snap_grad: Optional[float],
                    snap_gamma: Optional[float]) -> Optional[str]:
    """Health verdict for one chunk: None if healthy, else the fault kind.
    The scalar checks read the chunk's trailing stats; `arrays_finite`
    (the rule's `health_arrays` swept on the device, read in the chunk's
    one copy) catches a NaN from the last update, which the trailing
    stats, taken before it, cannot see."""
    if not (math.isfinite(g) and math.isfinite(infeas)
            and math.isfinite(grad_norm)):
        return "nonfinite"
    if health.check_lambda and not arrays_finite:
        return "nonfinite"
    if (snap_grad is not None
            and grad_norm > health.grad_explosion * max(snap_grad, 1.0)):
        return "grad_explosion"
    # g moves legitimately when γ moves, so the regression rule compares
    # only chunks that ended at the same γ
    if (snap_g is not None and snap_gamma is not None
            and gamma_cur == snap_gamma
            and g < snap_g - health.obj_regression_tol
            * max(1.0, abs(snap_g))):
        return "regression"
    return None


def _to_host(stats: torch.Tensor,
             arrays: Sequence[torch.Tensor]) -> Tuple[IterStats, bool]:
    """The chunk's one device-to-host copy: the (6, n) stats and, when
    `arrays` is not empty, one finiteness flag per array appended to
    them.  Returns the host IterStats and whether every array is
    finite."""
    if not arrays:
        return IterStats(*stats.cpu().numpy()), True
    flags = torch.stack([torch.isfinite(a).all() for a in arrays])
    host = torch.cat([stats.reshape(-1),
                      flags.to(torch.float32)]).cpu().numpy()
    n = stats.numel()
    return (IterStats(*host[:n].reshape(stats.shape)),
            bool(host[n:].all()))


def _sync(dev: torch.device) -> None:
    """Wait for the card's work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class SolveEngine:
    """The one convergence-controlled solve loop (DESIGN.md §4)."""

    def __init__(self, calculate: Callable, config: SolveConfig,
                 algorithm: str = "agd", reduce: DualReduce = LOCAL,
                 agree: Optional[Callable] = None):
        """`reduce` takes the rule's reductions over the dual vector (the
        shards' sum when λ is sharded); `agree(flags) -> flags`, given
        under several ranks, makes a chunk boundary's host flags the same
        on every rank (a MAX over the ranks)."""
        self.calculate = calculate
        self.config = config
        self.algorithm = algorithm
        self.rule: UpdateRule = get_rule(algorithm)
        self.reduce = reduce
        self.agree = agree
        # fault-injection seam (DESIGN.md §9): when set, called after every
        # chunk as `hook(it_start, state, stats) -> (state, stats)` with the
        # chunk's stats still on the device.  Never set in production.
        self.chunk_fault_hook = None
        # the chunk lengths whose memory estimate went out (the reference
        # builds one runner a length; eager PyTorch has none to build)
        self._estimated = set()

    def _note_runner(self, length: int, state: SolveState, tel: Telemetry,
                     sampler) -> None:
        """Once a distinct chunk length, with a sampler: the runner's
        memory estimate from the launch census (tensor shapes only, no
        device read), folded into the run's peak and emitted as the
        reference's `compiled_memory` event."""
        if sampler is None or length in self._estimated:
            return
        self._estimated.add(length)
        from ..obs.memory import compiled_memory_estimate
        est = compiled_memory_estimate(
            getattr(self.calculate, "__self__", None), state, length)
        if est:
            sampler.note_compiled(est)
            tel.event("event", kind="compiled_memory", chunk_len=length,
                      **est)

    def _run_chunk(self, state: SolveState, length: int,
                   gamma: Optional[torch.Tensor], tel: Telemetry = None,
                   calculate: Optional[Callable] = None):
        """`length` steps with no host synchronisation; returns the new
        state and the chunk's stats as one (6, length) float32 device
        tensor.  `gamma` fixes γ for the chunk (adaptive mode); None
        follows the scheduled continuation from the carried counter.
        With a recording `tel` each step runs in a `step` span and calls
        `calculate` (the engine's spanned evaluation) in its place."""
        config = self.config
        if gamma is None:
            def gamma_fn(st):
                return gamma_at(config, st.it)
        else:
            def gamma_fn(st):
                return gamma
        rows = []
        if tel is None:
            for _ in range(length):
                state, st = self.rule.step(self.calculate, config, gamma_fn,
                                           state, self.reduce)
                rows.append(torch.stack([t.to(torch.float32).reshape(())
                                         for t in st]))
        else:
            for _ in range(length):
                with tel.span("step"):
                    state, st = self.rule.step(calculate, config, gamma_fn,
                                               state, self.reduce)
                rows.append(torch.stack([t.to(torch.float32).reshape(())
                                         for t in st]))
        return state, torch.stack(rows, dim=1)

    def _spanned(self, tel: Telemetry, evaluations: list) -> Callable:
        """The objective's `calculate` in a `calculate` span, counting
        each call into `evaluations[0]`."""
        calculate = self.calculate

        def spanned(lam, gamma):
            evaluations[0] += 1
            with tel.span("calculate"):
                return calculate(lam, gamma)
        return spanned

    def solve(self, lam0: Optional[torch.Tensor],
              criteria: Optional[StoppingCriteria] = None,
              diagnostics_fn: Optional[Callable] = None,
              infeas_scale: float = 1.0,
              health: Optional[HealthConfig] = None,
              checkpoint_fn: Optional[Callable] = None,
              preempt_fn: Optional[Callable] = None,
              initial_state: Optional[SolveState] = None,
              resume_meta: Optional[dict] = None,
              telemetry: Optional[Telemetry] = None,
              profiler=None, sampler=None) -> SolveResult:
        """Run the solve loop.  Beyond the criteria and diagnostics:

          health         HealthConfig: the per-chunk guard (rollback with
                         backoff, DIVERGED when retries run out);
          checkpoint_fn  `fn(it, state, meta)` after every healthy chunk
                         and once more at exit (`meta["final"] = True`);
                         `meta` holds what `resume_meta` needs;
          preempt_fn     `fn() -> bool` polled at every chunk boundary;
                         True stops the loop PREEMPTED;
          initial_state  a restored SolveState: the loop continues from
                         state.it, bit for bit the uninterrupted run;
          resume_meta    the checkpoint's meta ("gamma_now", "g_prev");
          telemetry      a `repro_torch.obs.Telemetry` (module doc);
                         None is `Telemetry.disabled()`;
          profiler       a `repro_torch.obs.ProfilerHook`, stopped in a
                         finally block, so an aborted solve still writes
                         its trace;
          sampler        a `repro_torch.obs.MemorySampler`: one `memory`
                         event a chunk boundary, the per-runner estimate
                         once a chunk length, the watermarks in the
                         manifest at the end.

        Any of health/checkpoint_fn/preempt_fn/initial_state/profiler
        forces the chunked path (the profiler's window is counted in
        chunks; the reference's engine ignores a profiler on its fast
        path).  Under several ranks (`agree` set), the preempt
        poll, the wall-clock cap and the finiteness flags are made common
        at each chunk boundary by one collective; the preempt poll then
        stops the loop at the next boundary."""
        tel = telemetry if telemetry is not None else Telemetry.disabled()
        seq = tel.next_solve()
        with tel.activate(), tel.span("solve", solve=seq):
            return self._solve(lam0, criteria, diagnostics_fn, infeas_scale,
                               health, checkpoint_fn, preempt_fn,
                               initial_state, resume_meta, tel, seq,
                               profiler, sampler)

    def _solve(self, lam0, criteria, diagnostics_fn, infeas_scale, health,
               checkpoint_fn, preempt_fn, initial_state, resume_meta,
               tel: Telemetry, seq: int, profiler, sampler) -> SolveResult:
        """The solve loop of `solve`, in its `solve` span."""
        config = self.config
        total = config.iterations
        if criteria is not None and criteria.max_iterations is not None:
            total = criteria.max_iterations
        adaptive = (config.adaptive_continuation
                    and config.gamma_init is not None
                    and config.gamma_init > config.gamma)
        guarded = (health is not None or checkpoint_fn is not None
                   or preempt_fn is not None or initial_state is not None
                   or profiler is not None)
        chunked = guarded or (total > 0 and (
            adaptive or (criteria is not None and criteria.needs_checks)))
        if initial_state is not None:
            state = _copy_state(initial_state)
            dev = state.lam.device
        else:
            state = self.rule.init_state(lam0, config)
            dev = lam0.device
        # the recording loop body's arguments, and the counts it keeps
        spans, evaluations, launches0 = (), [0], None
        if tel.enabled:
            from ..kernels import launch_counts  # kernels imports core
            launches0 = launch_counts()
            spans = (tel, self._spanned(tel, evaluations))
            tel.event("solve_start", algorithm=self.algorithm,
                      iterations_cap=total, chunked=chunked,
                      start_it=(int(initial_state.it)
                                if initial_state is not None else 0),
                      gamma=config.gamma, gamma_init=config.gamma_init,
                      adaptive_continuation=adaptive, solve=seq)

        def _counted() -> None:
            """The solve's evaluations and kernel launches, as counters."""
            if launches0 is None:
                return
            tel.counter("solve.evaluations", evaluations[0])
            from ..kernels import launch_counts
            for name, n in launch_counts().items():
                if n > launches0[name]:
                    tel.counter(f"kernels.{name}.launches",
                                n - launches0[name])

        if not chunked:
            # one chunk of the full count, no host read until its end
            t0 = time.perf_counter()
            self._note_runner(total, state, tel, sampler)
            with tel.span("execute", chunk=0, it=0, n=total):
                state, stats = self._run_chunk(state, total, None, *spans)
                if tel.enabled:
                    _sync(dev)
            stats = _to_host(stats, ())[0]
            tel.counter("solve.chunks")
            tel.counter("solve.iterations", total)
            _counted()
            if sampler is not None:
                s = sampler.sample(where="solve", it=total)
                tel.event("memory", it=total, chunk=0,
                          **sampler.event_fields(s))
                tel.manifest(**sampler.watermarks())
            tel.event("solve_end",
                      stop_reason=StopReason.MAX_ITERATIONS.value,
                      iterations_run=total, converged=False,
                      wall_s=time.perf_counter() - t0, checks=0,
                      health_incidents=0, solve=seq,
                      evaluations=evaluations[0])
            return SolveResult(lam=state.lam, stats=stats,
                               iterations_run=total, converged=False,
                               stop_reason=StopReason.MAX_ITERATIONS,
                               final_state=state)

        criteria = criteria if criteria is not None else StoppingCriteria()
        check = max(1, int(criteria.check_every))
        gamma_now = float(config.gamma_init) if adaptive else config.gamma
        g_prev = None
        it_done = 0
        if initial_state is not None:
            it_done = int(initial_state.it)
            meta = resume_meta or {}
            if meta.get("gamma_now") is not None:
                gamma_now = float(meta["gamma_now"])
            if meta.get("g_prev") is not None:
                g_prev = float(meta["g_prev"])
        sweep = health is not None and health.check_lambda
        t0 = time.perf_counter()
        stats_chunks = []
        diags = deque(maxlen=config.max_diagnostics)
        health_recs = []
        converged = False
        stop_reason = StopReason.MAX_ITERATIONS
        # the last good snapshot and its baselines (health guard)
        snap = _copy_state(state) if health is not None else None
        snap_it = it_done
        snap_gamma_now = gamma_now
        snap_g_prev = g_prev
        snap_g = snap_grad = snap_gamma = None
        fails = 0

        def _meta(final: bool) -> dict:
            meta = {"gamma_now": gamma_now, "g_prev": g_prev,
                    "it": it_done, "final": final}
            meta.update(self.rule.checkpoint_meta())
            return meta

        def _polled() -> bool:
            return preempt_fn is not None and bool(preempt_fn())

        agree = self.agree
        # under ranks: the preempt poll agreed at the last chunk boundary
        # (here at the start, before any chunk has run)
        preempt_agreed = (agree([_polled(), False, False])[0]
                          if agree is not None else False)
        chunk_idx = 0
        # the open `host` span of the last chunk boundary
        host = None
        try:
            while it_done < total:
                if preempt_agreed if agree is not None else _polled():
                    stop_reason = StopReason.PREEMPTED
                    break
                n = min(check, total - it_done)
                gamma_arr = (torch.full((), gamma_now, dtype=torch.float32,
                                        device=dev) if adaptive else None)
                self._note_runner(n, state, tel, sampler)
                if profiler is not None:
                    profiler.chunk_start(chunk_idx, tel, device=dev)
                if host is not None:
                    host.__exit__(None, None, None)
                    host = None
                with tel.span("execute", chunk=chunk_idx, it=it_done, n=n):
                    state, dev_stats = self._run_chunk(state, n, gamma_arr,
                                                       *spans)
                    if tel.enabled:
                        # the chunk is enqueued eagerly: wait here so the
                        # span measures the card's work, not the enqueue
                        _sync(dev)
                if self.chunk_fault_hook is not None:
                    state, st = self.chunk_fault_hook(it_done, state,
                                                      IterStats(*dev_stats))
                    dev_stats = torch.stack(list(st))
                # the chunk's one device-to-host copy and what the
                # controller decides from it: one span, closed at the
                # next chunk's enqueue or the loop's exit
                host = tel.span("host", chunk=chunk_idx, it=it_done)
                host.__enter__()
                stats, arrays_finite = _to_host(
                    dev_stats,
                    self.rule.health_arrays(state) if sweep else ())
                g = float(stats.dual_obj[-1])
                infeas = float(stats.infeas[-1])
                grad_norm = float(stats.grad_norm[-1])
                gamma_cur = float(stats.gamma[-1])
                elapsed = time.perf_counter() - t0
                if profiler is not None:
                    profiler.chunk_end(chunk_idx, tel)
                if sampler is not None:
                    # host-only reads at the chunk boundary, no collective
                    s = sampler.sample(where="chunk", it=it_done + n)
                    tel.event("memory", it=it_done + n, chunk=chunk_idx,
                              **sampler.event_fields(s))
                chunk_idx += 1
                tel.counter("solve.chunks")
                out_of_time = (criteria.max_seconds is not None
                               and elapsed >= criteria.max_seconds)
                if agree is not None:
                    preempt_agreed, out_of_time, nonfinite = agree(
                        [_polled(), out_of_time, not arrays_finite])
                    arrays_finite = not nonfinite

                if health is not None:
                    status = _classify_chunk(health, arrays_finite, g,
                                             infeas, grad_norm, gamma_cur,
                                             snap_g, snap_grad, snap_gamma)
                    if status is not None:
                        fails += 1
                        scale = health.step_backoff ** fails
                        action = ("giveup" if fails > health.max_retries
                                  else "rollback")
                        rec = HealthRecord(
                            it=it_done + n, status=status, action=action,
                            retries=fails, dual_obj=g, grad_norm=grad_norm,
                            gamma=gamma_cur, rolled_back_to=snap_it,
                            step_scale=scale)
                        health_recs.append(rec)
                        tel.event("health", **rec._asdict())
                        if action == "giveup":
                            state = _copy_state(snap)
                            gamma_now = snap_gamma_now
                            g_prev = snap_g_prev
                            stop_reason = StopReason.DIVERGED
                            break
                        tel.counter("solve.rollbacks")
                        state = self.rule.apply_backoff(
                            _copy_state(snap), config, snap_gamma_now, scale)
                        if adaptive:
                            # retry under heavier regularization; the stall
                            # decay walks γ back down afterwards
                            boosted = min(
                                snap_gamma_now * health.gamma_backoff ** fails,
                                float(config.gamma_init))
                            if boosted != gamma_now:
                                tel.event("gamma", it=it_done,
                                          gamma_from=gamma_now,
                                          gamma_to=boosted,
                                          reason="health_backoff")
                            gamma_now = boosted
                        g_prev = snap_g_prev
                        # the bad chunk's stats are dropped; the iteration
                        # counter never advanced, so the γ schedule rewinds
                        continue
                    fails = 0

                it_done += n
                tel.counter("solve.iterations", n)
                stats_chunks.append(stats)
                if g_prev is None:
                    rel_dual = (abs(g - float(stats.dual_obj[0]))
                                / max(1.0, abs(g)) if n > 1
                                else float("inf"))
                else:
                    rel_dual = abs(g - g_prev) / max(1.0, abs(g))
                g_prev = g

                at_target = gamma_cur <= config.gamma * (1.0 + 1e-6)
                stalled = rel_dual < config.gamma_stall_tol
                if adaptive and not at_target and stalled:
                    decayed = max(gamma_now * config.gamma_decay_rate,
                                  config.gamma)
                    if decayed != gamma_now:
                        tel.event("gamma", it=it_done, gamma_from=gamma_now,
                                  gamma_to=decayed, reason="stall_decay")
                    gamma_now = decayed
                rec = ConvergenceCheck(it=it_done, dual_obj=g,
                                       rel_dual=rel_dual, infeas=infeas,
                                       grad_norm=grad_norm, gamma=gamma_cur,
                                       elapsed=elapsed, stalled=stalled)
                diags.append(rec)
                tel.event("check", **rec._asdict())
                if diagnostics_fn is not None:
                    diagnostics_fn(rec)
                if health is not None:
                    snap = _copy_state(state)
                    snap_it = it_done
                    snap_gamma_now = gamma_now
                    snap_g_prev = g_prev
                    snap_g, snap_grad, snap_gamma = g, grad_norm, gamma_cur
                if checkpoint_fn is not None:
                    with tel.span("checkpoint", it=it_done):
                        checkpoint_fn(it_done, state, _meta(final=False))
                    tel.event("checkpoint", it=it_done, final=False)
                # tolerances count only once γ has reached its target
                if at_target and criteria.satisfied(rel_dual, infeas,
                                                    grad_norm, infeas_scale):
                    converged = True
                    stop_reason = StopReason.CONVERGED
                    break
                if out_of_time:
                    stop_reason = StopReason.MAX_SECONDS
                    break
        finally:
            if host is not None:
                host.__exit__(None, None, None)
            if profiler is not None:
                # a solve that raises, diverges or is preempted mid-window
                # still writes its trace
                profiler.stop(tel)

        if checkpoint_fn is not None:
            with tel.span("checkpoint", it=it_done):
                checkpoint_fn(it_done, state, _meta(final=True))
            tel.event("checkpoint", it=it_done, final=True)
        if stats_chunks:
            stats = IterStats(*(np.concatenate(f) for f in zip(*stats_chunks)))
        else:
            stats = IterStats(*(np.zeros((0,), np.float32)
                                for _ in IterStats._fields))
        _counted()
        if sampler is not None:
            tel.manifest(**sampler.watermarks())
        tel.event("solve_end", stop_reason=stop_reason.value,
                  iterations_run=it_done, converged=converged,
                  wall_s=time.perf_counter() - t0, checks=len(diags),
                  health_incidents=len(health_recs), solve=seq,
                  evaluations=evaluations[0])
        return SolveResult(lam=state.lam, stats=stats, iterations_run=it_done,
                           converged=converged, stop_reason=stop_reason,
                           diagnostics=tuple(diags),
                           health=tuple(health_recs), final_state=state)


def _infeas_scale(obj, criteria: Optional[StoppingCriteria]) -> float:
    """1 + ‖b‖₂ for the relative infeasibility rule, when obj exposes an LP."""
    if criteria is None or criteria.tol_infeas_rel is None:
        return 1.0
    lp = getattr(obj, "lp", None)
    if lp is None:
        return 1.0
    return 1.0 + float(torch.linalg.vector_norm(lp.b))


def maximize(calculate: Callable, lam0: torch.Tensor, config: SolveConfig,
             algorithm: str = "agd",
             criteria: Optional[StoppingCriteria] = None,
             diagnostics_fn: Optional[Callable] = None,
             infeas_scale: float = 1.0,
             health: Optional[HealthConfig] = None,
             checkpoint_fn: Optional[Callable] = None,
             preempt_fn: Optional[Callable] = None,
             initial_state: Optional[SolveState] = None,
             resume_meta: Optional[dict] = None,
             reduce: DualReduce = LOCAL,
             agree: Optional[Callable] = None,
             telemetry: Optional[Telemetry] = None,
             profiler=None, sampler=None) -> SolveResult:
    """Thin wrapper over SolveEngine: fixed-length with no `criteria`,
    tolerance-terminated with them; the fault-tolerance hooks, the ranks'
    `reduce` and `agree` and the telemetry, profiler and sampler hooks
    pass through."""
    return SolveEngine(calculate, config, algorithm, reduce, agree).solve(
        lam0, criteria=criteria, diagnostics_fn=diagnostics_fn,
        infeas_scale=infeas_scale, health=health,
        checkpoint_fn=checkpoint_fn, preempt_fn=preempt_fn,
        initial_state=initial_state, resume_meta=resume_meta,
        telemetry=telemetry, profiler=profiler, sampler=sampler)


class Maximizer:
    """Paper §4 facade: `maximize(obj, initial_value) -> SolveResult`.

    Builds a SolveEngine for each call: in eager PyTorch there is no
    compiled loop to cache (the reference keeps one in a one-slot cache).
    """

    def __init__(self, config: SolveConfig, algorithm: str = "agd",
                 criteria: Optional[StoppingCriteria] = None):
        self.config = config
        self.algorithm = algorithm
        get_rule(algorithm)  # fail fast
        self.criteria = criteria

    def maximize(self, obj, initial_value: Optional[torch.Tensor] = None,
                 criteria: Optional[StoppingCriteria] = None,
                 diagnostics_fn: Optional[Callable] = None,
                 health: Optional[HealthConfig] = None,
                 checkpoint_fn: Optional[Callable] = None,
                 preempt_fn: Optional[Callable] = None,
                 initial_state: Optional[SolveState] = None,
                 resume_meta: Optional[dict] = None,
                 telemetry: Optional[Telemetry] = None,
                 profiler=None, sampler=None) -> SolveResult:
        if initial_value is None and initial_state is None:
            initial_value = torch.zeros(obj.dual_shape, dtype=torch.float32,
                                        device=obj.lp.b.device)
        criteria = self.criteria if criteria is None else criteria
        engine = SolveEngine(obj.calculate, self.config, self.algorithm)
        return engine.solve(
            initial_value, criteria=criteria, diagnostics_fn=diagnostics_fn,
            infeas_scale=_infeas_scale(obj, criteria), health=health,
            checkpoint_fn=checkpoint_fn, preempt_fn=preempt_fn,
            initial_state=initial_state, resume_meta=resume_meta,
            telemetry=telemetry, profiler=profiler, sampler=sampler)
