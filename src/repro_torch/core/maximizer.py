"""Maximizer — dual ascent of g(λ) over λ >= 0 (paper §5, Appendix B);
port of `repro.core.maximizer`.

The solve loop is convergence-controlled (DESIGN.md §4): the hot path is a
chunk of `check_every` steps during which nothing crosses to the host —
λ, the momentum state, the step and γ are device tensors and each step's
`IterStats` stay on the device.  At the chunk boundary the chunk's stats
are copied to the host once, and a host controller evaluates the
`StoppingCriteria` and, with `SolveConfig.adaptive_continuation`, decays γ
on stall.  With no criteria the engine runs one chunk of the full
iteration count.  The chunk is the counterpart of the reference's jitted
`lax.scan`.  Not ported yet: the health guard, checkpoint/preempt hooks,
telemetry, profiler and memory sampler (ROADMAP queue A items 10, 14).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from .types import (ConvergenceCheck, IterStats, SolveConfig, SolveResult,
                    SolveState, StopReason, StoppingCriteria)
from .update_rules import gamma_at, get_rule


class SolveEngine:
    """The one convergence-controlled solve loop (DESIGN.md §4)."""

    def __init__(self, calculate: Callable, config: SolveConfig,
                 algorithm: str = "agd"):
        self.calculate = calculate
        self.config = config
        self.algorithm = algorithm
        self.rule = get_rule(algorithm)

    def _run_chunk(self, state: SolveState, length: int,
                   gamma: Optional[torch.Tensor]):
        """`length` steps with no host synchronisation; returns the new
        state and the chunk's IterStats as host float32 arrays (one copy).
        `gamma` fixes γ for the chunk (adaptive mode); None follows the
        scheduled continuation from the carried iteration counter."""
        config = self.config
        if gamma is None:
            def gamma_fn(st):
                return gamma_at(config, st.it)
        else:
            def gamma_fn(st):
                return gamma
        rows = []
        for _ in range(length):
            state, st = self.rule.step(self.calculate, config, gamma_fn, state)
            rows.append(torch.stack([t.to(torch.float32).reshape(())
                                     for t in st]))
        host = torch.stack(rows, dim=1).cpu().numpy()       # (6, length)
        return state, IterStats(*host)

    def solve(self, lam0: torch.Tensor,
              criteria: Optional[StoppingCriteria] = None,
              diagnostics_fn: Optional[Callable] = None,
              infeas_scale: float = 1.0) -> SolveResult:
        config = self.config
        total = config.iterations
        if criteria is not None and criteria.max_iterations is not None:
            total = criteria.max_iterations
        adaptive = (config.adaptive_continuation
                    and config.gamma_init is not None
                    and config.gamma_init > config.gamma)
        chunked = total > 0 and (
            adaptive or (criteria is not None and criteria.needs_checks))
        state = self.rule.init_state(lam0, config)
        dev = lam0.device

        if not chunked:
            state, stats = self._run_chunk(state, total, None)
            return SolveResult(lam=state.lam, stats=stats,
                               iterations_run=total, converged=False,
                               stop_reason=StopReason.MAX_ITERATIONS,
                               final_state=state)

        criteria = criteria if criteria is not None else StoppingCriteria()
        check = max(1, int(criteria.check_every))
        gamma_now = float(config.gamma_init) if adaptive else config.gamma
        g_prev = None
        it_done = 0
        t0 = time.perf_counter()
        stats_chunks = []
        diags = deque(maxlen=config.max_diagnostics)
        converged = False
        stop_reason = StopReason.MAX_ITERATIONS
        while it_done < total:
            n = min(check, total - it_done)
            gamma_arr = (torch.full((), gamma_now, dtype=torch.float32,
                                    device=dev) if adaptive else None)
            state, stats = self._run_chunk(state, n, gamma_arr)
            g = float(stats.dual_obj[-1])
            infeas = float(stats.infeas[-1])
            grad_norm = float(stats.grad_norm[-1])
            gamma_cur = float(stats.gamma[-1])
            elapsed = time.perf_counter() - t0

            it_done += n
            stats_chunks.append(stats)
            if g_prev is None:
                rel_dual = (abs(g - float(stats.dual_obj[0]))
                            / max(1.0, abs(g)) if n > 1 else float("inf"))
            else:
                rel_dual = abs(g - g_prev) / max(1.0, abs(g))
            g_prev = g

            at_target = gamma_cur <= config.gamma * (1.0 + 1e-6)
            stalled = rel_dual < config.gamma_stall_tol
            if adaptive and not at_target and stalled:
                gamma_now = max(gamma_now * config.gamma_decay_rate,
                                config.gamma)
            rec = ConvergenceCheck(it=it_done, dual_obj=g, rel_dual=rel_dual,
                                   infeas=infeas, grad_norm=grad_norm,
                                   gamma=gamma_cur, elapsed=elapsed,
                                   stalled=stalled)
            diags.append(rec)
            if diagnostics_fn is not None:
                diagnostics_fn(rec)
            # tolerances count only once γ has reached its target
            if at_target and criteria.satisfied(rel_dual, infeas, grad_norm,
                                                infeas_scale):
                converged = True
                stop_reason = StopReason.CONVERGED
                break
            if (criteria.max_seconds is not None
                    and elapsed >= criteria.max_seconds):
                stop_reason = StopReason.MAX_SECONDS
                break

        if stats_chunks:
            stats = IterStats(*(np.concatenate(f) for f in zip(*stats_chunks)))
        else:
            stats = IterStats(*(np.zeros((0,), np.float32)
                                for _ in IterStats._fields))
        return SolveResult(lam=state.lam, stats=stats, iterations_run=it_done,
                           converged=converged, stop_reason=stop_reason,
                           diagnostics=tuple(diags), final_state=state)


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
             infeas_scale: float = 1.0) -> SolveResult:
    """Thin wrapper over SolveEngine: fixed-length with no `criteria`,
    tolerance-terminated with them."""
    return SolveEngine(calculate, config, algorithm).solve(
        lam0, criteria=criteria, diagnostics_fn=diagnostics_fn,
        infeas_scale=infeas_scale)


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
                 diagnostics_fn: Optional[Callable] = None) -> SolveResult:
        if initial_value is None:
            initial_value = torch.zeros(obj.dual_shape, dtype=torch.float32,
                                        device=obj.lp.b.device)
        criteria = self.criteria if criteria is None else criteria
        engine = SolveEngine(obj.calculate, self.config, self.algorithm)
        return engine.solve(
            initial_value, criteria=criteria, diagnostics_fn=diagnostics_fn,
            infeas_scale=_infeas_scale(obj, criteria))
