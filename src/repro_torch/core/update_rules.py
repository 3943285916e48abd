"""Update rules of the solve engine (DESIGN.md §10); port of
`repro.core.update_rules`, with the default `agd` rule only.

A rule supplies `init_state(λ0, config)` and `step(calculate, config,
γ_fn, state)`.  Every quantity a step touches stays a device tensor: the
`it == 0` step choice, the restart test and β are `torch.where`s, and γ
is a device scalar, so a chunk of steps runs with no host round-trip.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple, Type

import torch

from .types import IterStats, SolveConfig, SolveState


def _f32(v, device) -> torch.Tensor:
    """A float32 device scalar made by a fill, not a host-to-device copy
    (which would synchronise the stream)."""
    return torch.full((), v, dtype=torch.float32, device=device)


def gamma_at(config: SolveConfig, it: torch.Tensor) -> torch.Tensor:
    """Continuation schedule γ(t) as a device scalar; constant when
    continuation is off."""
    if config.gamma_init is None or config.gamma_init <= config.gamma:
        return _f32(config.gamma, it.device)
    n_decays = torch.div(it, config.gamma_decay_every, rounding_mode="floor")
    g = config.gamma_init * torch.pow(
        _f32(config.gamma_decay_rate, it.device), n_decays)
    return torch.clamp_min(g, config.gamma)


def max_step_at(config: SolveConfig, gamma: torch.Tensor) -> torch.Tensor:
    """Step cap, scaled ∝ γ during continuation (§5.1: L = ‖A‖²/γ)."""
    if (config.gamma_init is None or not config.scale_step_with_gamma
            or config.gamma_init <= config.gamma):
        return _f32(config.max_step, gamma.device)
    return config.max_step * gamma / config.gamma


def _lipschitz_update(state: SolveState, grad: torch.Tensor,
                      decay: float = 0.97) -> torch.Tensor:
    """Running local-Lipschitz estimate L̂ ← max(decay·L̂, ‖Δ∇g‖/‖Δy‖)."""
    dy = torch.linalg.vector_norm(state.y - state.y_prev)
    dg = torch.linalg.vector_norm(grad - state.grad_prev)
    obs = torch.where(dy > 0, dg / torch.clamp_min(dy, 1e-30),
                      torch.zeros_like(dg))
    return torch.maximum(state.l_est * decay, obs)


def initial_state(lam0: torch.Tensor, config: SolveConfig,
                  extra=()) -> SolveState:
    """Fresh SolveState; every leaf its own buffer."""
    dev = lam0.device
    return SolveState(lam=lam0.clone(), y=lam0.clone(),
                      lam_prev=lam0.clone(), grad_prev=torch.zeros_like(lam0),
                      y_prev=lam0.clone(),
                      step=_f32(config.initial_step, dev),
                      l_est=_f32(0.0, dev),
                      k_mom=torch.zeros((), dtype=torch.int32, device=dev),
                      it=torch.zeros((), dtype=torch.int32, device=dev),
                      extra=extra)


def _iter_stats(g, aux, grad, step, gamma) -> IterStats:
    return IterStats(dual_obj=g, primal_obj=aux.primal_obj, infeas=aux.infeas,
                     grad_norm=torch.linalg.vector_norm(grad), step=step,
                     gamma=gamma)


class UpdateRule:
    """Base class of the update rules."""

    name: str = "?"

    def init_state(self, lam0: torch.Tensor, config: SolveConfig) -> SolveState:
        return initial_state(lam0, config)

    def step(self, calculate: Callable, config: SolveConfig,
             gamma_fn: Callable, state: SolveState):
        raise NotImplementedError


_RULES: Dict[str, UpdateRule] = {}


def register_rule(cls: Type[UpdateRule]) -> Type[UpdateRule]:
    """Class decorator: register an UpdateRule under its `name`."""
    if cls.name in _RULES:
        raise ValueError(f"update rule {cls.name!r} already registered")
    _RULES[cls.name] = cls()
    return cls


def rule_names() -> Tuple[str, ...]:
    return tuple(sorted(_RULES))


def get_rule(name: str) -> UpdateRule:
    """Resolve a rule by name, failing fast with the registered list."""
    try:
        return _RULES[name]
    except KeyError:
        raise ValueError(
            f"unknown update rule (algorithm) {name!r}; registered rules: "
            f"{', '.join(rule_names())}") from None


def agd_step(calculate: Callable, config: SolveConfig, gamma_fn: Callable,
             state: SolveState):
    """One Nesterov-accelerated projected dual-ascent step with the secant
    Lipschitz step and O'Donoghue–Candès adaptive restart."""
    gamma = gamma_fn(state)
    cap = max_step_at(config, gamma)
    g, grad, aux = calculate(state.y, gamma)

    l_est = _lipschitz_update(state, grad)
    step = torch.where(state.it == 0, _f32(config.initial_step, grad.device),
                       torch.minimum(torch.where(l_est > 0, 1.0 / l_est, cap),
                                     cap))

    lam_new = torch.clamp_min(state.y + step * grad, 0.0)

    # restart iff ⟨∇g(y), λ_{k+1} − λ_k⟩ < 0 (the gradient opposes travel)
    restart = torch.sum(grad * (lam_new - state.lam)) < 0.0
    k_mom = torch.where(restart, torch.zeros_like(state.k_mom),
                        state.k_mom + 1)
    k = k_mom.to(torch.float32)
    beta = k / (k + 3.0)
    y_new = lam_new + beta * (lam_new - state.lam)

    new_state = SolveState(
        lam=lam_new, y=y_new, lam_prev=state.lam, grad_prev=grad,
        y_prev=state.y, step=step, l_est=l_est, k_mom=k_mom,
        it=state.it + 1)
    return new_state, _iter_stats(g, aux, grad, step, gamma)


@register_rule
class AGDRule(UpdateRule):
    name = "agd"

    def step(self, calculate, config, gamma_fn, state):
        return agd_step(calculate, config, gamma_fn, state)
