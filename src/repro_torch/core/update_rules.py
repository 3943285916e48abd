"""Update rules of the solve engine (DESIGN.md §10); port of
`repro.core.update_rules`.

A rule supplies `init_state(λ0, config)`, `step(calculate, config, γ_fn,
state)`, `health_arrays(state)` (what the health guard sweeps for NaN/Inf
after a chunk), `apply_backoff(state, config, γ, scale)` (shrink the
retried chunk's steps after a rollback), `checkpoint_meta()` and
`state_from_flat(flat)` (rebuild the state from a checkpoint's arrays,
keys `.lam` ... `.extra/.<field>`).  Every quantity a step touches stays
a device tensor: the `it == 0` step choice, the restart tests, β and every
PDHG window decision are `torch.where`s, and γ is a device scalar, so a
chunk of steps runs with no host round-trip.  No step updates a state
tensor in place: a new state shares tensors with the old one
(`lam_prev=state.lam`), and the health guard's snapshot relies on that.

Every reduction of a step over the whole dual vector (norms, inner
products, the mean step) goes through a `DualReduce`: on one device the
plain torch reductions (`LOCAL`); when λ is sharded over ranks,
`distributed.ShardedDualReduce` sums the shards' partials, so that every
rank takes the same step.

Registered rules: `agd` (the paper's accelerated ascent, the default),
`pga` (plain projected ascent), `pdhg` (restarted PDHG on the dual
oracle: per-row steps, window averages, KKT restart) and `bb`
(Barzilai–Borwein steps with a fallback and a trust cap).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Type

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


class DualReduce:
    """The reductions a step takes over the whole dual vector, on a dual
    that lives whole on this device."""

    def norm(self, a: torch.Tensor) -> torch.Tensor:
        return torch.linalg.vector_norm(a)

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """⟨a, b⟩ over every element (λ is (m, J) or (m·J + 1,))."""
        return torch.sum(a * b)

    def mean(self, a: torch.Tensor) -> torch.Tensor:
        return torch.mean(a)


LOCAL = DualReduce()


def _lipschitz_update(state: SolveState, grad: torch.Tensor,
                      reduce: DualReduce = LOCAL,
                      decay: float = 0.97) -> torch.Tensor:
    """Running local-Lipschitz estimate L̂ ← max(decay·L̂, ‖Δ∇g‖/‖Δy‖)."""
    dy = reduce.norm(state.y - state.y_prev)
    dg = reduce.norm(grad - state.grad_prev)
    obs = torch.where(dy > 0, dg / torch.clamp_min(dy, 1e-30),
                      torch.zeros_like(dg))
    return torch.maximum(state.l_est * decay, obs)


def initial_state(lam0: torch.Tensor, config: SolveConfig,
                  extra=()) -> SolveState:
    """Fresh SolveState over the shared fields; every leaf its own
    buffer."""
    dev = lam0.device
    return SolveState(lam=lam0.clone(), y=lam0.clone(),
                      lam_prev=lam0.clone(), grad_prev=torch.zeros_like(lam0),
                      y_prev=lam0.clone(),
                      step=_f32(config.initial_step, dev),
                      l_est=_f32(0.0, dev),
                      k_mom=torch.zeros((), dtype=torch.int32, device=dev),
                      it=torch.zeros((), dtype=torch.int32, device=dev),
                      extra=extra)


def _iter_stats(g, aux, grad, step, gamma,
                reduce: DualReduce = LOCAL) -> IterStats:
    return IterStats(dual_obj=g, primal_obj=aux.primal_obj, infeas=aux.infeas,
                     grad_norm=reduce.norm(grad), step=step, gamma=gamma)


class UpdateRule:
    """Base class of the update rules (module docstring).  `extra_cls`
    names the NamedTuple of the rule's state extension (None when the
    shared SolveState fields suffice); `state_from_flat` reads it."""

    name: str = "?"
    extra_cls: Optional[Type[NamedTuple]] = None

    def init_state(self, lam0: torch.Tensor, config: SolveConfig) -> SolveState:
        return initial_state(lam0, config)

    def health_arrays(self, state: SolveState) -> Tuple[torch.Tensor, ...]:
        """Tensors the health guard sweeps for NaN/Inf after each chunk."""
        return (state.lam, state.y)

    def step(self, calculate: Callable, config: SolveConfig,
             gamma_fn: Callable, state: SolveState,
             reduce: DualReduce = LOCAL):
        raise NotImplementedError

    def apply_backoff(self, state: SolveState, config: SolveConfig,
                      gamma_now: float, scale: float) -> SolveState:
        """Shrink the retried chunk's steps on a restored snapshot.  Every
        rule's step is bounded by min(1/L̂, cap) or falls back to it, so
        flooring L̂ at 1/(cap·scale) caps the retried steps at cap·scale
        (the estimate decays at 0.97 an iteration, so the backoff relaxes
        gradually).  Momentum is killed (k_mom = 0, y = λ, secant
        collapsed): a rollback is a restart.  The one host read of `cap`
        happens at a rollback, which is a host decision already."""
        dev = state.lam.device
        cap = float(max_step_at(config, _f32(gamma_now, dev)))
        floor = 1.0 / max(cap * scale, 1e-30)
        return state._replace(
            l_est=torch.maximum(state.l_est, _f32(floor, dev)),
            k_mom=torch.zeros_like(state.k_mom),
            y=state.lam.clone(),
            y_prev=state.lam.clone())

    def checkpoint_meta(self) -> dict:
        """Rule metadata stored with every checkpoint, so that a resume
        can refuse another rule's state."""
        return {"algorithm": self.name}

    def state_from_flat(self, flat: Dict, device=None) -> SolveState:
        """Rebuild the SolveState from a checkpoint's flattened arrays
        (keys '.lam', '.y', ... and '.extra/.<field>'), on `device`.
        Raises KeyError naming the missing array when the checkpoint was
        written under another state layout."""
        def t(key):
            return torch.as_tensor(flat[key], device=device)
        core = {f: t(f".{f}") for f in SolveState._fields if f != "extra"}
        extra = ()
        if self.extra_cls is not None:
            extra = self.extra_cls(*(t(f".extra/.{f}")
                                     for f in self.extra_cls._fields))
        return SolveState(extra=extra, **core)


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


def _ascent_step(config: SolveConfig, l_est: torch.Tensor,
                 cap: torch.Tensor, it: torch.Tensor) -> torch.Tensor:
    """min(1/L̂, cap), and `initial_step` at the first iteration."""
    return torch.where(it == 0, _f32(config.initial_step, cap.device),
                       torch.minimum(torch.where(l_est > 0, 1.0 / l_est, cap),
                                     cap))


def agd_step(calculate: Callable, config: SolveConfig, gamma_fn: Callable,
             state: SolveState, reduce: DualReduce = LOCAL):
    """One Nesterov-accelerated projected dual-ascent step with the secant
    Lipschitz step and O'Donoghue–Candès adaptive restart."""
    gamma = gamma_fn(state)
    cap = max_step_at(config, gamma)
    g, grad, aux = calculate(state.y, gamma)

    l_est = _lipschitz_update(state, grad, reduce)
    step = _ascent_step(config, l_est, cap, state.it)

    lam_new = torch.clamp_min(state.y + step * grad, 0.0)

    # restart iff ⟨∇g(y), λ_{k+1} − λ_k⟩ < 0 (the gradient opposes travel)
    restart = reduce.dot(grad, lam_new - state.lam) < 0.0
    k_mom = torch.where(restart, torch.zeros_like(state.k_mom),
                        state.k_mom + 1)
    k = k_mom.to(torch.float32)
    beta = k / (k + 3.0)
    y_new = lam_new + beta * (lam_new - state.lam)

    new_state = SolveState(
        lam=lam_new, y=y_new, lam_prev=state.lam, grad_prev=grad,
        y_prev=state.y, step=step, l_est=l_est, k_mom=k_mom,
        it=state.it + 1)
    return new_state, _iter_stats(g, aux, grad, step, gamma, reduce)


def pga_step(calculate: Callable, config: SolveConfig, gamma_fn: Callable,
             state: SolveState, reduce: DualReduce = LOCAL):
    """Plain projected gradient ascent (no momentum), the ablation
    baseline."""
    gamma = gamma_fn(state)
    cap = max_step_at(config, gamma)
    g, grad, aux = calculate(state.y, gamma)
    l_est = _lipschitz_update(state, grad, reduce)
    step = _ascent_step(config, l_est, cap, state.it)
    lam_new = torch.clamp_min(state.y + step * grad, 0.0)
    new_state = SolveState(lam=lam_new, y=lam_new, lam_prev=state.lam,
                           grad_prev=grad, y_prev=state.y, step=step,
                           l_est=l_est, k_mom=state.k_mom, it=state.it + 1)
    return new_state, _iter_stats(g, aux, grad, step, gamma, reduce)


@register_rule
class AGDRule(UpdateRule):
    name = "agd"

    def step(self, calculate, config, gamma_fn, state, reduce=LOCAL):
        return agd_step(calculate, config, gamma_fn, state, reduce)


@register_rule
class PGARule(UpdateRule):
    name = "pga"

    def step(self, calculate, config, gamma_fn, state, reduce=LOCAL):
        return pga_step(calculate, config, gamma_fn, state, reduce)


class PDHGExtra(NamedTuple):
    """Restarted-PDHG state extension, all device tensors.  The primal
    iterate never appears: x_k = x*(λ_k) is computed inside `calculate`,
    and A x̄ − b of the averaged primal is `grad_sum / window` by
    linearity."""

    l_diag: torch.Tensor      # per-row running-max secant curvature
    lam_sum: torch.Tensor     # Σ λ over the current restart window
    grad_sum: torch.Tensor    # Σ ∇g over the window
    window: torch.Tensor      # int32, iterations since the window reset
    score: torch.Tensor       # KKT score at the last window reset
    omega: torch.Tensor       # global step multiplier (backoff shrinks it)
    gamma_prev: torch.Tensor  # γ of the previous iteration


def _kkt_score(lam_avg: torch.Tensor, grad_avg: torch.Tensor,
               reduce: DualReduce = LOCAL) -> torch.Tensor:
    """Projected-gradient norm of the dual at λ̄ with ḡ = A x̄ − b: zero
    exactly at a saddle point; the adaptive restart fires on its decay."""
    pg = torch.where((lam_avg > 0.0) | (grad_avg > 0.0), grad_avg,
                     torch.zeros_like(grad_avg))
    return reduce.norm(pg)


def pdhg_step(calculate: Callable, config: SolveConfig, gamma_fn: Callable,
              state: SolveState, reduce: DualReduce = LOCAL):
    """One restarted-PDHG iteration on the dual oracle (the reference's
    `pdhg_step`).  Exact primal minimization collapses PDHG's primal
    half-step, so: the oracle is evaluated at the extrapolated
    y = λ + β(λ − λ_prev) with the agd restart test; each dual row steps
    by ω / L̂_i with L̂_i a running-max coordinatewise secant (fresh rows
    fall back to the global 1/L̂); running λ̄ / ḡ window averages jump to
    λ̄ when its KKT score has decayed by `pdhg_restart_beta` and beats the
    current iterate's, and `pdhg_restart_every` re-bases the window.  A γ
    move rescales L̂_i by γ_old/γ_new and drops the window.  Every
    decision is a `torch.where` on device scalars."""
    gamma = gamma_fn(state)
    cap = max_step_at(config, gamma)
    ex: PDHGExtra = state.extra
    dev = gamma.device
    g, grad, aux = calculate(state.y, gamma)

    # a γ move changed the landscape: rescale the curvature (L ∝ 1/γ) and
    # drop the window, whose average belongs to the old γ
    gamma_moved = torch.abs(gamma - ex.gamma_prev) > 0.0
    ratio = torch.where(ex.gamma_prev > 0, ex.gamma_prev / gamma,
                        _f32(1.0, dev))
    l_diag0 = torch.where(gamma_moved, ex.l_diag * ratio, ex.l_diag)
    window = torch.where(gamma_moved, torch.zeros_like(ex.window), ex.window)
    lam_sum = torch.where(gamma_moved, torch.zeros_like(ex.lam_sum),
                          ex.lam_sum)
    grad_sum = torch.where(gamma_moved, torch.zeros_like(ex.grad_sum),
                           ex.grad_sum)
    score0 = torch.where(gamma_moved, _f32(math.inf, dev), ex.score)

    # per-row secant curvature, running max with slow decay
    d_y = torch.abs(state.y - state.y_prev)
    d_g = torch.abs(grad - state.grad_prev)
    obs = torch.where(d_y > 0, d_g / torch.clamp_min(d_y, 1e-30),
                      torch.zeros_like(d_g))
    l_diag = torch.maximum(config.pdhg_l_decay * l_diag0, obs)

    l_est = _lipschitz_update(state, grad, reduce)
    l_glob = torch.where(l_est > 0, l_est, 1.0 / cap)
    l_eff = torch.where(l_diag > 0, l_diag, l_glob)
    smax = config.pdhg_step_max_scale * cap * ex.omega
    steps = torch.minimum(torch.clamp_min(
        ex.omega / torch.maximum(l_eff, ex.omega / smax), 0.0), smax)
    steps = torch.where(state.it == 0, _f32(config.initial_step, dev), steps)

    lam_new = torch.clamp_min(state.y + steps * grad, 0.0)

    mom_restart = reduce.dot(grad, lam_new - state.lam) < 0.0
    k_mom = torch.where(mom_restart, torch.zeros_like(state.k_mom),
                        state.k_mom + 1)

    window = window + 1
    lam_sum = lam_sum + lam_new
    grad_sum = grad_sum + grad
    wf = window.to(torch.float32)
    lam_avg = lam_sum / wf
    grad_avg = grad_sum / wf
    score_avg = _kkt_score(lam_avg, grad_avg, reduce)
    score_cur = _kkt_score(lam_new, grad, reduce)

    # adaptive restart: jump to the average when its score has decayed
    # enough AND beats the current iterate; the fixed-frequency cap only
    # re-bases the window
    decayed = score_avg <= config.pdhg_restart_beta * score0
    take_avg = ((window >= config.pdhg_min_window) & decayed
                & (score_avg < score_cur))
    exhausted = window >= config.pdhg_restart_every
    reset_win = take_avg | exhausted

    lam_next = torch.where(take_avg, lam_avg, lam_new)
    k_mom = torch.where(take_avg, torch.zeros_like(k_mom), k_mom)
    k = k_mom.to(torch.float32)
    beta = k / (k + 3.0)
    y_new = lam_next + beta * (lam_next - torch.where(take_avg, lam_next,
                                                      state.lam))

    score_best = torch.minimum(score_avg, score_cur)
    new_extra = PDHGExtra(
        l_diag=l_diag,
        lam_sum=torch.where(reset_win, torch.zeros_like(lam_sum), lam_sum),
        grad_sum=torch.where(reset_win, torch.zeros_like(grad_sum),
                             grad_sum),
        window=torch.where(reset_win, torch.zeros_like(window), window),
        score=torch.where(reset_win, score_best, score0),
        omega=ex.omega,
        gamma_prev=gamma)

    mean_step = reduce.mean(steps)
    new_state = SolveState(
        lam=lam_next, y=y_new, lam_prev=state.lam, grad_prev=grad,
        y_prev=state.y, step=mean_step, l_est=l_est, k_mom=k_mom,
        it=state.it + 1, extra=new_extra)
    return new_state, _iter_stats(g, aux, grad, mean_step, gamma, reduce)


@register_rule
class PDHGRule(UpdateRule):
    name = "pdhg"
    extra_cls = PDHGExtra

    def init_state(self, lam0, config):
        dev = lam0.device
        extra = PDHGExtra(
            l_diag=torch.zeros_like(lam0),
            lam_sum=torch.zeros_like(lam0),
            grad_sum=torch.zeros_like(lam0),
            window=torch.zeros((), dtype=torch.int32, device=dev),
            score=_f32(math.inf, dev),
            omega=_f32(config.pdhg_omega_init, dev),
            gamma_prev=_f32(-1.0, dev))
        return initial_state(lam0, config, extra)

    def step(self, calculate, config, gamma_fn, state, reduce=LOCAL):
        return pdhg_step(calculate, config, gamma_fn, state, reduce)

    def apply_backoff(self, state, config, gamma_now, scale):
        """Also shrink ω, which every diagonal step carries, and drop the
        window averages and curvature estimates that produced the bad
        steps."""
        st = super().apply_backoff(state, config, gamma_now, scale)
        ex: PDHGExtra = st.extra
        dev = ex.omega.device
        return st._replace(extra=ex._replace(
            omega=torch.maximum(ex.omega * _f32(scale, dev),
                                _f32(config.pdhg_omega_min, dev)),
            l_diag=torch.zeros_like(ex.l_diag),
            lam_sum=torch.zeros_like(ex.lam_sum),
            grad_sum=torch.zeros_like(ex.grad_sum),
            window=torch.zeros_like(ex.window),
            score=_f32(math.inf, dev)))


def bb_step(calculate: Callable, config: SolveConfig, gamma_fn: Callable,
            state: SolveState, reduce: DualReduce = LOCAL):
    """Spectral projected dual ascent (the reference's `bb_step`): the
    smaller of the BB1 step ‖Δλ‖²/⟨Δλ, −Δ∇g⟩ and the BB2 step
    ⟨Δλ, −Δ∇g⟩/‖Δ∇g‖², trust-capped at `bb_step_max_scale`·cap, and the
    engine's min(1/L̂, cap) when the curvature pair is degenerate.  It
    evaluates the oracle at λ, not at an extrapolated y."""
    gamma = gamma_fn(state)
    cap = max_step_at(config, gamma)
    dev = gamma.device
    g, grad, aux = calculate(state.lam, gamma)

    s = state.lam - state.lam_prev
    dg = grad - state.grad_prev
    sy = -reduce.dot(s, dg)                  # curvature along s (> 0 ok)
    ss = reduce.dot(s, s)
    yy = reduce.dot(dg, dg)

    l_est = _lipschitz_update(state, grad, reduce)
    fallback = torch.minimum(torch.where(l_est > 0, 1.0 / l_est, cap), cap)
    bb1 = ss / torch.clamp_min(sy, 1e-30)
    bb2 = sy / torch.clamp_min(yy, 1e-30)
    usable = (sy > 1e-30) & (ss > 0.0)
    step = torch.where(usable,
                       torch.minimum(torch.minimum(bb1, bb2),
                                     config.bb_step_max_scale * cap),
                       fallback)
    step = torch.where(state.it == 0, _f32(config.initial_step, dev), step)

    lam_new = torch.clamp_min(state.lam + step * grad, 0.0)
    new_state = SolveState(
        lam=lam_new, y=lam_new, lam_prev=state.lam, grad_prev=grad,
        y_prev=state.lam, step=step, l_est=l_est,
        k_mom=torch.zeros_like(state.k_mom), it=state.it + 1,
        extra=state.extra)
    return new_state, _iter_stats(g, aux, grad, step, gamma, reduce)


@register_rule
class BBRule(UpdateRule):
    name = "bb"

    def step(self, calculate, config, gamma_fn, state, reduce=LOCAL):
        return bb_step(calculate, config, gamma_fn, state, reduce)

    def apply_backoff(self, state, config, gamma_now, scale):
        """Collapse the secant pair (λ_prev = λ, so Δλ = 0 and the
        fallback step runs), so that the retry runs at the floored 1/L̂
        step instead of the same overshooting BB step."""
        st = super().apply_backoff(state, config, gamma_now, scale)
        return st._replace(lam_prev=st.lam.clone(),
                           grad_prev=torch.zeros_like(st.grad_prev))
