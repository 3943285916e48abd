"""The port's update rules (pga, pdhg, bb) and their registry against the
JAX package's, on one generated row-normalized instance.

  * one step from the same state, fed the same oracle values (the
    reference objective's g, ∇g at the step's evaluation point), equals
    the reference's step to 1e-6 relative in every field of SolveState
    and of PDHGExtra (integers exactly): the rules' own arithmetic;
  * 50 fixed iterations, each package on its own objective, keep the dual
    within 1e-5 relative, as test_torch_solver.py holds agd.  pdhg's and
    bb's steps reach 8× max_step, so the drift test runs at max_step
    0.05 / 8, where their step cap is agd's 0.05 of test_torch_solver.py:
    at 0.05 the reference's own aligned and scatter lowerings drift more
    than 1e-5 apart in 50 iterations (the chaos of large steps, ROADMAP
    queue C), at 0.05 / 8 less than 1e-6;
  * the registry lists the reference's public rules, and an unknown or a
    duplicate name fails as it does there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MatchingObjective as RObjective
from repro.core import Maximizer as RMaximizer
from repro.core import SolveConfig as RConfig
from repro.core import instance as rinst
from repro.core import precondition as rprecondition
from repro.core import update_rules as rrules
from repro.core.types import SolveState as RState
from repro_torch.convert import lp_to_torch
from repro_torch.core import MatchingObjective as TObjective
from repro_torch.core import Maximizer as TMaximizer
from repro_torch.core import SolveConfig as TConfig
from repro_torch.core import SolveEngine, instance as tinst
from repro_torch.core import precondition as tprecondition
from repro_torch.core import update_rules as trules
from repro_torch.core.objectives import ObjectiveAux
from repro_torch.core.types import SolveState as TState

SPEC = dict(num_sources=120, num_destinations=19, avg_nnz_per_row=9,
            seed=11, num_families=2)
RULES = ("pga", "pdhg", "bb")
# γ fixed, and γ-continuation (pdhg's landscape-move reset runs at every
# γ step); DRIFT_CONFIGS take max_step / 8 (module docstring)
CONFIGS = {
    "fixed": dict(iterations=50, gamma=0.1, max_step=0.05,
                  initial_step=1e-4),
    "continuation": dict(iterations=50, gamma=0.1, gamma_init=0.8,
                         gamma_decay_every=10, max_step=0.05,
                         initial_step=1e-4),
}
DRIFT_CONFIGS = {k: dict(v, max_step=0.05 / 8) for k, v in CONFIGS.items()}
# the perf_lp/tol_agd instance and configuration (2,000 x 1,000, nu = 4,
# seed 42, boxcut with 20 bisection steps), on which pga has no recorded
# row: the port's dual after a fixed 300 pga iterations on a CPU, which
# chip_smoke.py holds the card's run to (1e-5 relative)
PARITY_SPEC = dict(num_sources=2000, num_destinations=1000,
                   avg_nnz_per_row=4.0, seed=42)
PARITY_CONFIG = dict(iterations=300, gamma=0.01, max_step=1e-1,
                     initial_step=1e-5)
PGA_300_DUAL = -2353.14990234375


@pytest.fixture(scope="module")
def pair():
    lp_r, _ = jax.jit(rprecondition)(jax.tree.map(
        jnp.asarray, rinst.generate(rinst.InstanceSpec(**SPEC))))
    lp_t, _ = tprecondition(lp_to_torch(
        tinst.generate(tinst.InstanceSpec(**SPEC)), "cpu"), row_norm=True)
    return RObjective(lp_r, ax_mode="aligned"), TObjective(lp_t)


def _state_to_torch(st: RState) -> TState:
    extra = st.extra
    if extra != ():
        extra = trules.PDHGExtra(*(torch.from_numpy(np.array(a))
                                   for a in extra))
    return TState(*(torch.from_numpy(np.array(a)) for a in st[:-1]),
                  extra=extra)


def _shared_oracle(obj_r):
    """The port's `calculate` signature over the reference objective's
    values, so that both rules step on the same oracle."""
    def calculate(lam, gamma):
        g, grad, aux = obj_r.calculate(jnp.asarray(lam.numpy()),
                                       jnp.float32(gamma.item()))
        t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
        return t(g), t(grad), ObjectiveAux(
            primal_obj=t(aux.primal_obj), x_sq=t(aux.x_sq), ax=t(aux.ax),
            infeas=t(aux.infeas))
    return calculate


def _close(port, ref, what):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, what
    if not np.issubdtype(ref.dtype, np.floating) or not np.isfinite(ref).all():
        np.testing.assert_array_equal(port, ref, err_msg=what)
        return
    scale = float(np.max(np.abs(ref), initial=0.0))
    err = float(np.max(np.abs(port.astype(np.float64) - ref), initial=0.0))
    assert err <= 1e-6 * scale, f"{what}: |Δ| {err:.3e}, scale {scale:.3e}"


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("warm", [0, 1, 13], ids=lambda k: f"after{k}")
@pytest.mark.parametrize("rule", RULES)
def test_one_step_matches_reference(pair, rule, warm, config):
    obj_r, _ = pair
    cfg = CONFIGS[config]
    cfg_r, cfg_t = RConfig(**cfg), TConfig(**cfg)
    r_rule, t_rule = rrules.get_rule(rule), trules.get_rule(rule)
    lam0 = jnp.zeros(obj_r.dual_shape, jnp.float32)
    state_r = (RMaximizer(RConfig(**dict(cfg, iterations=warm)),
                          algorithm=rule).maximize(obj_r).final_state
               if warm else r_rule.init_state(lam0, cfg_r))
    state_t = _state_to_torch(state_r)

    new_r, st_r = r_rule.step(obj_r.calculate, cfg_r,
                              lambda s: rrules.gamma_at(cfg_r, s.it),
                              state_r, None)
    new_t, st_t = t_rule.step(_shared_oracle(obj_r), cfg_t,
                              lambda s: trules.gamma_at(cfg_t, s.it),
                              state_t)
    for f in TState._fields[:-1]:
        _close(getattr(new_t, f), getattr(new_r, f), f)
    if rule == "pdhg":
        for f in trules.PDHGExtra._fields:
            _close(getattr(new_t.extra, f), getattr(new_r.extra, f),
                   f"extra.{f}")
    else:
        assert new_t.extra == () and new_r.extra == ()
    for f in st_r._fields:
        _close(getattr(st_t, f).to(torch.float32),
               np.asarray(getattr(st_r, f), np.float32), f"stats.{f}")


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("rule", RULES)
def test_fixed_iterations_dual_drift(pair, rule, config):
    obj_r, obj_t = pair
    cfg = DRIFT_CONFIGS[config]
    res_r = RMaximizer(RConfig(**cfg), algorithm=rule).maximize(obj_r)
    res_t = TMaximizer(TConfig(**cfg), algorithm=rule).maximize(obj_t)
    d_r = np.asarray(res_r.stats.dual_obj)
    d_t = res_t.stats.dual_obj
    assert d_t.shape == d_r.shape == (50,)
    assert abs(d_t[-1] - d_r[-1]) <= 1e-5 * abs(d_r[-1])
    assert np.isfinite(res_t.lam.numpy()).all()


@pytest.mark.parametrize("rule", ("pdhg", "bb"))
def test_large_steps_drift_in_the_reference(rule):
    """Why the drift test takes max_step / 8: the reference against
    itself, aligned against scatter, 50 iterations from the same state."""
    lp_r, _ = jax.jit(rprecondition)(jax.tree.map(
        jnp.asarray, rinst.generate(rinst.InstanceSpec(**SPEC))))

    def drift(cfg):
        d = [float(RMaximizer(RConfig(**cfg), algorithm=rule).maximize(
            RObjective(lp_r, ax_mode=mode)).stats.dual_obj[-1])
            for mode in ("aligned", "scatter")]
        return abs(d[0] - d[1]) / abs(d[0])

    assert max(drift(c) for c in CONFIGS.values()) > 1e-5
    assert max(drift(c) for c in DRIFT_CONFIGS.values()) < 1e-6


def test_rule_names_match_reference():
    public = tuple(n for n in rrules.rule_names() if not n.startswith("_"))
    assert trules.rule_names() == public == ("agd", "bb", "pdhg", "pga")
    for name in trules.rule_names():
        assert trules.get_rule(name).name == name


def test_unknown_rule_fails_like_reference(pair):
    _, obj_t = pair
    with pytest.raises(ValueError) as ei:
        SolveEngine(obj_t.calculate, TConfig(), algorithm="adgx")
    with pytest.raises(ValueError) as er:
        rrules.get_rule("adgx")
    assert str(ei.value).split(";")[0] == str(er.value).split(";")[0]
    for name in trules.rule_names():
        assert name in str(ei.value)
    with pytest.raises(ValueError, match="registered rules"):
        TMaximizer(TConfig(), algorithm="nesterov")


def test_duplicate_rule_rejected():
    with pytest.raises(ValueError, match="already registered"):
        @trules.register_rule
        class Impostor(trules.UpdateRule):
            name = "pdhg"
    assert trules.rule_names() == ("agd", "bb", "pdhg", "pga")


def test_pga_fixed_300_dual():
    """pga's fixed 300 iterations on the parity instance: the port's dual
    is the recorded one (1e-6 relative) and within 1e-4 relative of the
    reference's (the parity duals' tolerance; the two drift 1.1e-5 apart
    over these 300 iterations at max_step 0.1)."""
    lp_r, _ = jax.jit(rprecondition)(jax.tree.map(
        jnp.asarray, rinst.generate(rinst.InstanceSpec(**PARITY_SPEC))))
    lp_t, _ = tprecondition(lp_to_torch(
        tinst.generate(tinst.InstanceSpec(**PARITY_SPEC)), "cpu"),
        row_norm=True)
    kw = dict(proj_kind="boxcut", proj_iters=20, ax_mode="aligned")
    d_r = float(RMaximizer(RConfig(**PARITY_CONFIG), algorithm="pga")
                .maximize(RObjective(lp_r, **kw)).stats.dual_obj[-1])
    d_t = float(TMaximizer(TConfig(**PARITY_CONFIG), algorithm="pga")
                .maximize(TObjective(lp_t, **kw)).stats.dual_obj[-1])
    assert abs(d_t - PGA_300_DUAL) <= 1e-6 * abs(PGA_300_DUAL)
    assert abs(d_t - d_r) <= 1e-4 * abs(d_r)
