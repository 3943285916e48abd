"""The port's formulations (`repro_torch.formulations`: spec, registry,
compiler) against the JAX package's, and its own legacy objectives.

Mirrors tests/test_formulations.py on the port: the registry, the λ row
layout, `matching` and `global_count` compiled equal to `MatchingObjective`
and `GlobalCountObjective` bit for bit (value, gradient, trajectory,
primal), `multi_budget` and `assignment_eq` solved to tolerance through the
port's engine.  The reference's `use_pallas` rejections become the port's
fixed route: a simplex_eq slab runs the plain sweep and never the kernel
wrapper.

Against the reference, on the same generated instance: one `calculate` at
γ = 0.1 in every ax mode, value within 1e-6 relative and the gradient
within 1e-6·max(1, ‖∇g‖∞) (float32 sums in another order), and the
trajectories by their final dual (1e-4) and stopping iteration, never λ
(ROADMAP queue C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import formulations as rformulations
from repro.core import Maximizer as RMaximizer
from repro.core import SolveConfig as RSolveConfig
from repro.core import StoppingCriteria as RStoppingCriteria
from repro.core import instance as rinst
from repro_torch import formulations
from repro_torch.convert import lp_to_torch
from repro_torch.core import (GlobalCountObjective, InstanceSpec,
                              MatchingObjective, Maximizer, SolveConfig,
                              StoppingCriteria, generate, precondition)
from repro_torch.formulations import (BlockConstraint, DestCapacityFamily,
                                      Formulation, GlobalBudgetFamily,
                                      compile_formulation, make_objective)
from repro_torch.kernels import ops as kops

SPEC = dict(num_sources=120, num_destinations=19, avg_nnz_per_row=9,
            seed=11, num_families=2)
GAMMA = torch.tensor(0.1)
FORMS = ("matching", "global_count", "multi_budget", "assignment_eq")
MODES = ("aligned", "aligned_gvals", "sorted", "scatter")


@pytest.fixture(scope="module")
def lp():
    return lp_to_torch(generate(InstanceSpec(**SPEC)), "cpu")


@pytest.fixture(scope="module")
def lp_ref():
    return jax.tree.map(jnp.asarray, rinst.generate(rinst.InstanceSpec(**SPEC)))


@pytest.fixture(scope="module")
def lp_pc(lp):
    return precondition(lp, row_norm=True)[0]


CFG = SolveConfig(iterations=300, gamma=0.1, max_step=0.05,
                  initial_step=1e-4)


def _lam(shape, seed, scale):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0, scale, shape).astype(np.float32))


class TestRegistry:
    def test_builtins_registered(self):
        for name in FORMS:
            assert name in formulations.names()
        assert formulations.names() == rformulations.names()

    def test_unknown_name_raises(self):
        with pytest.raises(KeyError, match="unknown formulation"):
            formulations.get("no_such_formulation")

    def test_duplicate_registration_raises(self):
        with pytest.raises(ValueError, match="already registered"):
            formulations.register("matching")(lambda lp: None)

    def test_spec_validation(self, lp):
        bad = Formulation(name="bad", families=(
            GlobalBudgetFamily(limit=1.0),))
        with pytest.raises(ValueError, match="exactly one"):
            bad.validate(lp.m)
        with pytest.raises(ValueError, match="weight"):
            Formulation(name="bad2", families=(
                DestCapacityFamily(),
                GlobalBudgetFamily(limit=1.0, weight="nope"),
            )).validate(lp.m)
        with pytest.raises(ValueError, match="limit"):
            Formulation(name="bad3", families=(
                DestCapacityFamily(),
                GlobalBudgetFamily(limit=-1.0),
            )).validate(lp.m)

    def test_equality_block_runs_the_plain_sweep(self, lp, monkeypatch):
        """simplex_eq has no kernel (the reference's compiler rejects
        use_pallas for it): its slabs take the plain sweep, fixed by the
        kind, and never reach the kernel wrappers."""
        obj = make_objective("assignment_eq", lp)
        assert {k for k, _ in obj._slab_proj} == {"simplex_eq"}

        def refuse(*a, **k):
            raise AssertionError("a simplex_eq slab reached a kernel")
        monkeypatch.setattr(kops, "dual_x_full", refuse)
        monkeypatch.setattr(kops, "dual_grad_full", refuse)
        g, grad, _ = obj.calculate(torch.zeros(obj.dual_shape), GAMMA)
        assert np.isfinite(float(g)) and torch.isfinite(grad).all()

    def test_equality_override_runs_the_plain_sweep(self, lp, monkeypatch):
        """An override to simplex_eq sends that slab alone to the plain
        sweep; the other slabs keep the kernel."""
        form = Formulation(name="ov", families=(DestCapacityFamily(),),
                           block=BlockConstraint(
                               kind="boxcut", overrides={0: "simplex_eq"}))
        obj = compile_formulation(form, lp)
        kinds = []
        real = kops.dual_x_full

        def spy(slab, lam, gamma, proj_kind="boxcut", *a, **k):
            kinds.append(proj_kind)
            return real(slab, lam, gamma, proj_kind, *a, **k)
        monkeypatch.setattr(kops, "dual_x_full", spy)
        obj.calculate(torch.zeros(obj.dual_shape), GAMMA)
        assert obj._slab_proj[0][0] == "simplex_eq"
        assert kinds == ["boxcut"] * (len(lp.slabs) - 1)

    def test_duplicate_labels_rejected(self, lp):
        with pytest.raises(ValueError, match="labels must be unique"):
            Formulation(name="dup", families=(
                DestCapacityFamily(),
                GlobalBudgetFamily(limit=1.0),
                GlobalBudgetFamily(limit=2.0, weight="value"),
            )).validate(lp.m)


class TestRowLayout:
    def test_dual_shape_and_slices(self, lp):
        obj = make_objective("multi_budget", lp)
        m, J = lp.m, lp.num_destinations
        assert obj.dual_shape == (m * J + 2,)
        sl = obj.row_slices()
        assert sl["dest_capacity"] == slice(0, m * J)
        assert sl["count_cap"] == slice(m * J, m * J + 1)
        assert sl["value_cap"] == slice(m * J + 1, m * J + 2)

    def test_family_subset_slicing(self, lp):
        form = Formulation(name="sub", families=(
            DestCapacityFamily(lp_families=(1,)),))
        obj = compile_formulation(form, lp)
        assert obj.dual_shape == (lp.num_destinations,)
        _, grad, _ = obj.calculate(torch.zeros(obj.dual_shape), GAMMA)
        _, grad2, _ = MatchingObjective(lp).calculate(
            torch.zeros((lp.m, lp.num_destinations)), GAMMA)
        np.testing.assert_allclose(grad.numpy(), grad2.numpy()[1],
                                   rtol=1e-5)


class TestLegacyParity:
    """matching / global_count through the formulations equal the
    hand-written classes bit for bit."""

    def test_matching_value_and_grad_exact(self, lp_pc):
        legacy = MatchingObjective(lp_pc)
        comp = make_objective("matching", lp_pc)
        lam = _lam(legacy.dual_shape, 0, 1.0)
        for gamma in (0.02, 0.1, 0.7):
            g = torch.tensor(gamma)
            g0, gr0, aux0 = legacy.calculate(lam, g)
            g1, gr1, aux1 = comp.calculate(lam.reshape(-1), g)
            assert float(g0) == float(g1)
            assert torch.equal(gr0.reshape(-1), gr1)
            assert float(aux0.infeas) == float(aux1.infeas)

    def test_global_count_value_and_grad_exact(self, lp):
        legacy = GlobalCountObjective(lp, count=8.0)
        comp = make_objective("global_count", lp, params=dict(count=8.0))
        assert comp.dual_shape == legacy.dual_shape
        lam = _lam(legacy.dual_shape, 2, 0.5)
        g0, gr0, _ = legacy.calculate(lam, GAMMA)
        g1, gr1, _ = comp.calculate(lam, GAMMA)
        assert float(g0) == float(g1)
        assert torch.equal(gr0, gr1)

    @pytest.mark.parametrize("ax_mode", MODES)
    def test_matching_solve_trajectory_bitwise(self, lp_pc, ax_mode):
        legacy = Maximizer(CFG).maximize(
            MatchingObjective(lp_pc, ax_mode=ax_mode))
        comp = Maximizer(CFG).maximize(
            make_objective("matching", lp_pc, ax_mode=ax_mode))
        np.testing.assert_array_equal(legacy.stats.dual_obj,
                                      comp.stats.dual_obj)
        assert torch.equal(legacy.lam.reshape(-1), comp.lam)

    def test_global_count_solve_trajectory_bitwise(self, lp):
        legacy = Maximizer(CFG).maximize(GlobalCountObjective(lp, count=8.0))
        comp = Maximizer(CFG).maximize(
            make_objective("global_count", lp, params=dict(count=8.0)))
        np.testing.assert_array_equal(legacy.stats.dual_obj,
                                      comp.stats.dual_obj)
        assert torch.equal(legacy.lam, comp.lam)

    def test_global_count_primal_matches_composed(self, lp):
        legacy = GlobalCountObjective(lp, count=8.0)
        comp = make_objective("global_count", lp, params=dict(count=8.0))
        lam = _lam(legacy.dual_shape, 7, 0.5)
        xs_legacy = legacy.primal(lam, GAMMA)
        xs_comp = comp.primal(lam, GAMMA)
        assert len(xs_legacy) == len(xs_comp)
        for a, b in zip(xs_legacy, xs_comp):
            assert torch.equal(a, b)

    def test_global_count_primal_uses_mu(self, lp):
        """μ shifts u: a large μ suppresses x."""
        obj = GlobalCountObjective(lp, count=8.0)
        lam0 = torch.zeros(obj.dual_shape)
        lam_mu = lam0.clone()
        lam_mu[-1] = 1e3
        x0 = sum(float(x.sum()) for x in obj.primal(lam0, GAMMA))
        x1 = sum(float(x.sum()) for x in obj.primal(lam_mu, GAMMA))
        assert x0 > 0.0 and x1 < x0


DEEP_CFG = SolveConfig(iterations=4000, gamma=0.05, gamma_init=0.8,
                       gamma_decay_every=25, max_step=20.0,
                       initial_step=1e-3)
CRIT = StoppingCriteria(tol_rel_dual=1e-5, check_every=50)


class TestMultiBudget:
    def test_solves_to_tolerance(self, lp):
        obj = make_objective("multi_budget", lp, row_norm=True)
        res = Maximizer(DEEP_CFG).maximize(obj, criteria=CRIT)
        assert res.converged, (res.stop_reason, res.iterations_run)

    def test_tight_caps_bind_and_are_respected(self, lp):
        m_obj = make_objective("matching", lp, row_norm=True)
        m_res = Maximizer(DEEP_CFG).maximize(m_obj, criteria=CRIT)
        xs = m_obj.primal(m_res.lam, torch.tensor(DEEP_CFG.gamma))
        count_used = sum(float(x.sum()) for x in xs)
        value_used = -float(m_res.stats.primal_obj[-1])
        caps = dict(count_cap=0.5 * count_used, value_cap=0.7 * value_used)
        obj = make_objective("multi_budget", lp, params=caps, row_norm=True)
        res = Maximizer(DEEP_CFG).maximize(obj, criteria=CRIT)
        assert res.converged
        usage = obj.global_usage(res.lam, torch.tensor(DEEP_CFG.gamma))
        for label, (used, limit) in usage.items():
            assert used <= limit * 1.02, (label, used, limit)
            assert used >= limit * 0.9, (label, used, limit)

    def test_modes_agree(self, lp):
        """The reference's aligned-and-Pallas case: every ax mode (on the
        CPU, every kernel's plain version) against scatter."""
        objs = {mode: make_objective("multi_budget", lp, ax_mode=mode)
                for mode in MODES}
        lam = _lam(objs["scatter"].dual_shape, 5, 0.5)
        g0, gr0, _ = objs["scatter"].calculate(lam, GAMMA)
        for mode in MODES:
            g1, gr1, _ = objs[mode].calculate(lam, GAMMA)
            np.testing.assert_allclose(float(g1), float(g0), rtol=1e-5)
            np.testing.assert_allclose(gr1.numpy(), gr0.numpy(), rtol=1e-4,
                                       atol=1e-4)

    def test_aligned_solve_matches_scatter(self, lp):
        res = {mode: Maximizer(CFG).maximize(make_objective(
            "multi_budget", lp, row_norm=True, ax_mode=mode))
            for mode in ("scatter", "aligned")}
        a = res["scatter"].stats.dual_obj
        rel = np.abs((res["aligned"].stats.dual_obj - a)
                     / np.maximum(np.abs(a), 1e-8)).max()
        assert rel < 1e-5, rel


class TestAssignmentEq:
    def test_solves_to_tolerance(self, lp):
        obj = make_objective("assignment_eq", lp, row_norm=True)
        res = Maximizer(DEEP_CFG).maximize(obj, criteria=CRIT)
        assert res.converged, (res.stop_reason, res.iterations_run)
        xs = obj.primal(res.lam, torch.tensor(DEEP_CFG.gamma))
        for x, slab in zip(xs, obj.lp.slabs):
            rows = torch.where(slab.mask, x, 0.0).sum(dim=-1)
            np.testing.assert_allclose(rows.numpy(), slab.s.numpy(),
                                       atol=5e-2)

    def test_dual_matches_lp_reference(self, lp, lp_ref):
        """The converged dual's primal value approaches the LP optimum of
        an independent dense simplex solve."""
        scipy_opt = pytest.importorskip("scipy.optimize")
        form = formulations.build("assignment_eq", lp)
        A, c, edges = rinst.to_dense(lp_ref, 120, 19)
        srcs = sorted(set(e[0] for e in edges))
        Aeq = np.zeros((len(srcs), len(edges)))
        for col, (i, j, cv, av) in enumerate(edges):
            Aeq[srcs.index(i), col] = 1.0
        ref = scipy_opt.linprog(
            c, A_ub=A, b_ub=np.asarray(form.dest.rhs).reshape(-1),
            A_eq=Aeq, b_eq=np.ones(len(srcs)), bounds=(0, 1.0),
            method="highs")
        assert ref.status == 0
        obj = make_objective("assignment_eq", lp, row_norm=True)
        res = Maximizer(DEEP_CFG).maximize(obj, criteria=CRIT)
        assert res.converged
        lp_obj = float(res.stats.primal_obj[-1])
        assert abs(lp_obj - ref.fun) < 0.02 * abs(ref.fun), (lp_obj, ref.fun)

    def test_modes_agree(self, lp):
        objs = {mode: make_objective("assignment_eq", lp, ax_mode=mode)
                for mode in MODES}
        lam = _lam(objs["scatter"].dual_shape, 7, 0.5)
        g0, gr0, _ = objs["scatter"].calculate(lam, GAMMA)
        for mode in MODES:
            g1, gr1, _ = objs[mode].calculate(lam, GAMMA)
            np.testing.assert_allclose(float(g1), float(g0), rtol=1e-5)
            np.testing.assert_allclose(gr1.numpy(), gr0.numpy(), rtol=1e-4,
                                       atol=1e-4)

    def test_rhs_equals_reference(self, lp, lp_ref):
        """`even_spread_load` sums with bincount; the float32 rhs equals
        the reference's (np.add.at) bit for bit."""
        for headroom in (1.0, 1.25, 3.0):
            port = formulations.build("assignment_eq", lp, headroom=headroom)
            ref = rformulations.build("assignment_eq", lp_ref,
                                      headroom=headroom)
            np.testing.assert_array_equal(np.asarray(port.dest.rhs),
                                          np.asarray(ref.dest.rhs))


# --- against the reference ------------------------------------------------

def _one_shot(name, lp, lp_ref, mode, row_norm, seed):
    obj = make_objective(name, lp, ax_mode=mode, row_norm=row_norm)
    robj = rformulations.make_objective(name, lp_ref, ax_mode=mode,
                                        row_norm=row_norm)
    assert obj.dual_shape == robj.dual_shape
    assert obj.row_slices() == robj.row_slices()
    lam = np.random.default_rng(seed).uniform(0, 0.5, obj.dual_shape).astype(
        np.float32)
    g_r, gr_r, aux_r = jax.jit(robj.calculate)(jnp.asarray(lam),
                                                jnp.float32(0.1))
    g_t, gr_t, aux_t = obj.calculate(torch.from_numpy(lam), GAMMA)
    gr_r = np.asarray(gr_r)
    assert abs(float(g_t) - float(g_r)) <= 1e-6 * abs(float(g_r))
    assert (np.abs(gr_t.numpy() - gr_r).max()
            <= 1e-6 * max(1.0, float(np.abs(gr_r).max())))
    for f in ("primal_obj", "x_sq"):
        np.testing.assert_allclose(float(getattr(aux_t, f)),
                                   float(getattr(aux_r, f)), rtol=1e-5)
    return obj, robj, lam


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", FORMS)
def test_calculate_matches_reference(lp, lp_ref, name, mode):
    _one_shot(name, lp, lp_ref, mode, False, 3)


@pytest.mark.parametrize("name", FORMS)
def test_calculate_matches_reference_row_norm(lp, lp_ref, name):
    obj, robj, lam = _one_shot(name, lp, lp_ref, "aligned", True, 4)
    # σ of every coupling row, and the limits it scales
    np.testing.assert_allclose(obj._scales, robj._scales, rtol=1e-6)
    np.testing.assert_allclose(obj._limits, robj._limits, rtol=1e-6)
    # primal recovery with the coupling shifts, and its row-subset form
    xs_t = obj.primal(torch.from_numpy(lam), GAMMA)
    xs_r = robj.primal(jnp.asarray(lam), jnp.float32(0.1))
    for a, b in zip(xs_t, xs_r):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    rows = torch.tensor([0, 3, 3, 1])
    for si, x in enumerate(xs_t):
        got = obj.primal_rows(torch.from_numpy(lam), GAMMA, si,
                              rows[rows < x.shape[0]])
        assert torch.equal(got, x[rows[rows < x.shape[0]]])


def test_lp_family_weight_and_rhs_scale_match_reference(lp, lp_ref):
    """A weighted ("lp_family", 1) row over a family-0 slice with a scaled
    rhs: weights from the un-sliced LP, as the reference reads them."""
    form_kw = dict(name="lpfam", families=(
        DestCapacityFamily(lp_families=(0,), rhs_scale=0.8),
        GlobalBudgetFamily(limit=3.0, weight=("lp_family", 1),
                           label="fam1")))
    for row_norm in (False, True):
        obj = compile_formulation(Formulation(**form_kw), lp,
                                  row_norm=row_norm)
        robj = rformulations.compile_formulation(
            rformulations.Formulation(
                name="lpfam", families=(
                    rformulations.DestCapacityFamily(lp_families=(0,),
                                                     rhs_scale=0.8),
                    rformulations.GlobalBudgetFamily(
                        limit=3.0, weight=("lp_family", 1), label="fam1"))),
            lp_ref, ax_mode="aligned", row_norm=row_norm)
        lam = np.random.default_rng(9).uniform(0, 0.5, obj.dual_shape).astype(
            np.float32)
        g_t, gr_t, _ = obj.calculate(torch.from_numpy(lam), GAMMA)
        g_r, gr_r, _ = robj.calculate(jnp.asarray(lam), jnp.float32(0.1))
        assert abs(float(g_t) - float(g_r)) <= 1e-6 * abs(float(g_r))
        np.testing.assert_allclose(gr_t.numpy(), np.asarray(gr_r),
                                   atol=1e-6 * max(1.0, float(
                                       np.abs(np.asarray(gr_r)).max())))


PARITY_SPEC = dict(num_sources=2000, num_destinations=100,
                   avg_nnz_per_row=8, seed=42)
PARITY_CFG = dict(iterations=3000, gamma=0.01, max_step=1e-1,
                  initial_step=1e-5)
PARITY_CRIT = dict(tol_rel_dual=1e-5, tol_infeas_rel=1e-3, check_every=25)


@pytest.mark.parametrize("name", ["global_count", "multi_budget",
                                  "assignment_eq"])
def test_trajectory_matches_reference(name):
    """agd to tolerance, row-normalized, aligned, on a 2000 x 100
    instance: the final dual within 1e-4 relative of the reference's, and
    the stop within one check of where the reference's aligned and scatter
    lowerings stop (at this tolerance the stop moves with the order of the
    float32 sums alone)."""
    lp = lp_to_torch(generate(InstanceSpec(**PARITY_SPEC)), "cpu")
    lp_ref = jax.tree.map(jnp.asarray, rinst.generate(
        rinst.InstanceSpec(**PARITY_SPEC)))
    res = Maximizer(SolveConfig(**PARITY_CFG)).maximize(
        make_objective(name, lp, row_norm=True),
        criteria=StoppingCriteria(**PARITY_CRIT))
    refs = [RMaximizer(RSolveConfig(**PARITY_CFG)).maximize(
        rformulations.make_objective(name, lp_ref, ax_mode=mode,
                                     row_norm=True),
        criteria=RStoppingCriteria(**PARITY_CRIT))
        for mode in ("aligned", "scatter")]
    assert res.converged and all(r.converged for r in refs)
    d, rd = float(res.stats.dual_obj[-1]), float(refs[0].stats.dual_obj[-1])
    assert abs(d - rd) <= 1e-4 * abs(rd), (d, rd)
    stops = [r.iterations_run for r in refs]
    check = PARITY_CRIT["check_every"]
    assert min(stops) - check <= res.iterations_run <= max(stops) + check, (
        res.iterations_run, stops)
