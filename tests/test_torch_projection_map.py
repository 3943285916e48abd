"""The port's ProjectionMap, per-slab projection table, safeguarded-Newton
projection and exact host oracle, against the JAX package's.

Mirrors tests/test_projection_map.py: `MatchingObjective` honours a map's
per-bucket overrides and its iteration count in `calculate` and `primal`.
A kind with a kernel (box, simplex, boxcut) runs it, with the reference's
kernel semantics: `box` keeps the slab's budget s there, as the
reference's Pallas path does (its jnp path drops s), so the port's `box`
is held to the reference's `use_pallas=True` objective (interpret mode).
The kinds without a kernel (simplex_eq, boxcut_newton) run the plain sweep
and are held to the reference's jnp objective.

Newton against the reference's `project_boxcut_newton` and the exact
sort-based oracle at atol 1e-6 once τ has settled (40 steps).  At
`project`'s cap of 12 steps a row whose active set has not settled sits
up to 3e-3 from the exact τ in either package, and which rows those are
turns on an ulp of the float32 row sum (whether a Newton step lands
inside the bracket), so there both are held to the oracle at 5e-3.  The
port's oracle equals the reference's bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MatchingObjective as RObjective
from repro.core import ProjectionMap as RProjectionMap
from repro.core import instance as rinst
from repro.core import precondition as rprecondition
from repro.core import projections as rproj
from repro_torch.convert import lp_to_torch
from repro_torch.core import (InstanceSpec, MatchingObjective, ProjectionMap,
                              generate, precondition)
from repro_torch.core import objectives, projections

SPEC = dict(num_sources=40, num_destinations=8, avg_nnz_per_row=10, seed=11)
GAMMA = torch.tensor(0.1)


@pytest.fixture(scope="module")
def lp():
    lp, _ = precondition(lp_to_torch(generate(InstanceSpec(**SPEC)), "cpu"),
                         row_norm=True)
    assert len(lp.slabs) >= 2, "need a multi-bucket instance"
    return lp


@pytest.fixture(scope="module")
def lp_ref():
    lp = jax.tree.map(jnp.asarray, rinst.generate(rinst.InstanceSpec(**SPEC)))
    return rprecondition(lp, row_norm=True)[0]


def _zeros(lp):
    return torch.zeros((lp.m, lp.num_destinations))


# every ub and s here is 1, so at γ = 0.1 every row sits on its cut and
# the box-cut kinds coincide; at γ = 30, u = −c/γ is small enough that
# boxcut rows sum below their budget, where simplex_eq fills it
GAMMA_WIDE = torch.tensor(30.0)


class TestProjectionMapLookup:
    def test_kind_and_iters_overrides(self):
        pm = ProjectionMap("boxcut", overrides={1: "box", 2: ("simplex", 5)},
                           iters=23)
        assert pm.kind_for(0) == "boxcut" and pm.iters_for(0) == 23
        assert pm.kind_for(1) == "box" and pm.iters_for(1) == 23
        assert pm.kind_for(2) == "simplex" and pm.iters_for(2) == 5

    def test_objective_table(self, lp):
        pm = ProjectionMap("boxcut", overrides={0: ("simplex_eq", 9)},
                           iters=17)
        obj = MatchingObjective(lp, projection_map=pm)
        assert obj._slab_proj == tuple(
            (pm.kind_for(i), pm.iters_for(i)) for i in range(len(lp.slabs)))
        one = MatchingObjective(lp, proj_kind="simplex", proj_iters=11)
        assert set(one._slab_proj) == {("simplex", 11)}


class TestObjectiveHonorsMap:
    @pytest.mark.parametrize("override", ["simplex_eq", "boxcut"])
    def test_heterogeneous_overrides_change_the_objective(self, lp,
                                                          override):
        """The override reaches the slab sweep, on the plain route
        (simplex_eq against boxcut) and on the kernel's (boxcut against
        simplex_eq)."""
        other = "boxcut" if override == "simplex_eq" else "simplex_eq"
        obj = MatchingObjective(lp, projection_map=ProjectionMap(
            other, overrides={0: override}, iters=40))
        uniform = MatchingObjective(lp, proj_kind=other, proj_iters=40)
        g_o, grad_o, _ = obj.calculate(_zeros(lp), GAMMA_WIDE)
        g_u, grad_u, _ = uniform.calculate(_zeros(lp), GAMMA_WIDE)
        assert not np.allclose(grad_o.numpy(), grad_u.numpy())
        assert abs(float(g_o) - float(g_u)) > 0

    def test_matches_manual_per_bucket_composition(self, lp):
        """calculate() under a heterogeneous map equals composing the
        per-slab contributions with each bucket's own (kind, iters)."""
        pm = ProjectionMap("boxcut",
                           overrides={0: "simplex_eq", 1: ("boxcut", 7)},
                           iters=31)
        obj = MatchingObjective(lp, projection_map=pm, ax_mode="scatter")
        lam = torch.from_numpy(np.random.default_rng(0).uniform(
            0, 0.5, (lp.m, lp.num_destinations)).astype(np.float32))
        g, grad, _ = obj.calculate(lam, GAMMA)
        J = lp.num_destinations
        ax = torch.zeros((lp.m, J))
        c_x = torch.zeros(())
        x_sq = torch.zeros(())
        for i, slab in enumerate(lp.slabs):
            ax_s, c_s, sq_s = objectives.slab_contribution(
                slab, lam, GAMMA, J, pm.kind_for(i),
                proj_iters=pm.iters_for(i))
            ax, c_x, x_sq = ax + ax_s, c_x + c_s, x_sq + sq_s
        grad_want = ax - lp.b
        g_want = c_x + 0.5 * GAMMA * x_sq + torch.sum(lam * grad_want)
        np.testing.assert_allclose(grad.numpy(), grad_want.numpy(),
                                   atol=1e-6)
        assert float(g) == pytest.approx(float(g_want), rel=1e-5)

    def test_primal_recovery_uses_map(self, lp):
        """Bucket 0 projected as simplex_eq fills every row's budget,
        where boxcut leaves rows below it."""
        obj = MatchingObjective(lp, projection_map=ProjectionMap(
            "boxcut", overrides={0: "simplex_eq"}, iters=40))
        slab0 = lp.slabs[0]
        real = slab0.mask.any(dim=-1)
        x0 = obj.primal(_zeros(lp), GAMMA_WIDE)[0]
        sums = torch.where(slab0.mask, x0, 0.0).sum(dim=-1)
        np.testing.assert_allclose(sums[real].numpy(),
                                   slab0.s[real].numpy(), atol=1e-3)
        xs_u = MatchingObjective(lp, proj_kind="boxcut").primal(
            _zeros(lp), GAMMA_WIDE)
        sums_u = torch.where(slab0.mask, xs_u[0], 0.0).sum(dim=-1)
        assert (sums_u[real] < slab0.s[real] - 1e-3).any()
        assert (sums_u <= slab0.s + 1e-3).all()

    def test_map_iters_respected(self, lp):
        coarse = MatchingObjective(lp, projection_map=ProjectionMap(
            "boxcut", iters=1))
        fine = MatchingObjective(lp, projection_map=ProjectionMap(
            "boxcut", iters=40))
        _, grad_c, _ = coarse.calculate(_zeros(lp), GAMMA)
        _, grad_f, _ = fine.calculate(_zeros(lp), GAMMA)
        assert not np.allclose(grad_c.numpy(), grad_f.numpy(), atol=1e-6)


@pytest.mark.parametrize("overrides,kind,use_pallas", [
    ({0: "simplex_eq", 1: ("boxcut", 7)}, "boxcut", False),
    ({0: ("boxcut_newton", 30)}, "boxcut", False),
    ({1: "simplex"}, "simplex_eq", False),
    ({0: "box"}, "boxcut", True),
], ids=["eq-and-iters", "newton", "simplex", "box-kernel-semantics"])
def test_map_matches_reference(lp, lp_ref, overrides, kind, use_pallas):
    """The same map through both packages' objectives, one calculate and
    the primal at γ = 0.1."""
    obj = MatchingObjective(lp, projection_map=ProjectionMap(
        kind, overrides=overrides, iters=25), ax_mode="scatter")
    robj = RObjective(lp_ref, projection_map=RProjectionMap(
        kind, overrides=overrides, iters=25), ax_mode="scatter",
        use_pallas=use_pallas)
    lam = np.random.default_rng(1).uniform(
        0, 0.5, obj.dual_shape).astype(np.float32)
    g_t, gr_t, _ = obj.calculate(torch.from_numpy(lam), GAMMA)
    g_r, gr_r, _ = robj.calculate(jnp.asarray(lam), jnp.float32(0.1))
    np.testing.assert_allclose(float(g_t), float(g_r), rtol=1e-6)
    np.testing.assert_allclose(gr_t.numpy(), np.asarray(gr_r), atol=1e-5)
    xs_t = obj.primal(torch.from_numpy(lam), GAMMA)
    xs_r = robj.primal(jnp.asarray(lam), jnp.float32(0.1))
    for a, b in zip(xs_t, xs_r):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def _rows(seed, n, w, scale):
    rng = np.random.default_rng(seed)
    v = rng.normal(0, scale, (n, w)).astype(np.float32)
    deg = rng.integers(1, w + 1, n)
    mask = np.arange(w)[None, :] < deg[:, None]
    ub = rng.uniform(0.1, 2.0, (n, w)).astype(np.float32)
    s = (rng.uniform(0.05, 0.9, n) * np.where(mask, ub, 0).sum(1)).astype(
        np.float32)
    return v, ub, s, mask


@pytest.mark.parametrize("iters,atol", [(40, 1e-6), (12, 5e-3)])
@pytest.mark.parametrize("w,scale", [(4, 1.0), (17, 3.0), (64, 0.5),
                                     (256, 2.0)])
def test_newton_matches_reference_and_exact_oracle(w, scale, iters, atol):
    v, ub, s, mask = _rows(w, 37, w, scale)
    ref = np.asarray(rproj.project_boxcut_newton(
        jnp.asarray(v), jnp.asarray(ub), jnp.asarray(s), jnp.asarray(mask),
        iters=iters))
    got = projections.project_boxcut_newton(
        torch.from_numpy(v), torch.from_numpy(ub), torch.from_numpy(s),
        torch.from_numpy(mask), iters=iters).numpy()
    assert (got[~mask] == 0).all()
    if iters == 40:
        np.testing.assert_allclose(got, ref, atol=atol)
    for r in range(v.shape[0]):
        m = mask[r]
        exact = projections.project_boxcut_exact_1d(v[r][m], ub[r][m],
                                                    float(s[r]))
        np.testing.assert_allclose(got[r][m], exact, atol=atol)
        np.testing.assert_allclose(ref[r][m], exact, atol=atol)


def test_project_dispatch_caps_newton_steps():
    v, ub, s, mask = (torch.from_numpy(a) for a in _rows(5, 20, 16, 2.0))
    assert torch.equal(
        projections.project("boxcut_newton", v, ub, s, mask, iters=40),
        projections.project_boxcut_newton(v, ub, s, mask, iters=12))


@pytest.mark.parametrize("equality", [False, True])
@pytest.mark.parametrize("w", [1, 5, 33])
def test_exact_oracle_equals_reference(w, equality):
    rng = np.random.default_rng(w)
    for _ in range(5):
        v = rng.normal(0, 3, w).astype(np.float32)
        ub = rng.uniform(0.1, 2.0, w).astype(np.float32)
        s = float(rng.uniform(0.05, 1.2) * ub.sum())
        np.testing.assert_array_equal(
            projections.project_boxcut_exact_1d(v, ub, s, equality),
            rproj.project_boxcut_exact_1d(v, ub, s, equality))
