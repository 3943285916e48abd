"""The port's gvals path on the CPU: `aligned_gvals` against `aligned`, the
functional `dual_value_and_grad` and `GlobalCountObjective` against the
JAX package's.

Same instance, same seeded λ through both.  Tolerances as in
test_torch_objective.py: g and the aux scalars at rtol 1e-5, ∇g at an
absolute 1e-5·max(1, |b|) (float32 sums in another order), x at atol 1e-5
at γ = 0.16.  `aligned_gvals` against `aligned` in the port is exact: the
plain versions form the same products and sum them in the same order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GlobalCountObjective as RCount
from repro.core import MatchingObjective as RObjective
from repro.core import dual_value_and_grad as r_dual_value_and_grad
from repro.core import instance as rinst
from repro.core import precondition as rprecondition
from repro_torch.convert import lam_to_numpy, lam_to_torch, lp_to_torch
from repro_torch.core import (GlobalCountObjective, MatchingObjective,
                              Maximizer, SolveConfig, StoppingCriteria,
                              dual_value_and_grad)
from repro_torch.core import instance as tinst
from repro_torch.core import precondition as tprecondition

SPEC = dict(num_sources=400, num_destinations=37, avg_nnz_per_row=7, seed=9,
            num_families=2)


@pytest.fixture(scope="module")
def lps():
    lp_r, _ = jax.jit(rprecondition)(jax.tree.map(
        jnp.asarray, rinst.generate(rinst.InstanceSpec(**SPEC))))
    lp_t, _ = tprecondition(lp_to_torch(
        tinst.generate(tinst.InstanceSpec(**SPEC)), "cpu"), row_norm=True)
    return lp_r, lp_t


def _lam(shape, seed=7, scale=1.0):
    return np.random.default_rng(seed).uniform(0, scale, shape).astype(
        np.float32)


def _assert_calculate_close(got, want, b):
    g_t, grad_t, aux_t = got
    g_r, grad_r, aux_r = want
    np.testing.assert_allclose(float(g_t), float(g_r), rtol=1e-5)
    bscale = max(1.0, float(np.abs(np.asarray(b)).max()))
    np.testing.assert_allclose(lam_to_numpy(grad_t), np.asarray(grad_r),
                               rtol=1e-5, atol=1e-5 * bscale)
    for f in ("primal_obj", "x_sq", "infeas"):
        np.testing.assert_allclose(float(getattr(aux_t, f)),
                                   float(getattr(aux_r, f)), rtol=1e-5,
                                   atol=1e-6)


def test_aligned_gvals_equals_aligned_bitwise(lps):
    """One evaluation, then a 300-iteration small-step trajectory."""
    _, lp = lps
    objs = [MatchingObjective(lp, ax_mode=m)
            for m in ("aligned", "aligned_gvals")]
    lam = lam_to_torch(_lam(objs[0].dual_shape), "cpu")
    (g1, d1, a1), (g2, d2, a2) = (o.calculate(lam, torch.tensor(0.01))
                                  for o in objs)
    assert torch.equal(g1, g2) and torch.equal(d1, d2)
    assert all(torch.equal(u, v) for u, v in zip(a1, a2))
    cfg = SolveConfig(iterations=300, gamma=0.01, max_step=0.05)
    r1, r2 = (Maximizer(cfg).maximize(o) for o in objs)
    assert torch.equal(r1.lam, r2.lam)
    assert np.array_equal(r1.stats.dual_obj, r2.stats.dual_obj)


@pytest.mark.parametrize("gamma", [0.01, 0.16])
def test_dual_value_and_grad_matches(lps, gamma):
    lp_r, lp_t = lps
    lam = _lam((lp_t.m, lp_t.num_destinations), 3)
    want = jax.jit(r_dual_value_and_grad)(lp_r, jnp.asarray(lam),
                                          jnp.float32(gamma))
    got = dual_value_and_grad(lp_t, lam_to_torch(lam, "cpu"),
                              torch.tensor(gamma))
    _assert_calculate_close(got, want, lp_r.b)


def _count_pair(lps, mode, count):
    lp_r, lp_t = lps
    return (RCount(lp_r, count=count, ax_mode=mode),
            GlobalCountObjective(lp_t, count=count, ax_mode=mode))


@pytest.mark.parametrize("mode", ["aligned", "aligned_gvals", "scatter"])
def test_global_count_calculate_matches(lps, mode):
    obj_r, obj_t = _count_pair(lps, mode, count=60.0)
    assert obj_t.dual_shape == obj_r.dual_shape
    lam = _lam(obj_t.dual_shape, 5)
    lam[-1] = 0.4
    want = jax.jit(obj_r.calculate)(jnp.asarray(lam), jnp.float32(0.16))
    got = obj_t.calculate(lam_to_torch(lam, "cpu"), torch.tensor(0.16))
    _assert_calculate_close(got, want, lps[0].b)


def test_global_count_primal_and_rows_match(lps):
    obj_r, obj_t = _count_pair(lps, "aligned", count=60.0)
    lam = _lam(obj_t.dual_shape, 11)
    lam[-1] = 0.4
    gamma = 0.16
    xs_r = obj_r.primal(jnp.asarray(lam), jnp.float32(gamma))
    lam_t = lam_to_torch(lam, "cpu")
    xs_t = obj_t.primal(lam_t, torch.tensor(gamma))
    for si, (a, b) in enumerate(zip(xs_r, xs_t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
        rows = np.arange(0, obj_t.lp.slabs[si].n, 3)
        got = obj_t.primal_rows(lam_t, torch.tensor(gamma), si,
                                torch.from_numpy(rows))
        want = obj_r.primal_rows(jnp.asarray(lam), jnp.float32(gamma), si,
                                 jnp.asarray(rows))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        assert torch.equal(got, b[torch.from_numpy(rows)])


def test_global_count_constraint_binds():
    """As tests/test_solver.py's TestGlobalCount: with the count at half the
    unconstrained Σx the count row binds (μ > 0) and Σx stays within 1 %
    of the count."""
    spec = tinst.InstanceSpec(num_sources=30, num_destinations=8,
                              avg_nnz_per_row=10, seed=3)
    lp, _ = tprecondition(lp_to_torch(tinst.generate(spec), "cpu"),
                          row_norm=True)
    gamma = 0.1
    cfg = SolveConfig(iterations=3000, gamma=gamma, max_step=10.0,
                      initial_step=1e-3)
    deep = StoppingCriteria(tol_rel_dual=1e-7, tol_infeas=5e-5,
                            check_every=100)
    base = Maximizer(cfg).maximize(MatchingObjective(lp), criteria=deep)
    x_tot = sum(float(x.sum()) for x in MatchingObjective(lp).primal(
        base.lam, torch.tensor(gamma)))
    count = 0.5 * x_tot
    obj = GlobalCountObjective(lp, count=count, ax_mode="aligned_gvals")
    res = Maximizer(cfg).maximize(obj, criteria=deep)
    _, grad, _ = obj.calculate(res.lam, torch.tensor(gamma))
    assert float(grad[-1]) + count <= count * 1.01
    assert float(res.lam[-1]) > 0


def test_global_count_row_scale_is_the_same_constraint(lps):
    """σ·Σx <= σ·count at μ/σ is the σ = 1 row at μ: the same x, g and
    destination gradient, the count gradient times σ."""
    _, lp = lps
    sigma = 0.05
    base = GlobalCountObjective(lp, count=60.0)
    scaled = GlobalCountObjective(lp, count=60.0, row_scale=sigma)
    lam = lam_to_torch(_lam(base.dual_shape, 13), "cpu")
    lam[-1] = 0.4
    lam_s = lam.clone()
    lam_s[-1] = 0.4 / sigma
    gamma = torch.tensor(0.16)
    (g, d, _), (gs, ds, _) = (base.calculate(lam, gamma),
                              scaled.calculate(lam_s, gamma))
    np.testing.assert_allclose(float(gs), float(g), rtol=1e-6)
    np.testing.assert_allclose(ds[:-1].numpy(), d[:-1].numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(ds[-1]), sigma * float(d[-1]),
                               rtol=1e-5)
