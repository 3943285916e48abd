"""The port's integral rounding and repairs (`repro_torch.primal.rounding`)
against the JAX package's, and the coupling rows they respect.

Both are host numpy with the same arithmetic, so on the same host inputs
(the port's extracted x̂ of a 200 × 20 instance, the LP's numpy leaves)
the outputs are equal bit for bit.  `global_row_caps` of a compiled
multi_budget (σ taken back out of the weights) equals the reference's,
and `greedy_repair` under it is integral and feasible for every family.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import formulations as rformulations
from repro.primal import rounding as rrounding
from repro.primal.certify import global_row_caps as rcaps
from repro_torch import formulations
from repro_torch.convert import lp_to_numpy, lp_to_torch
from repro_torch.core import InstanceSpec, Maximizer, SolveConfig, generate
from repro_torch.primal import (extract_primal, family_slacks,
                                global_row_caps, greedy_repair, primal_ax,
                                threshold_round, topk_round)

SPEC = dict(num_sources=200, num_destinations=20, avg_nnz_per_row=8, seed=3)
GAMMA = 0.1


@pytest.fixture(scope="module")
def solved():
    lp_np = generate(InstanceSpec(**SPEC))
    lp = lp_to_torch(lp_np, "cpu")
    obj = formulations.make_objective("multi_budget", lp, row_norm=True)
    res = Maximizer(SolveConfig(iterations=200, gamma=GAMMA, max_step=0.05,
                                initial_step=1e-4)).maximize(obj)
    xs = extract_primal(obj, res.lam, np.float32(GAMMA))
    robj = rformulations.make_objective(
        "multi_budget", jax.tree.map(jnp.asarray, lp_np), row_norm=True)
    return obj, robj, lp_to_numpy(obj.lp), xs


@pytest.mark.parametrize("frac", [0.2, 0.5, 0.9])
def test_threshold_round_equals_reference(solved, frac):
    _, _, lp, xs = solved
    got = threshold_round(xs, lp, frac=frac)
    want = rrounding.threshold_round(xs, lp, frac=frac)
    for a, b, slab in zip(got, want, lp.slabs):
        np.testing.assert_array_equal(a, b)
        assert set(np.unique(a[slab.mask])) <= {0.0, 1.0}


@pytest.mark.parametrize("k", [1, 2, 5])
def test_topk_round_equals_reference(solved, k):
    _, _, lp, xs = solved
    got = topk_round(xs, lp, k=k)
    want = rrounding.topk_round(xs, lp, k=k)
    for a, b, slab in zip(got, want, lp.slabs):
        np.testing.assert_array_equal(a, b)
        assert ((a > 0).sum(axis=1) <= k).all()


def test_global_row_caps_equal_reference(solved):
    obj, robj, _, _ = solved
    got, want = global_row_caps(obj), rcaps(robj)
    assert len(got) == len(want) == 2
    (w0, l0), (w1, l1) = got
    assert w0 is None and want[0][0] is None and l0 == want[0][1]
    assert l1 == want[1][1]
    for a, b in zip(w1, want[1][0]):
        np.testing.assert_allclose(a, b, rtol=1e-6)


@pytest.mark.parametrize("with_rows", [False, True])
def test_greedy_repair_equals_reference(solved, with_rows):
    obj, _, lp, xs = solved
    rows = global_row_caps(obj) if with_rows else ()
    cand = threshold_round(xs, lp, frac=0.3)
    got = greedy_repair(cand, lp, xs_frac=xs, global_rows=rows)
    want = rrounding.greedy_repair(cand, lp, xs_frac=xs, global_rows=rows)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # integral and feasible: capacities, budgets, coupling rows
    assert (primal_ax(lp, got) <= np.asarray(lp.b, np.float64) + 1e-9).all()
    for slab, x in zip(lp.slabs, got):
        assert set(np.unique(x[slab.mask])) <= {0.0, 1.0}
        assert (x.sum(axis=1) <= slab.s + 1e-6).all()
    if with_rows:
        slacks = family_slacks(obj, got, lp)
        assert all(s.max_violation <= 1e-9 for s in slacks.values()
                   if s.kind == "global")


def test_greedy_repair_of_nothing(solved):
    _, _, lp, xs = solved
    zeros = [np.zeros_like(x) for x in xs]
    for a, b in zip(greedy_repair(zeros, lp),
                    rrounding.greedy_repair(zeros, lp)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.float32 and not a.any()


def test_family_slacks_match_reference(solved):
    """The composed families' report (the certificate's) against the
    reference's `family_report` at the same host point."""
    from repro.primal.certify import family_slacks as rslacks
    obj, robj, lp, xs = solved
    got, want = family_slacks(obj, xs, lp), rslacks(robj, xs)
    assert list(got) == list(want) == ["dest_capacity", "count_cap",
                                       "value_cap", "blocks"]
    for label in got:
        g, w = got[label], want[label]
        assert g.kind == w.kind and g.limit == pytest.approx(w.limit)
        assert g.used == pytest.approx(w.used, rel=1e-5, abs=1e-6)
        # the two packages' row-normalized LPs differ by float32 ulps:
        # the relative violations agree to the certificate's 1e-5
        assert abs(g.violation_rel - w.violation_rel) <= 1e-5
    assert torch.is_tensor(obj.lp.b)
