"""The port's certificate of `GlobalCountObjective` (its global count row,
ROADMAP queue C1) against the JAX package's, on a 200 × 20 instance
(ν = 8, seed 3).

At a binding count (5, where the unrepaired witness sums to 75.8) and at
a slack one (1e6): the same families, the same validity, the gap within
1e-4·max(1, |primal value|), the global row's use and limit, and the
repaired witness itself.  The count row's `row_scale` σ writes the same
constraint, so the certificate does not depend on it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GlobalCountObjective as RCount
from repro.core import MatchingObjective as RMatching
from repro.core import instance as rinst
from repro.primal import certify as rcertify
from repro.primal import extract_primal as rextract
from repro.primal.certify import global_row_caps as rcaps
from repro.primal.certify import repair_witness as rrepair
from repro_torch.convert import lp_to_torch
from repro_torch.core import GlobalCountObjective, MatchingObjective
from repro_torch.core import Maximizer, SolveConfig, instance
from repro_torch.primal import (certify, extract_primal, format_certificate,
                                global_row_caps, repair_witness)

SPEC = dict(num_sources=200, num_destinations=20, avg_nnz_per_row=8, seed=3)
GAMMA = 0.1


@pytest.fixture(scope="module")
def lps():
    lp_r = jax.tree.map(jnp.asarray, rinst.generate(rinst.InstanceSpec(**SPEC)))
    lp_t = lp_to_torch(instance.generate(instance.InstanceSpec(**SPEC)), "cpu")
    return lp_r, lp_t


def _lam(obj_t, solved):
    if not solved:
        return np.zeros(obj_t.dual_shape, np.float32)
    res = Maximizer(SolveConfig(iterations=40, gamma=GAMMA, max_step=0.05,
                                initial_step=1e-4)).maximize(obj_t)
    return res.lam.numpy()


@pytest.mark.parametrize("solved", [False, True], ids=["lam0", "lam40"])
@pytest.mark.parametrize("count", [5.0, 1e6], ids=["binding", "slack"])
def test_certificate_matches_reference(lps, count, solved):
    lp_r, lp_t = lps
    obj_r, obj_t = RCount(lp_r, count=count), GlobalCountObjective(
        lp_t, count=count)
    lam = _lam(obj_t, solved)
    c_r = rcertify(obj_r, jnp.asarray(lam), jnp.float32(GAMMA))
    c_t = certify(obj_t, torch.from_numpy(lam), np.float32(GAMMA),
                  chunk_rows=64)
    assert list(c_t.slacks) == list(c_r.slacks) == [
        "dest_capacity", "global_count", "blocks"]
    assert c_t.valid == c_r.valid and c_t.feasible == c_r.feasible
    scale = max(1.0, abs(c_r.primal_value))
    assert abs(c_t.gap - c_r.gap) <= 1e-4 * scale
    assert abs(c_t.primal_value - c_r.primal_value) <= 1e-4 * scale
    g_t, g_r = c_t.slacks["global_count"], c_r.slacks["global_count"]
    assert g_t.kind == g_r.kind == "global"
    assert g_t.limit == g_r.limit == count
    assert abs(g_t.used - g_r.used) <= 1e-5 * max(1.0, g_r.used)
    assert g_t.used <= count
    lines = format_certificate(c_t).splitlines()
    assert any(line.startswith("family global_count     used ")
               and f"/ limit {count:.3f}" in line for line in lines)


def test_binding_count_repairs_the_witness(lps):
    """At count 5 the extracted point sums to ~75.8; `repair_witness`
    shrinks it onto the count, as the reference's does."""
    lp_r, lp_t = lps
    obj_r, obj_t = RCount(lp_r, count=5.0), GlobalCountObjective(
        lp_t, count=5.0)
    lam = np.zeros(obj_t.dual_shape, np.float32)
    xs_r = rrepair(obj_r, rextract(obj_r, jnp.asarray(lam),
                                   jnp.float32(GAMMA)))
    raw_t = extract_primal(obj_t, torch.from_numpy(lam), np.float32(GAMMA))
    assert sum(float(x.sum()) for x in raw_t) > 10 * 5.0
    xs_t = repair_witness(obj_t, raw_t)
    for a, b in zip(xs_t, xs_r):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-7)
    assert sum(float(x.sum()) for x in xs_t) <= 5.0
    assert global_row_caps(obj_t) == rcaps(obj_r) == [(None, 5.0)]
    assert global_row_caps(MatchingObjective(lp_t)) == rcaps(
        RMatching(lp_r)) == []


def test_row_scale_does_not_change_the_certificate(lps):
    """σ·Σx <= σ·count is the constraint Σx <= count: used and limit are
    in count units whatever σ."""
    _, lp_t = lps
    lam = np.zeros(GlobalCountObjective(lp_t, count=5.0).dual_shape,
                   np.float32)
    c1, c2 = (certify(GlobalCountObjective(lp_t, count=5.0, row_scale=s),
                      torch.from_numpy(lam), np.float32(GAMMA))
              for s in (1.0, 0.05))
    assert c1.slacks["global_count"] == c2.slacks["global_count"]
    assert c1.gap == c2.gap and c1.valid and c2.valid


def test_matching_objective_has_no_global_family(lps):
    lp_r, lp_t = lps
    lam = np.zeros((lp_t.m, lp_t.num_destinations), np.float32)
    c_t = certify(MatchingObjective(lp_t), torch.from_numpy(lam),
                  np.float32(GAMMA))
    c_r = rcertify(RMatching(lp_r), jnp.asarray(lam), jnp.float32(GAMMA))
    assert list(c_t.slacks) == list(c_r.slacks) == ["dest_capacity",
                                                    "blocks"]
    assert abs(c_t.gap - c_r.gap) <= 1e-4 * max(1.0, abs(c_r.primal_value))


@pytest.mark.parametrize("name", ["global_count", "multi_budget",
                                  "assignment_eq"])
def test_composed_certificate_matches_reference(lps, name):
    """A compiled formulation's certificate (its `family_report`, the
    per-slab block kinds, the uniform repair over every violated coupling
    row) against the reference's: the same families, the same verdict,
    the slacks and the gap to 1e-4 of their scale, the relative
    violations to 1e-6.  assignment_eq's
    shrunk witness breaks Σx = s and comes back INVALID in both."""
    from repro import formulations as rformulations
    from repro_torch import formulations
    lp_r, lp_t = lps
    obj_t = formulations.make_objective(name, lp_t, row_norm=True)
    obj_r = rformulations.make_objective(name, lp_r, ax_mode="aligned",
                                         row_norm=True)
    lam = _lam(obj_t, True)
    c_r = rcertify(obj_r, jnp.asarray(lam), jnp.float32(GAMMA))
    c_t = certify(obj_t, torch.from_numpy(lam), np.float32(GAMMA),
                  chunk_rows=64)
    assert list(c_t.slacks) == list(c_r.slacks)
    assert c_t.valid == c_r.valid and c_t.feasible == c_r.feasible
    assert c_t.valid == (name != "assignment_eq")
    scale = max(1.0, abs(c_r.primal_value))
    assert abs(c_t.gap - c_r.gap) <= 1e-4 * scale
    for label, s_r in c_r.slacks.items():
        s_t = c_t.slacks[label]
        assert s_t.kind == s_r.kind and s_t.limit == pytest.approx(s_r.limit)
        assert abs(s_t.used - s_r.used) <= 1e-4 * max(1.0, abs(s_r.used))
        # relative violations to a tenth of the certificate's 1e-5
        assert abs(s_t.violation_rel - s_r.violation_rel) <= 1e-6
