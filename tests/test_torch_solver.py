"""The port's solve engine (agd, chunked, γ-continuation) and certificate
against the JAX package's, on one generated row-normalized instance.

Trajectories are held by the dual objective and the stopping iteration,
not by λ (ROADMAP queue C: the reference's own equivalent lowerings drift
by ~1e-4 in λ over 300 iterations):
  * fixed 300 iterations at max_step 0.05 on queue C's fixture (120 × 19,
    two families): dual drift ≤ 1e-5 relative, max |Δλ| ≤ 1e-3;
  * tolerance-terminated at tol_rel_dual 1e-5: the same stop reason,
    final dual ≤ 1e-5 relative, the stopping iteration within ±25 (one
    check).  At 1e-6 the stop is decided at ~10 float32 ulps of g and
    moves by hundreds of iterations under a change of summation order
    alone (ROADMAP queue C);
  * the certificate of one λ: the same validity, the gap within 1e-4 of
    max(1, |primal value|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MatchingObjective as RObjective
from repro.core import Maximizer as RMaximizer
from repro.core import SolveConfig as RConfig
from repro.core import StoppingCriteria as RCriteria
from repro.core import instance as rinst
from repro.core import precondition as rprecondition
from repro.primal import certify as rcertify
from repro_torch.convert import lam_to_numpy, lam_to_torch, lp_to_torch
from repro_torch.core import MatchingObjective as TObjective
from repro_torch.core import Maximizer as TMaximizer
from repro_torch.core import SolveConfig as TConfig
from repro_torch.core import StoppingCriteria as TCriteria
from repro_torch.core import instance as tinst
from repro_torch.core import precondition as tprecondition
from repro_torch.primal import certify as tcertify

SPEC = dict(num_sources=1000, num_destinations=60, avg_nnz_per_row=8,
            seed=7)
QUEUE_C_SPEC = dict(num_sources=120, num_destinations=19, avg_nnz_per_row=9,
                    seed=11, num_families=2)


def _pair(spec):
    lp_r, _ = jax.jit(rprecondition)(jax.tree.map(
        jnp.asarray, rinst.generate(rinst.InstanceSpec(**spec))))
    lp_t, _ = tprecondition(lp_to_torch(
        tinst.generate(tinst.InstanceSpec(**spec)), "cpu"), row_norm=True)
    return RObjective(lp_r, ax_mode="aligned"), TObjective(lp_t)


@pytest.fixture(scope="module")
def pair():
    return _pair(SPEC)


def _solve(pair, criteria=None, **cfg):
    obj_r, obj_t = pair
    res_r = RMaximizer(RConfig(**cfg)).maximize(
        obj_r, criteria=None if criteria is None else RCriteria(**criteria))
    res_t = TMaximizer(TConfig(**cfg)).maximize(
        obj_t, criteria=None if criteria is None else TCriteria(**criteria))
    return res_r, res_t


@pytest.fixture(scope="module")
def small():
    return _pair(QUEUE_C_SPEC)


@pytest.fixture(scope="module")
def fixed(small):
    return _solve(small, iterations=300, gamma=0.1, max_step=0.05,
                  initial_step=1e-4)


def test_fixed_length_trajectory(fixed):
    res_r, res_t = fixed
    assert res_r.iterations_run == res_t.iterations_run == 300
    d_r = np.asarray(res_r.stats.dual_obj)
    d_t = res_t.stats.dual_obj
    assert d_t.shape == d_r.shape == (300,)
    assert abs(d_t[-1] - d_r[-1]) <= 1e-5 * abs(d_r[-1])
    np.testing.assert_allclose(lam_to_numpy(res_t.lam), np.asarray(res_r.lam),
                               atol=1e-3)


@pytest.mark.parametrize("adaptive", [False, True])
def test_tolerance_terminated_solve(pair, adaptive):
    res_r, res_t = _solve(
        pair, criteria=dict(tol_rel_dual=1e-5, check_every=25),
        iterations=1500, gamma=0.01, max_step=0.1, gamma_init=0.16,
        adaptive_continuation=adaptive)
    assert res_t.stop_reason.value == res_r.stop_reason.value == "converged"
    assert abs(res_t.iterations_run - res_r.iterations_run) <= 25
    g_r = float(res_r.stats.dual_obj[-1])
    g_t = float(res_t.stats.dual_obj[-1])
    assert abs(g_t - g_r) <= 1e-5 * abs(g_r)
    assert res_t.diagnostics[-1].it == res_t.iterations_run
    assert len(res_t.stats.dual_obj) == res_t.iterations_run


def test_certificate_matches(small, fixed):
    obj_r, obj_t = small
    lam = np.array(fixed[0].lam)
    c_r = rcertify(obj_r, jnp.asarray(lam), jnp.float32(0.1))
    c_t = tcertify(obj_t, lam_to_torch(lam, "cpu"), np.float32(0.1),
                   chunk_rows=16)
    assert c_t.valid == c_r.valid
    assert c_t.feasible == c_r.feasible
    scale = max(1.0, abs(c_r.primal_value))
    assert abs(c_t.gap - c_r.gap) <= 1e-4 * scale
    assert c_t.x_sq_bound == c_r.x_sq_bound
    assert set(c_t.slacks) == set(c_r.slacks)
