"""The port's CPU baseline solver (`repro_torch.core.baseline_numpy`)
against the JAX package's (`repro.core.baseline_numpy`), and the port's
solver against it, on `tests/test_solver.py`'s instance (30 × 8, seed 3,
row-normalized).

  * `from_slabs` gives the same CSC layout bit for bit as the
    reference's from one LPData, and the same from the port's torch LP
    as from its host copy;
  * one evaluation and a whole solve (λ and every history series but the
    wall-clock times) are bit for bit the reference's, for each
    projection kind;
  * the port's Maximizer is within 1 % of the baseline after warm-up and
    1e-3 at the end of 150 iterations (test_solver's Fig. 1/2 criterion),
    and within 1 % at 100.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import baseline_numpy as rbn
from repro.core import instance as rinst
from repro.core import precondition as rprecondition
from repro.core import SolveConfig as RConfig
from repro_torch.convert import lp_to_torch
from repro_torch.core import (MatchingObjective, Maximizer, SolveConfig,
                              instance, precondition)
from repro_torch.core import baseline_numpy as bn

SPEC = dict(num_sources=30, num_destinations=8, avg_nnz_per_row=10, seed=3)
CFG = dict(iterations=150, gamma=0.1, max_step=10.0, initial_step=1e-3)


@pytest.fixture(scope="module")
def lps():
    lp_r, _ = rprecondition(jax.tree.map(
        jnp.asarray, rinst.generate(rinst.InstanceSpec(**SPEC))),
        row_norm=True)
    lp_t, _ = precondition(lp_to_torch(
        instance.generate(instance.InstanceSpec(**SPEC)), "cpu"),
        row_norm=True)
    return lp_r, lp_t


@pytest.fixture(scope="module")
def cscs(lps):
    """Both packages' CSC layouts of one LPData (the reference's
    preconditioned LP as host numpy): the two packages' row norms differ
    by float32 ulps (the port sums them on the host in float64), so
    their preconditioned LPs are not one LPData."""
    lp = jax.tree.map(np.asarray, lps[0])
    return rbn.from_slabs(lp), bn.from_slabs(lp)


def test_from_slabs_bitwise(cscs):
    ref, port = cscs
    for name in ("indptr", "dst", "a", "c", "ub", "s", "b"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name), err_msg=name)
    assert port.num_sources == ref.num_sources == 30
    assert port.num_destinations == ref.num_destinations == 8


def test_from_torch_lp_equals_from_its_host_copy(lps):
    _, lp_t = lps
    from repro_torch.convert import lp_to_numpy
    host, dev = bn.from_slabs(lp_to_numpy(lp_t)), bn.from_slabs(lp_t)
    for name in ("indptr", "dst", "a", "c", "ub", "s", "b"):
        np.testing.assert_array_equal(getattr(host, name),
                                      getattr(dev, name))


@pytest.mark.parametrize("kind", ["boxcut", "simplex", "box"])
def test_evaluation_bitwise(cscs, kind):
    ref, port = cscs
    lam = np.random.default_rng(0).uniform(0, 1, ref.b.shape)
    g_r, grad_r, aux_r = rbn.dual_value_and_grad(ref, lam, 0.1, kind)
    g_t, grad_t, aux_t = bn.dual_value_and_grad(port, lam, 0.1, kind)
    assert g_t == g_r
    np.testing.assert_array_equal(grad_t, grad_r)
    np.testing.assert_array_equal(aux_t["x"], aux_r["x"])
    assert aux_t["infeas"] == aux_r["infeas"]


@pytest.mark.parametrize("kind", ["boxcut", "simplex", "box"])
def test_solve_bitwise(cscs, kind):
    ref, port = cscs
    lam_r, hist_r = rbn.solve(ref, RConfig(**dict(CFG, iterations=60)), kind)
    lam_t, hist_t = bn.solve(port, SolveConfig(**dict(CFG, iterations=60)),
                             kind)
    np.testing.assert_array_equal(lam_t, lam_r)
    for key in ("dual_obj", "infeas", "step"):
        assert hist_t[key] == hist_r[key], key


def test_continuation_schedule_bitwise(cscs):
    ref, port = cscs
    cont = dict(CFG, iterations=60, gamma=0.01, gamma_init=0.16)
    lam_r, hist_r = rbn.solve(ref, RConfig(**cont))
    lam_t, hist_t = bn.solve(port, SolveConfig(**cont))
    np.testing.assert_array_equal(lam_t, lam_r)
    assert hist_t["dual_obj"] == hist_r["dual_obj"]


@pytest.fixture(scope="module")
def trajectories(lps, cscs):
    _, lp_t = lps
    res = Maximizer(SolveConfig(**CFG)).maximize(
        MatchingObjective(lp_t, proj_kind="boxcut"))
    _, hist = bn.solve(bn.from_slabs(lp_t), SolveConfig(**CFG))
    ours = np.asarray(res.stats.dual_obj, np.float64)
    base = np.asarray(hist["dual_obj"])
    return np.abs(ours - base) / np.maximum(np.abs(base), 1e-12)


def test_port_solver_parity_fig12(trajectories):
    rel = trajectories
    assert rel[-50:].max() < 0.01
    assert rel[-1] < 1e-3


def test_port_solver_within_one_percent_at_100(trajectories):
    assert trajectories[99] < 0.01
