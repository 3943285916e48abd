"""The port's health guard (DESIGN.md §9) against the JAX package's, on
the reference's own fault-tolerance fixture (30 × 8, seed 3, γ 0.1,
max_step 10, a check every 7 iterations).

  * a transient fault (ChunkFaultInjector) and a persistent one give the
    reference's HealthRecord sequence: it, status, action, retries,
    rolled_back_to and step_scale, for agd, pga, pdhg and bb;
  * the traced fault (NaNInjectingObjective) stops DIVERGED after
    max_retries + 1 records, with the last good, finite λ;
  * a healthy guarded run equals the unguarded run bit for bit, and
    without a guard a NaN reaches the result;
  * a guarded chunk still makes one host read.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import HealthConfig as RHealth
from repro.core import MatchingObjective as RObjective
from repro.core import Maximizer as RMaximizer
from repro.core import SolveConfig as RConfig
from repro.core import StoppingCriteria as RCriteria
from repro.core import instance as rinst
from repro.core import precondition as rprecondition
from repro.core.maximizer import SolveEngine as REngine
from repro.testing import ChunkFaultInjector as RInjector
from repro.testing import NaNInjectingObjective as RNaN
from repro_torch.convert import lp_to_torch
from repro_torch.core import HealthConfig as THealth
from repro_torch.core import MatchingObjective as TObjective
from repro_torch.core import Maximizer as TMaximizer
from repro_torch.core import SolveConfig as TConfig
from repro_torch.core import SolveEngine as TEngine
from repro_torch.core import StopReason, StoppingCriteria as TCriteria
from repro_torch.core import instance as tinst
from repro_torch.core import maximizer as tmaximizer
from repro_torch.core import precondition as tprecondition
from repro_torch.testing import (ChunkFaultInjector, NaNInjectingObjective,
                                 PreemptAfter)

SPEC = dict(num_sources=30, num_destinations=8, avg_nnz_per_row=10, seed=3)
CFG = dict(iterations=120, gamma=0.1, max_step=10.0, initial_step=1e-3)
CRIT = dict(tol_grad_norm=0.0, check_every=7)
RULES = ("agd", "pga", "pdhg", "bb")
# isolate the NaN path: bb's dual is legitimately non-monotone
QUIET = dict(obj_regression_tol=1e9, grad_explosion=1e9)


@pytest.fixture(scope="module")
def pair():
    lp_r, _ = rprecondition(jax.tree.map(
        jnp.asarray, rinst.generate(rinst.InstanceSpec(**SPEC))),
        row_norm=True)
    lp_t, _ = tprecondition(lp_to_torch(
        tinst.generate(tinst.InstanceSpec(**SPEC)), "cpu"), row_norm=True)
    return RObjective(lp_r), TObjective(lp_t)


def _records(res):
    return [(r.it, r.status, r.action, r.retries, r.rolled_back_to,
             r.step_scale) for r in res.health]


def _engines(pair, rule, times):
    obj_r, obj_t = pair
    r = REngine(obj_r.calculate, RConfig(**CFG), algorithm=rule)
    r.chunk_fault_hook = RInjector(at_it=14, times=times)
    t = TEngine(obj_t.calculate, TConfig(**CFG), algorithm=rule)
    t.chunk_fault_hook = ChunkFaultInjector(at_it=14, times=times)
    return r, t


@pytest.mark.parametrize("rule", RULES)
def test_transient_fault_records_match_reference(pair, rule):
    obj_r, obj_t = pair
    eng_r, eng_t = _engines(pair, rule, times=2)
    res_r = eng_r.solve(jnp.zeros(obj_r.dual_shape, jnp.float32),
                        criteria=RCriteria(**CRIT),
                        health=RHealth(max_retries=3, **QUIET))
    res_t = eng_t.solve(torch.zeros(obj_t.dual_shape),
                        criteria=TCriteria(**CRIT),
                        health=THealth(max_retries=3, **QUIET))
    assert eng_t.chunk_fault_hook.injected == 2
    assert _records(res_t) == _records(res_r)
    assert [r.action for r in res_t.health] == ["rollback", "rollback"]
    assert res_t.stop_reason == StopReason.MAX_ITERATIONS
    assert res_t.iterations_run == CFG["iterations"]
    assert torch.isfinite(res_t.lam).all()
    assert np.isfinite(res_t.stats.dual_obj).all()


@pytest.mark.parametrize("rule", RULES)
def test_persistent_fault_records_match_reference(pair, rule):
    obj_r, obj_t = pair
    eng_r, eng_t = _engines(pair, rule, times=10 ** 9)
    res_r = eng_r.solve(jnp.zeros(obj_r.dual_shape, jnp.float32),
                        criteria=RCriteria(**CRIT),
                        health=RHealth(max_retries=3, **QUIET))
    res_t = eng_t.solve(torch.zeros(obj_t.dual_shape),
                        criteria=TCriteria(**CRIT),
                        health=THealth(max_retries=3, **QUIET))
    assert _records(res_t) == _records(res_r)
    assert res_t.stop_reason == StopReason.DIVERGED
    assert res_t.stop_reason.value == res_r.stop_reason.value
    assert res_t.iterations_run == res_r.iterations_run == 14
    assert len(res_t.health) == 4 and res_t.health[-1].action == "giveup"
    assert torch.isfinite(res_t.lam).all()
    assert not res_t.converged


def test_traced_nan_objective_stops_diverged(pair):
    obj_r, obj_t = pair
    res_r = RMaximizer(RConfig(**CFG)).maximize(
        RNaN(obj_r, mode="always"), criteria=RCriteria(**CRIT),
        health=RHealth(max_retries=2))
    res_t = TMaximizer(TConfig(**CFG)).maximize(
        NaNInjectingObjective(obj_t, mode="always"),
        criteria=TCriteria(**CRIT), health=THealth(max_retries=2))
    assert _records(res_t) == _records(res_r)
    assert res_t.stop_reason == StopReason.DIVERGED
    assert len(res_t.health) == 3 and res_t.iterations_run == 0
    assert torch.isfinite(res_t.lam).all()


def test_trip_norm_objective_matches_reference(pair):
    obj_r, obj_t = pair
    res_r = RMaximizer(RConfig(**CFG)).maximize(
        RNaN(obj_r, mode="trip_norm", trip_norm=1e-2),
        criteria=RCriteria(**CRIT), health=RHealth(max_retries=2))
    res_t = TMaximizer(TConfig(**CFG)).maximize(
        NaNInjectingObjective(obj_t, mode="trip_norm", trip_norm=1e-2),
        criteria=TCriteria(**CRIT), health=THealth(max_retries=2))
    assert _records(res_t) == _records(res_r)
    assert res_t.stop_reason == StopReason.DIVERGED
    assert res_t.iterations_run == res_r.iterations_run
    assert torch.isfinite(res_t.lam).all()


def test_injector_arguments_fail_like_reference(pair):
    _, obj_t = pair
    with pytest.raises(ValueError, match="trip_norm"):
        NaNInjectingObjective(obj_t, mode="trip_norm")
    with pytest.raises(ValueError, match="mode must be"):
        NaNInjectingObjective(obj_t, mode="sometimes")


@pytest.mark.parametrize("rule", RULES)
def test_healthy_guarded_run_is_bitwise_identical(pair, rule):
    _, obj_t = pair
    plain = TMaximizer(TConfig(**CFG), algorithm=rule).maximize(
        obj_t, criteria=TCriteria(**CRIT))
    guarded = TMaximizer(TConfig(**CFG), algorithm=rule).maximize(
        obj_t, criteria=TCriteria(**CRIT), health=THealth(**QUIET))
    assert torch.equal(plain.lam, guarded.lam)
    for a, b in zip(plain.stats, guarded.stats):
        np.testing.assert_array_equal(a, b)
    assert guarded.health == ()
    assert guarded.stop_reason == StopReason.MAX_ITERATIONS


def test_unguarded_nan_propagates(pair):
    _, obj_t = pair
    res = TMaximizer(TConfig(**CFG)).maximize(
        NaNInjectingObjective(obj_t, mode="always"),
        criteria=TCriteria(**CRIT))
    assert not torch.isfinite(res.lam).all()
    assert res.health == ()


def test_preempt_before_first_chunk(pair):
    _, obj_t = pair
    res = TMaximizer(TConfig(**CFG)).maximize(
        obj_t, criteria=TCriteria(**CRIT), preempt_fn=PreemptAfter(0))
    assert res.stop_reason == StopReason.PREEMPTED
    assert res.iterations_run == 0
    assert res.final_state is not None


@pytest.mark.parametrize("guarded", [False, True], ids=["off", "on"])
def test_one_host_read_per_chunk(pair, monkeypatch, guarded):
    """The guard's λ/y sweep rides in the chunk's one stats copy."""
    _, obj_t = pair
    reads = []
    to_host = tmaximizer._to_host

    def counting(stats, arrays):
        reads.append(len(arrays))
        return to_host(stats, arrays)

    monkeypatch.setattr(tmaximizer, "_to_host", counting)
    copies = []
    cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **k):
        copies.append(self.shape)
        return cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    res = TMaximizer(TConfig(**CFG)).maximize(
        obj_t, criteria=TCriteria(**CRIT),
        health=THealth() if guarded else None)
    chunks = -(-CFG["iterations"] // CRIT["check_every"])
    assert res.iterations_run == CFG["iterations"]
    assert reads == [2 if guarded else 0] * chunks
    assert len(copies) == chunks
