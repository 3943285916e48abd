"""The port's checkpoint manager and checkpoint/resume (DESIGN.md §7, §9)
against the JAX package's.

  * kill and resume through the manager on disk (preempt after 4 chunks,
    `state_from_flat`, `initial_state` + `resume_meta`) equals the
    uninterrupted run bit for bit, λ and the stitched stats, for agd, pga,
    pdhg and bb, with γ fixed, scheduled and adaptive;
  * the on-disk layout is the reference's: either package's manager reads
    what the other wrote, with the same keys, arrays and meta;
  * the manager's cases of tests/test_checkpoint_manager.py: re-save,
    round trip, litter, foreign files, corrupt steps, a missing array,
    retention, protected steps; a missing `.extra/` key raises KeyError.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RManager
from repro.core import MatchingObjective as RObjective
from repro.core import Maximizer as RMaximizer
from repro.core import SolveConfig as RConfig
from repro.core import StoppingCriteria as RCriteria
from repro.core import instance as rinst
from repro.core import precondition as rprecondition
from repro.core.update_rules import get_rule as rget_rule
from repro.testing import PreemptAfter as RPreemptAfter
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import lp_to_torch
from repro_torch.core import MatchingObjective, Maximizer, SolveConfig
from repro_torch.core import StopReason, StoppingCriteria, instance
from repro_torch.core import precondition
from repro_torch.core.types import SolveState
from repro_torch.core.update_rules import get_rule
from repro_torch.testing import (PreemptAfter, corrupt_checkpoint,
                                 litter_tmp)

SPEC = dict(num_sources=30, num_destinations=8, avg_nnz_per_row=10, seed=3)
CRIT = dict(tol_grad_norm=0.0, check_every=10)
CONFIGS = {
    "fixed": dict(iterations=120, gamma=0.1, max_step=10.0,
                  initial_step=1e-3),
    "scheduled": dict(iterations=120, gamma=0.05, gamma_init=0.8,
                      gamma_decay_rate=0.5, max_step=20.0,
                      initial_step=1e-3),
    "adaptive": dict(iterations=120, gamma=0.05, gamma_init=0.8,
                     gamma_decay_rate=0.5, max_step=20.0, initial_step=1e-3,
                     adaptive_continuation=True),
}
RULES = ("agd", "pga", "pdhg", "bb")


@pytest.fixture(scope="module")
def obj():
    lp, _ = precondition(lp_to_torch(
        instance.generate(instance.InstanceSpec(**SPEC)), "cpu"),
        row_norm=True)
    return MatchingObjective(lp)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("rule", RULES)
def test_kill_and_resume_is_bitwise_identical(obj, rule, config, tmp_path):
    cfg = SolveConfig(**CONFIGS[config])
    crit = StoppingCriteria(**CRIT)
    full = Maximizer(cfg, algorithm=rule).maximize(obj, criteria=crit)

    mgr = CheckpointManager(str(tmp_path / rule))
    seen = {}

    def ckpt(it, state, meta):
        seen.update(meta)
        mgr.save(it, state, extra=dict(meta))

    part = Maximizer(cfg, algorithm=rule).maximize(
        obj, criteria=crit, checkpoint_fn=ckpt, preempt_fn=PreemptAfter(4))
    assert part.stop_reason == StopReason.PREEMPTED
    assert part.iterations_run == 40
    assert seen["algorithm"] == rule and seen["final"]

    flat, extra = mgr.restore_flat(mgr.latest_step())
    assert extra["algorithm"] == rule and extra["it"] == 40
    state = get_rule(rule).state_from_flat(flat)
    res = Maximizer(cfg, algorithm=rule).maximize(
        obj, criteria=crit, initial_state=state, resume_meta=extra)
    assert res.iterations_run == cfg.iterations
    assert torch.equal(full.lam, res.lam)
    for a, b, c in zip(full.stats, part.stats, res.stats):
        np.testing.assert_array_equal(a, np.concatenate([b, c]))


def test_resume_leaves_the_restored_state_untouched(obj):
    """The engine copies `initial_state` (and the guard's snapshot every
    leaf, `extra` included): the caller's tensors never change."""
    cfg = SolveConfig(**CONFIGS["fixed"])
    crit = StoppingCriteria(**CRIT)
    part = Maximizer(cfg, algorithm="pdhg").maximize(
        obj, criteria=crit, preempt_fn=PreemptAfter(2))
    state = part.final_state
    before = [t.clone() for t in state[:-1]] + [t.clone()
                                                 for t in state.extra]
    Maximizer(cfg, algorithm="pdhg").maximize(
        obj, criteria=crit, initial_state=state,
        resume_meta={"gamma_now": cfg.gamma, "g_prev": None})
    after = list(state[:-1]) + list(state.extra)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


@pytest.mark.parametrize("rule", RULES)
def test_reference_checkpoint_resumes_in_port(rule, tmp_path):
    """A state the reference saved after 40 iterations restores in the
    port (same keys, arrays and meta) and the port's manager writes what
    the reference's reads."""
    lp, _ = rprecondition(jax.tree.map(
        jnp.asarray, rinst.generate(rinst.InstanceSpec(**SPEC))),
        row_norm=True)
    cfg = RConfig(**CONFIGS["fixed"])
    rmgr = RManager(str(tmp_path / "ref"))
    RMaximizer(cfg, algorithm=rule).maximize(
        RObjective(lp), criteria=RCriteria(**CRIT),
        checkpoint_fn=lambda it, st, meta: rmgr.save(it, st,
                                                     extra=dict(meta)),
        preempt_fn=RPreemptAfter(4))
    step = rmgr.latest_step()
    ref_flat, ref_extra = rmgr.restore_flat(step)

    flat, extra = CheckpointManager(str(tmp_path / "ref")).restore_flat(step)
    assert extra == ref_extra and sorted(flat) == sorted(ref_flat)
    state = get_rule(rule).state_from_flat(flat)
    ref_state = rget_rule(rule).state_from_flat(ref_flat)
    for a, b in zip(jax.tree.leaves(ref_state),
                    list(state[:-1]) + list(state.extra)):
        np.testing.assert_array_equal(a, b.numpy())

    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(step, state, extra=extra)
    back, back_extra = RManager(str(tmp_path / "port")).restore_flat(step)
    assert back_extra == ref_extra and sorted(back) == sorted(ref_flat)
    for k in ref_flat:
        np.testing.assert_array_equal(back[k], ref_flat[k])
        assert back[k].dtype == ref_flat[k].dtype


def test_state_from_flat_missing_extra_raises():
    flat = {f".{f}": np.zeros(3, np.float32)
            for f in SolveState._fields if f != "extra"}
    with pytest.raises(KeyError, match="extra"):
        get_rule("pdhg").state_from_flat(flat)
    assert get_rule("agd").state_from_flat(flat).extra == ()


def _state(v: float):
    return {"a": torch.full((4,), v), "b": torch.arange(3, dtype=torch.int32)}


def test_resave_same_step_overwrites(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d)
    mgr.save(7, _state(1.0), extra={"v": 1})
    mgr.save(7, _state(2.0), extra={"v": 2})
    assert mgr.all_steps() == [7]
    flat, extra = mgr.restore_flat(7)
    assert extra == {"v": 2}
    np.testing.assert_array_equal(flat["a"], np.full(4, 2.0, np.float32))
    assert not any(n.endswith(".old") for n in os.listdir(d))


def test_restore_roundtrip_onto_device_and_dtype(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _state(5.0), extra={"gamma_now": 0.25})
    like = {"a": torch.zeros(4, dtype=torch.float64),
            "b": torch.zeros(3, dtype=torch.int32)}
    tree, extra = mgr.restore(3, like)
    assert extra["gamma_now"] == 0.25
    assert tree["a"].dtype == torch.float64
    assert torch.equal(tree["b"], torch.arange(3, dtype=torch.int32))
    step, tree, _ = mgr.restore_latest(like, device="cpu")
    assert step == 3 and torch.equal(tree["a"], torch.full((4,), 5.0,
                                                           dtype=torch.float64))


def test_litter_ignored_and_swept(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d)
    mgr.save(1, _state(1.0))
    litter_tmp(d, step=999)
    litter_tmp(d, step=998, old=True)
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1
    assert CheckpointManager(d).all_steps() == [1]
    assert not any(n.endswith((".tmp", ".old")) for n in os.listdir(d))


def test_foreign_files_ignored(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d)
    mgr.save(2, _state(1.0))
    open(os.path.join(d, "step_notanumber"), "w").close()
    open(os.path.join(d, "README"), "w").close()
    assert mgr.all_steps() == [2]


@pytest.mark.parametrize("kind", ["truncate", "garbage", "drop_meta"])
def test_corrupt_step_raises_naming_path(tmp_path, kind):
    d = str(tmp_path)
    mgr = CheckpointManager(d)
    mgr.save(4, _state(1.0))
    corrupt_checkpoint(d, kind=kind)
    with pytest.raises(ValueError, match=d):
        mgr.restore_flat(4)


def test_missing_array_names_structure_problem(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _state(1.0))
    with pytest.raises(ValueError, match="no array"):
        mgr.restore(5, {"a": torch.zeros(4), "zz": torch.zeros(1)})


def test_max_to_keep_prunes_oldest(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, max_to_keep=2)
    for step in (1, 2, 3, 4, 5):
        mgr.save(step, _state(float(step)))
    assert mgr.all_steps() == [4, 5]
    assert not os.path.exists(os.path.join(d, "step_0000000001"))
    mgr = CheckpointManager(str(tmp_path / "b"), keep_last=5, max_to_keep=1)
    mgr.save(1, _state(1.0))
    mgr.save(2, _state(2.0))
    assert mgr.all_steps() == [2]


def test_resumed_step_is_protected_for_the_managers_lifetime(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, _state(float(step)))
    mgr2 = CheckpointManager(d, max_to_keep=2)
    mgr2.restore_flat(2)
    for step in (4, 5, 6):
        mgr2.save(step, _state(float(step)))
    assert mgr2.all_steps() == [2, 5, 6]
    flat, _ = mgr2.restore_flat(2)
    np.testing.assert_array_equal(flat["a"], np.full(4, 2.0, np.float32))
    mgr3 = CheckpointManager(d, max_to_keep=2)
    mgr3.save(7, _state(7.0))
    assert mgr3.all_steps() == [6, 7]
