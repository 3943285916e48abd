"""The port's distributed solve (`repro_torch.core.distributed`) against the
JAX package's, on `tests/test_distributed.py`'s instance (50 x 10, nu = 10,
seed 7, row-normalized) and solve (200 agd iterations, gamma 0.1, step
cap 10: CFG).

At CFG the agd trajectory is chaotic in float32: the port's single-device
run leaves the reference's by up to 1.14 % of the dual at iteration 14
(and meets it within 1.8e-5 at the end), because its first secant step
(‖Δ∇g‖/‖Δy‖ over a Δy of 1e-3·∇g) differs in the third digit under
another summation order.  So the port is held to the reference at the
step cap 0.05 (SMALL), where the two packages' trajectories stay within
1e-6 of each other, and to itself at CFG.

In process, one rank (a one-rank gloo group, so that the all-reduce
really runs): the dual trajectory bit for bit the port's single-device
run at CFG in every ax mode, plain and with the λ axis, and within 1e-5
relative of the reference's single-device Maximizer at SMALL; `primal`,
padding and one `calculate` against the reference's distributed
objective.

Across processes (`torch_dist_worker.py`, gloo over a FileStore): grids
(4, 1), (2, 2) with λ on "model", and (1, 2) with λ split, each held to
the reference's multi-device criterion (the relative dual deviation below
0.01 over the trajectory and 1e-4 at its end) against the reference's
single-device run at SMALL and the port's at CFG (pdhg and bb too with λ
split, against the port's at SMALL); every rank with the same bits; the gathered primal against the single-device x; a preempt
asked of one rank stopping every rank at one iteration; and a checkpoint
written by two ranks resumed by one bit for bit.
"""
import datetime
import gc
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import MatchingObjective as RObjective
from repro.core import Maximizer as RMaximizer
from repro.core import SolveConfig as RConfig
from repro.core import generate as rgenerate
from repro.core import precondition as rprecondition
from repro.core.distributed import DistributedMatchingObjective as RDist
from repro.core.distributed import place_lp as rplace_lp
from repro.core.instance import InstanceSpec as RSpec
from repro.launch.mesh import make_mesh
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import lp_to_torch
from repro_torch.core import (DistributedMatchingObjective, InstanceSpec,
                              MatchingObjective, Maximizer, SolveConfig,
                              StoppingCriteria, generate, get_rule,
                              pad_for_sharding, precondition,
                              solve_distributed)
from repro_torch.launch.mesh import init_ranks, make_grid

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_dist_worker.py"
CFG = dict(iterations=200, gamma=0.1, max_step=10.0, initial_step=1e-3)
SMALL = dict(CFG, max_step=0.05)
SPEC = dict(num_sources=50, num_destinations=10, avg_nnz_per_row=10, seed=7)
GAMMA = torch.tensor(CFG["gamma"])


@pytest.fixture(scope="module")
def lp_r():
    lp = jax.tree.map(jnp.asarray, rgenerate(RSpec(**SPEC)))
    return rprecondition(lp, row_norm=True)[0]


@pytest.fixture(scope="module")
def lp_t():
    lp = lp_to_torch(generate(InstanceSpec(**SPEC)), "cpu")
    return precondition(lp, row_norm=True)[0]


@pytest.fixture(scope="module")
def reference(lp_r):
    """The reference's single-device run (scatter, its default) at SMALL."""
    res = RMaximizer(RConfig(**SMALL)).maximize(RObjective(lp_r))
    return np.asarray(res.stats.dual_obj)


@pytest.fixture(scope="module")
def single(lp_t):
    """The port's single-device run at CFG."""
    res = Maximizer(SolveConfig(**CFG)).maximize(MatchingObjective(lp_t))
    return res.stats.dual_obj


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group for this module, torn down after it."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("store") / "fs"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_grid((1, 1), ("data", "model"))
    finally:
        gc.collect()    # no group object outlives the default group
        dist.destroy_process_group()


def test_init_ranks_one_rank(one_rank):
    ranks = init_ranks("cpu")
    assert (ranks.rank, ranks.world, ranks.grouped) == (0, 1, True)
    assert one_rank.coords == (0, 0)
    assert one_rank.group(("data", "model")) is dist.group.WORLD


@pytest.mark.parametrize("lambda_axis", [None, "model"])
def test_trajectory_matches_reference(one_rank, lp_t, reference,
                                      lambda_axis):
    res = solve_distributed(lp_t, SolveConfig(**SMALL), one_rank,
                            lambda_axis=lambda_axis)
    np.testing.assert_allclose(res.stats.dual_obj, reference, rtol=1e-5)


@pytest.mark.parametrize("lambda_axis", [None, "model"])
@pytest.mark.parametrize("mode", ["scatter", "aligned", "aligned_gvals"])
def test_trajectory_equals_single_device(one_rank, lp_t, mode, lambda_axis):
    """One rank: no padding, the single-device plan's widths, and an
    all-reduce over one rank that copies: the single-device bits."""
    cfg = SolveConfig(**CFG)
    single = Maximizer(cfg).maximize(MatchingObjective(lp_t, ax_mode=mode))
    res = solve_distributed(lp_t, cfg, one_rank, lambda_axis=lambda_axis,
                            ax_mode=mode)
    np.testing.assert_array_equal(single.stats.dual_obj, res.stats.dual_obj)
    assert torch.equal(single.lam, res.lam)


def test_primal_matches_reference(one_rank, lp_r, lp_t):
    cfg = SolveConfig(**CFG)
    res = solve_distributed(lp_t, cfg, one_rank)
    mesh = make_mesh((1, 1), ("data", "model"))
    robj = RDist(lp=rplace_lp(lp_r, mesh, ("data",)), mesh=mesh,
                 source_axes=("data",))
    ref = robj.primal(jnp.asarray(res.lam.numpy()), jnp.float32(0.1))
    obj = DistributedMatchingObjective(lp_t, one_rank, ("data",))
    for x_r, x_t in zip(ref, obj.primal(res.lam, GAMMA)):
        np.testing.assert_allclose(np.asarray(x_r), x_t.numpy(), atol=1e-5)


def test_padding_is_inert(lp_t):
    cfg = SolveConfig(**dict(CFG, iterations=50))
    ref = Maximizer(cfg).maximize(MatchingObjective(lp_t))
    padded = pad_for_sharding(lp_t, 16)
    assert all(s.n % 16 == 0 for s in padded.slabs)
    res = Maximizer(cfg).maximize(MatchingObjective(padded))
    np.testing.assert_allclose(ref.stats.dual_obj, res.stats.dual_obj,
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["scatter", "aligned", "aligned_gvals"])
def test_calculate_matches_reference(one_rank, lp_r, lp_t, mode):
    lam = np.random.default_rng(3).uniform(0, 2, (1, 10)).astype(np.float32)
    mesh = make_mesh((1, 1), ("data", "model"))
    robj = RDist(lp=rplace_lp(lp_r, mesh, ("data",)), mesh=mesh,
                 source_axes=("data",), ax_mode=mode)
    g_r, grad_r, aux_r = robj.calculate(jnp.asarray(lam), jnp.float32(0.1))
    obj = DistributedMatchingObjective(lp_t, one_rank, ("data",),
                                       ax_mode=mode)
    g_t, grad_t, aux_t = obj.calculate(torch.as_tensor(lam), GAMMA)
    np.testing.assert_allclose(float(g_t), float(g_r), rtol=1e-5)
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_r), rtol=1e-5,
                               atol=1e-6)
    for name in ("primal_obj", "x_sq", "infeas"):
        np.testing.assert_allclose(float(getattr(aux_t, name)),
                                   float(getattr(aux_r, name)), rtol=1e-5)


def test_lambda_axis_must_partition_sources(one_rank, lp_t):
    with pytest.raises(ValueError, match="partition sources"):
        DistributedMatchingObjective(lp_t, one_rank, ("data",),
                                     lambda_axis="model")


def _spawn(tmp_path, case, world, spec, timeout=150):
    """Run `world` ranks of the worker; each has its own FileStore-backed
    gloo group with a 60 s collective timeout, and the whole run a hard
    timeout.  Returns every rank's npz."""
    store, out = tmp_path / "store", tmp_path / "out"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), case, str(r), str(world), str(store),
         str(out), json.dumps(spec)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


def _held(reference, dual):
    rel = np.abs(reference - dual) / np.abs(reference)
    assert rel.max() < 0.01, rel.max()
    assert rel[-1] < 1e-4, rel[-1]


GRIDS = {
    "4x1": dict(shape=[4, 1], axes=["data", "model"], modes=["aligned"]),
    "2x2-lambda": dict(shape=[2, 2], axes=["data", "model"],
                       lambda_axis="model",
                       modes=["aligned", "aligned_gvals", "scatter"]),
    "1x2-lambda": dict(shape=[1, 2], axes=["data", "model"],
                       lambda_axis="model", modes=["aligned"],
                       rules=["pdhg", "bb"]),
}


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_grid_holds_reference_criterion(tmp_path, lp_t, reference, single,
                                        grid):
    spec = GRIDS[grid]
    world = int(np.prod(spec["shape"]))
    ranks = _spawn(tmp_path, "trajectories", world, spec)
    for name, against in (("small", reference), ("cfg", single)):
        for mode in spec["modes"]:
            key = f"{name}_{mode}"
            _held(against, ranks[0][f"dual_{key}"])
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[f"dual_{key}"],
                                              ranks[0][f"dual_{key}"])
                np.testing.assert_array_equal(r[f"lam_{key}"],
                                              ranks[0][f"lam_{key}"])
    # the other rules' reductions over λ's shards (pdhg's mean step, bb's
    # inner products), against the port's single-device runs
    for rule in spec.get("rules", ()):
        res = Maximizer(SolveConfig(**SMALL), algorithm=rule).maximize(
            MatchingObjective(lp_t))
        _held(res.stats.dual_obj, ranks[0][f"dual_rule_{rule}"])
    # the ranks' blocks of x*(λ), stacked in block order, are the
    # single-device x of every real row; padded rows stay empty
    lam = torch.as_tensor(ranks[0][f"lam_cfg_{spec['modes'][0]}"])
    single = MatchingObjective(lp_t).primal(lam, GAMMA)
    blocks = {int(r["block"]): r for r in ranks}
    for i, (slab, x) in enumerate(zip(lp_t.slabs, single)):
        whole = np.concatenate([blocks[k][f"x{i}"]
                                for k in sorted(blocks)])
        np.testing.assert_allclose(whole[:slab.n], x.numpy(), atol=1e-6)
        assert not whole[slab.n:].any()


def test_preempt_on_one_rank_stops_all(tmp_path):
    ranks = _spawn(tmp_path, "preempt", 2,
                   dict(shape=[2, 1], axes=["data", "model"]))
    assert [int(r["iterations"]) for r in ranks] == [30, 30]
    assert all(str(r["reason"]) == "preempted" for r in ranks)
    np.testing.assert_array_equal(ranks[0]["lam"], ranks[1]["lam"])


def test_checkpoint_of_two_ranks_resumes_on_one(tmp_path, lp_t):
    ck = tmp_path / "ck"
    ranks = _spawn(tmp_path, "checkpoint", 2,
                   dict(shape=[1, 2], axes=["data", "model"], dir=str(ck)))
    mgr = CheckpointManager(str(ck))
    step = mgr.latest_step()
    assert step == 100
    flat, extra = mgr.restore_flat(step)
    rule = get_rule("agd")
    restored = rule.state_from_flat(flat)
    # the whole state of rank 0's file is the state both ranks gathered
    for i, t in enumerate(restored[:-1]):
        np.testing.assert_array_equal(t.numpy(), ranks[0][f"state{i}"])
        np.testing.assert_array_equal(t.numpy(), ranks[1][f"state{i}"])
    in_memory = type(restored)(*(torch.as_tensor(ranks[1][f"state{i}"])
                                 for i in range(len(restored) - 1)), extra=())
    meta = {"gamma_now": extra["gamma_now"], "g_prev": extra["g_prev"]}
    runs = [solve_distributed(lp_t, SolveConfig(**CFG), make_grid((1, 1), (
        "data", "model")), ax_mode="aligned",
        criteria=StoppingCriteria(check_every=25), initial_state=state,
        resume_meta=meta) for state in (restored, in_memory)]
    assert runs[0].iterations_run == runs[1].iterations_run == 200
    np.testing.assert_array_equal(runs[0].stats.dual_obj,
                                  runs[1].stats.dual_obj)
    assert torch.equal(runs[0].lam, runs[1].lam)
