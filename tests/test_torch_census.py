"""The launch census (`repro_torch.launch.census`) counted by hand.

Each test reckons one evaluation's bytes, kernel by kernel, from the
objective's own arrays (masks, widths, element sizes) with the formulas
written out here, and holds `evaluation_census` to them exactly: every ax
mode of `MatchingObjective`, `GlobalCountObjective` (a scalar shift), the
composed formulations (weighted rows, and `assignment_eq`'s simplex_eq
blocks, which run the plain sweep), and two gloo ranks, replicated and λ
split (the collective bytes).  `runner_memory` is held to the tensors it
names.

The census is not compared with the reference's `launch/hlo_cost`: that
counts the operands of XLA's fused HLO ops (what the compiler emitted,
padding and re-reads included), while the census counts what the port's
kernels must move, each input once and each output once, so the two
differ by design.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import formulations
from repro_torch.convert import lp_to_torch
from repro_torch.core import (GlobalCountObjective, MatchingObjective,
                              instance, precondition)
from repro_torch.launch import census

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_dist_worker.py"
SPEC = dict(num_sources=60, num_destinations=12, avg_nnz_per_row=6, seed=5)
MODES = ("aligned", "aligned_gvals", "scatter", "sorted")


@pytest.fixture(scope="module")
def lp_np():
    return instance.generate(instance.InstanceSpec(**SPEC))


@pytest.fixture(scope="module")
def lp(lp_np):
    return precondition(lp_to_torch(lp_np, "cpu"), row_norm=True)[0]


def _slabs(slabs):
    """(real, padded, rows) of `slabs` from their masks."""
    masks = [s.mask.numpy() for s in slabs]
    return (int(sum(mk.sum() for mk in masks)),
            int(sum(mk.size for mk in masks)),
            int(sum(mk.shape[0] for mk in masks)))


def _plan(plan):
    """(real, entries, rows) of a plan from its buckets' masks."""
    return (int(sum(b.mask.numpy().sum() for b in plan.buckets)),
            int(sum(b.mask.numpy().size for b in plan.buckets)),
            int(sum(b.dest_ids.numel() for b in plan.buckets)))


def _sweep(slabs, m, J, gvals):
    """K1 (K3): a (4 B a family), c, dest (4), ub at the real edges; the
    mask (1 B) and x over every padded entry; s a row; λ once; gvals."""
    real, padded, rows = _slabs(slabs)
    b = real * (4 * m + 4 + 4 + 4) + padded * 1 + rows * 4 + m * J * 4
    b += padded * 4
    return b + (padded * 4 * m if gvals else 0)


def _hand(obj):
    """Every kernel's bytes of one evaluation of `obj`, by hand."""
    lp = obj.lp
    m, J = lp.m, lp.num_destinations
    mode = obj.ax_mode
    out = {}
    kern = [s for s, (kind, _) in zip(lp.slabs, obj._slab_proj)
            if kind in ("boxcut", "simplex", "box")]
    plain = [s for s, (kind, _) in zip(lp.slabs, obj._slab_proj)
             if kind not in ("boxcut", "simplex", "box")]
    if kern:
        name = "dual_x_slab" if mode == "aligned" else "dual_grad_slab"
        out[name] = _sweep(kern, m, J, mode != "aligned")
    if plain:
        _, padded, rows = _slabs(plain)
        b = padded * (4 * m + 4 + 4 + 1 + 4 + 4) + rows * 4 + m * J * 4
        out["plain_sweep"] = b + (padded * 4 * m if mode != "aligned" else 0)
    _, padded, _ = _slabs(lp.slabs)
    weights = list(getattr(obj, "_global_weights", ()))
    if isinstance(obj, GlobalCountObjective):
        weights = [None]
    if weights:
        tensors = [w for w in weights if w is not None]
        wbytes = [sum(t.numel() * t.element_size() for t in w)
                  for w in tensors]
        shift = 4 if tensors else 0
        out["shift_fold"] = (padded * (3 * 4 + 2 * shift)
                             + sum(wb + padded * 4 for wb in wbytes))
        out["row_sums"] = (padded * 4 * len(weights) + sum(wbytes))
    E = obj._xbuf.numel()
    if mode == "aligned":
        real, entries, rows = _plan(obj._plan)
        out["ax_reduce_plan_x"] = (real * (4 * m + 4 + 4) + entries
                                   + rows * 4 + m * J * 4)
    elif mode == "aligned_gvals":
        real, entries, rows = _plan(obj._plan)
        out["ax_reduce_plan"] = (real * (4 * m + 4) + entries + rows * 4
                                 + m * J * 4)
    elif mode == "scatter":
        out["scatter_ax"] = E * (4 * m + 8) + m * J * 4
    else:
        real, _, _ = _slabs(lp.slabs)
        out["sorted_ax"] = real * (4 * m + 8) + 8 * J + m * J * 4
    out["dual_tail"] = 16 * m * J
    return out


def _check(obj, collective=0):
    got = census.evaluation_census(obj)
    want = _hand(obj)
    assert {k: v["bytes"] for k, v in got["kernels"].items()} == want
    assert got["bytes_per_iteration"] == sum(want.values())
    assert got["collective_bytes_per_iteration"] == collective
    assert got["flops_per_iteration"] == sum(
        v["flops"] for v in got["kernels"].values()) > 0
    return got


@pytest.mark.parametrize("mode", MODES)
def test_matching_every_mode(lp, mode):
    got = _check(MatchingObjective(lp, ax_mode=mode))
    assert list(got["kernels"])[0] == ("dual_x_slab" if mode == "aligned"
                                       else "dual_grad_slab")


@pytest.mark.parametrize("mode", ("aligned", "aligned_gvals"))
def test_k1_k2_flops(lp, mode):
    """K1's (K3's) operations at the fixed bisection count, K2's 2m (K4's
    m) a real plan entry."""
    obj = MatchingObjective(lp, ax_mode=mode)
    m = lp.m
    real, _, _ = _slabs(lp.slabs)
    k = census.evaluation_census(obj)["kernels"]
    gv = mode != "aligned"
    sweep = k["dual_grad_slab" if gv else "dual_x_slab"]["flops"]
    assert sweep == real * (4 * 40 + 4 + 7 + m + (m if gv else 0))
    preal, _, _ = _plan(obj._plan)
    ax = k["ax_reduce_plan" if gv else "ax_reduce_plan_x"]["flops"]
    assert ax == (1 if gv else 2) * m * preal


@pytest.mark.parametrize("mode", MODES)
def test_global_count_scalar_shift(lp, mode):
    _check(GlobalCountObjective(lp, count=20.0, ax_mode=mode))


@pytest.mark.parametrize("name", ["global_count", "multi_budget",
                                  "assignment_eq"])
@pytest.mark.parametrize("mode", ("aligned", "scatter"))
def test_composed_formulations(lp_np, name, mode):
    obj = formulations.compile_formulation(
        formulations.build(name, lp_np), lp_to_torch(lp_np, "cpu"),
        ax_mode=mode, row_norm=True)
    got = _check(obj)
    if name == "assignment_eq":
        assert "plain_sweep" in got["kernels"]
    if name == "multi_budget":
        assert "shift_fold" in got["kernels"]


def test_sweep_and_ax_helpers_match_hand(lp):
    """The helpers `chip_smoke.py` calls for its K1 and K2 bounds."""
    obj = MatchingObjective(lp)
    m, J = lp.m, lp.num_destinations
    c = census.slab_counts(lp.slabs)
    assert (c.real, c.padded, c.rows) == _slabs(lp.slabs)
    assert census.sweep_bytes(c, m, J) == _sweep(lp.slabs, m, J, False)
    p = census.plan_counts(obj._plan)
    assert (p.real, p.entries, p.rows) == _plan(obj._plan)
    assert census.ax_bytes(p, m, J, 4, carry=True) == _hand(obj)[
        "ax_reduce_plan_x"]


def test_unknown_objective_is_none():
    assert census.evaluation_census(object()) is None
    assert census.runner_memory(object(), ()) is None


def test_runner_memory_names_its_tensors(lp):
    obj = MatchingObjective(lp, ax_mode="aligned_gvals")
    state = (torch.zeros(obj.dual_shape), torch.zeros(obj.dual_shape),
             torch.zeros((), dtype=torch.int32))
    est = census.runner_memory(obj, state, length=25)
    slabs = sum(t.numel() * t.element_size() for s in lp.slabs for t in s)
    plan = sum(t.numel() * t.element_size() for b in obj._plan.buckets
               for t in b if t is not None)
    st = 2 * lp.m * lp.num_destinations * 4 + 4
    assert est == {
        "argument_bytes": slabs + lp.b.numel() * 4 + plan + st,
        "output_bytes": st + 6 * 25 * 4,
        "temp_bytes": (obj._xbuf.numel() * 4 + obj._gbuf.numel() * 4
                       + 2 * lp.m * lp.num_destinations * 4),
        "source": "launch_census"}


def _spawn(tmp_path, spec, world=2, timeout=150):
    store, out = tmp_path / "store", tmp_path / "out"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), "observed", str(r), str(world),
         str(store), str(out), json.dumps(spec)], env=env, cwd=ROOT,
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


@pytest.mark.parametrize("grid", ["replicated", "lambda_split"])
def test_two_gloo_ranks(tmp_path, grid):
    """Each rank's census is its own row block's, by hand; the collective
    bytes are the all-reduce of m·J + 2 floats (replicated) or the λ
    gather, the reduce-scatter and the two sums (λ split on 2 ranks).
    Rank 0 alone records; both ranks agree once a chunk boundary."""
    spec = ({"shape": [2, 1], "axes": ["data", "model"]}
            if grid == "replicated" else
            {"shape": [1, 2], "axes": ["data", "model"],
             "lambda_axis": "model"})
    spec["dir"] = str(tmp_path / "trace")
    ranks = _spawn(tmp_path, spec)
    m, J = 1, 10           # the worker's instance: 50 x 10, one family
    for r, out in enumerate(ranks):
        got = json.loads(str(out["census"]))
        real, padded, rows = (int(out["slab_real"]), int(out["slab_padded"]),
                              int(out["slab_rows"]))
        k1 = (real * (4 * m + 12) + padded * 5 + rows * 4 + m * J * 4)
        preal, entries, prows = (int(out["plan_real"]),
                                 int(out["plan_entries"]),
                                 int(out["plan_rows"]))
        k2 = preal * (4 * m + 8) + entries + prows * 4 + m * J * 4
        assert got["kernels"]["dual_x_slab"]["bytes"] == k1
        assert got["kernels"]["ax_reduce_plan_x"]["bytes"] == k2
        if grid == "replicated":
            assert got["collective_bytes_per_iteration"] == (m * J + 2) * 4
        else:
            cols = J // 2
            assert got["collective_bytes_per_iteration"] == (
                m * cols * 4 + 2 * (m * cols + 2) * 4 + 8)
        np.testing.assert_array_equal(out["lam_bare"], out["lam_seen"])
        assert int(out["agree_calls"]) == 40 // 10 + 1
        assert (int(out["records"]) > 0) == (r == 0)
        assert int(out["samples"]) == (0 if r else 4)
        assert int(out["traces"]) == (0 if r else 1)
