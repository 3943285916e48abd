"""The Ax kernels' work table (`kernels.ax_reduce.plan_work`) on the CPU.

The table cuts each plan row's extent (its last set mask entry plus one)
into items of at most C entries, longest rows first, with the item ranges
a second pass sums for rows of several items.  Here: the table covers
every row's [0, extent) exactly once; its second-pass ranges and
destinations are right; and the Ax summed in the table's order
(`ref.ax_items_ref`, the kernels' own order, bit for bit on the card)
equals the JAX package's `ax_plan_x_ref` / `ax_plan_ref` and its Pallas
kernels in interpret mode to 1e-5 (float32 sums in another order).  The
same seeded numpy instance goes through both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import instance as rinst
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.convert import lp_to_torch, plan_to_torch
from repro_torch.core import MatchingObjective
from repro_torch.core import instance as tinst
from repro_torch.core.types import AxBucket, AxPlan
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ax_reduce import (BAND_ENTRIES, ITEM_ENTRIES,
                                           ax_reduce_plan, ax_reduce_plan_x,
                                           bucket_work, plan_work,
                                           row_extents)

# the tests/test_ax_plan.py fixture, and one whose rows are much wider
# than C (in-degree ~8,000, 8,192-wide rows)
SPECS = {
    "fixture": dict(num_sources=120, num_destinations=19, avg_nnz_per_row=9,
                    seed=11, num_families=2),
    "wide": dict(num_sources=12000, num_destinations=3, avg_nnz_per_row=2,
                 seed=7, num_families=2),
}


@pytest.fixture(scope="module", params=sorted(SPECS))
def instance(request):
    spec = SPECS[request.param]
    r = rinst.generate(rinst.InstanceSpec(**spec))
    t = tinst.generate(tinst.InstanceSpec(**spec))
    return r, t


def _ragged_plan(seed=0):
    """A three-bucket plan with non-prefix masks: holes inside each row
    and padding after; some rows empty."""
    rng = np.random.default_rng(seed)
    buckets, J = [], 0
    for w, r in ((4, 9), (512, 5), (4096, 3)):
        end = rng.integers(0, w + 1, size=r)
        end[0] = 0
        mask = ((rng.random((r, w)) < 0.6)
                & (np.arange(w)[None, :] < end[:, None]))
        idx = np.where(mask, rng.integers(0, 1000, (r, w)), 0)
        buckets.append(AxBucket(
            torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(mask),
            torch.arange(J, J + r, dtype=torch.int32),
            torch.from_numpy(np.where(mask[..., None], rng.lognormal(
                0, 0.5, (r, w, 2)), 0).astype(np.float32))))
        J += r
    return AxPlan(tuple(buckets), torch.zeros(J, dtype=torch.int32))


def _extents_np(mask):
    mask = np.asarray(mask)
    has = mask.any(axis=1)
    last = mask.shape[1] - np.argmax(mask[:, ::-1], axis=1)
    return np.where(has, last, 0)


def test_row_extents():
    mask = torch.tensor([[1, 1, 0, 0], [0, 0, 0, 0], [1, 0, 1, 0],
                         [1, 1, 1, 1], [0, 0, 0, 1]], dtype=torch.bool)
    assert row_extents(mask).tolist() == [2, 0, 3, 4, 4]
    assert row_extents(torch.zeros((3, 0), dtype=torch.bool)).tolist() == [0] * 3
    plan = _ragged_plan()
    for b in plan.buckets:
        np.testing.assert_array_equal(row_extents(b.mask).numpy(),
                                      _extents_np(b.mask))


def _plans(instance):
    _, t = instance
    return [plan_to_torch(tinst.build_ax_plan(t), "cpu"), _ragged_plan()]


# (item size C, band entries): the default table, items of 256 and no
# bands, and bands of 1,000 edges (several a plan here)
TABLES = [(ITEM_ENTRIES, BAND_ENTRIES), (256, None), (ITEM_ENTRIES, 1000)]


@pytest.mark.parametrize("C,band", TABLES)
def test_plan_work_covers_each_extent_once(instance, C, band):
    """Every row's [0, extent) is covered by its items exactly once, in
    items of at most C entries (a row of extent 0: one empty item).
    Without bands the rows run longest first; with bands an item's edge
    indices (ascending in a packed plan) lie in one band, but for at most
    3 of the band before."""
    for plan in _plans(instance):
        work = plan_work(plan, C, band)
        items = work.items.numpy()
        assert work.items.dtype == torch.int32 and work.item_entries == C
        seen = {}
        for b, r, q0, q1 in items:
            seen.setdefault((b, r), []).append((q0, q1))
        rows = {(b, r) for b, bk in enumerate(plan.buckets)
                for r in range(bk.rows)}
        assert set(seen) == rows
        for b, bk in enumerate(plan.buckets):
            ext = _extents_np(bk.mask)
            for r in range(bk.rows):
                spans = seen[(b, r)]
                assert spans == sorted(spans)
                if ext[r] == 0:
                    assert spans == [(0, 0)]
                    continue
                assert spans[0][0] == 0 and spans[-1][1] == ext[r]
                for (a0, a1), (c0, _) in zip(spans, spans[1:]):
                    assert a1 == c0
                assert all(0 < q1 - q0 <= C for q0, q1 in spans)
        if band is None:
            ext_all = [_extents_np(bk.mask) for bk in plan.buckets]
            row_ext = [ext_all[b][r] for b, r, _, _ in items]
            assert all(u >= v for u, v in zip(row_ext, row_ext[1:]))
    if band is not None:
        plan = _plans(instance)[0]
        for b, r, q0, q1 in plan_work(plan, C, band).items.numpy():
            if q1 > q0:
                idx = plan.buckets[b].edge_idx[r].numpy()[q0:q1]
                last = idx[-1] // band
                assert last - idx[0] // band <= 1
                assert np.count_nonzero(idx // band < last) < 4


@pytest.mark.parametrize("C,band", TABLES)
def test_second_pass_ranges(instance, C, band):
    """A row of one item stores to its destination; a row of several
    writes partials p0..p1-1 in entry order, and the second pass reads
    exactly those.  Every destination is written once."""
    for plan in _plans(instance):
        work = plan_work(plan, C, band)
        items, dest = work.items.numpy(), work.item_dest.numpy()
        per_row = {}
        for i, (b, r, q0, _) in enumerate(items):
            per_row.setdefault((b, r), []).append((q0, i))
        multi = {int(j): (int(p0), int(p1)) for j, p0, p1 in work.multi}
        written = list(dest[dest >= 0]) + list(multi)
        J = plan.num_destinations
        assert sorted(written) == list(range(J))
        for (b, r), its in per_row.items():
            j = int(plan.buckets[b].dest_ids[r])
            ids = [i for _, i in sorted(its)]
            if len(ids) == 1:
                assert dest[ids[0]] == j and j not in multi
            else:
                p0, p1 = multi[j]
                assert [-1 - dest[i] for i in ids] == list(range(p0, p1))
        slots = sorted(-1 - dest[dest < 0])
        assert slots == list(range(work.num_partials))


def test_bucket_work_rejects_a_bad_item_size():
    plan = _ragged_plan()
    with pytest.raises(ValueError):
        bucket_work(plan.buckets, 100)
    with pytest.raises(ValueError):
        bucket_work(plan.buckets, 256, 0)


def test_plan_work_rejects_malformed_plans():
    """The table checks the plan once: shapes, types, no negative index."""
    b = _ragged_plan().buckets[1]
    for bad in (b._replace(dest_ids=b.dest_ids - 100),
                b._replace(mask=b.mask[:, :-1].contiguous()),
                b._replace(edge_idx=b.edge_idx.long()),
                b._replace(a_dm=b.a_dm[..., :1].contiguous().expand(
                    -1, -1, 2))):
        with pytest.raises((ValueError, TypeError)):
            bucket_work((b, bad))


@pytest.mark.parametrize("C,band", TABLES)
def test_items_sum_matches_reference(instance, C, band):
    """x-carry and gvals Ax summed in the table's order against the JAX
    package's plain versions and its Pallas kernels in interpret mode."""
    r, t = instance
    E = sum(s.n * s.width for s in t.slabs)
    rng = np.random.default_rng(C + (band or 0))
    x = rng.uniform(0, 1, E).astype(np.float32)
    m = t.b.shape[0]
    gvals = rng.lognormal(0, 0.5, (E, m)).astype(np.float32)

    plan_t = plan_to_torch(tinst.build_ax_plan(t), "cpu")
    got = tref.ax_items_ref(plan_t, plan_work(plan_t, C, band),
                            x=torch.from_numpy(x)).numpy()
    plan_r = jax.tree.map(jnp.asarray, rinst.build_ax_plan(r))
    for want in (rref.ax_plan_x_ref(plan_r, jnp.asarray(x)),
                 rops.ax_aligned_x(plan_r, jnp.asarray(x), use_pallas=True,
                                   interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)

    plan_tg = plan_to_torch(tinst.build_ax_plan(t, carry_values=False), "cpu")
    got_g = tref.ax_items_ref(plan_tg, plan_work(plan_tg, C, band),
                              gvals=torch.from_numpy(gvals)).numpy()
    plan_rg = jax.tree.map(jnp.asarray,
                           rinst.build_ax_plan(r, carry_values=False))
    for want in (rref.ax_plan_ref(plan_rg, jnp.asarray(gvals)),
                 rops.ax_aligned(plan_rg, jnp.asarray(gvals), use_pallas=True,
                                 interpret=True)):
        np.testing.assert_allclose(got_g, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_items_sum_on_non_prefix_masks():
    """The table's order on masks with holes: the same Ax as the plain
    per-bucket sums, and gvals = a ⊙ x gives x-carry's bits."""
    plan = _ragged_plan(3)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(0, 1, 1000).astype(np.float32))
    work = plan_work(plan, 256, 300)
    assert work.multi.shape[0] > 0
    got = tref.ax_items_ref(plan, work, x=x)
    want = torch.empty_like(got)
    ax_reduce_plan_x(x, plan, want)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    a_flat = torch.from_numpy(rng.lognormal(0, 0.5, (1000, 2)).astype(
        np.float32))
    plan_x = AxPlan(tuple(b._replace(a_dm=torch.where(
        b.mask[..., None], a_flat[b.edge_idx.long()], 0.0))
        for b in plan.buckets), plan.inv_perm)
    plan_g = AxPlan(tuple(b._replace(a_dm=None) for b in plan.buckets),
                    plan.inv_perm)
    assert torch.equal(
        tref.ax_items_ref(plan_x, work, x=x),
        tref.ax_items_ref(plan_g, plan_work(plan_g, 256, 300),
                          gvals=a_flat * x[:, None]))


def test_both_plans_share_one_table(instance):
    """The value-carrying and the index-only plan of one instance get one
    table, so K2 and K4 sum in one order."""
    _, t = instance
    wx = plan_work(plan_to_torch(tinst.build_ax_plan(t), "cpu"))
    wg = plan_work(plan_to_torch(tinst.build_ax_plan(t, carry_values=False),
                                 "cpu"))
    for u, v in zip(wx[:5], wg[:5]):
        assert torch.equal(u, v) if torch.is_tensor(u) else u == v


def test_plan_wrappers_on_cpu(instance):
    """On the CPU the plan-level wrappers run the plain versions (no
    launch), with or without a table; the objective builds no table
    there; an index-only plan cannot feed the x-carry Ax."""
    _, t = instance
    plan = plan_to_torch(tinst.build_ax_plan(t), "cpu")
    plan_g = plan_to_torch(tinst.build_ax_plan(t, carry_values=False), "cpu")
    E = sum(s.n * s.width for s in t.slabs)
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, E).astype(
        np.float32))
    m, J = t.b.shape
    k2, k4 = ax_reduce_plan_x.launches, ax_reduce_plan.launches
    out = torch.full((m, J), float("nan"))
    ax_reduce_plan_x(x, plan, out, plan_work(plan))
    assert torch.equal(out, tref.ax_plan_x_ref(plan, x))
    gvals = torch.rand((E, m), generator=torch.Generator().manual_seed(2))
    out_g = torch.full((m, J), float("nan"))
    ax_reduce_plan(gvals, plan_g, out_g)
    assert torch.equal(out_g, tref.ax_plan_ref(plan_g, gvals))
    assert (ax_reduce_plan_x.launches, ax_reduce_plan.launches) == (k2, k4)
    with pytest.raises(ValueError):
        tops.ax_aligned_x(plan_g, x)
    obj = MatchingObjective(lp_to_torch(t, "cpu"))
    assert obj._work is None
