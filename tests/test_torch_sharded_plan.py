"""The port's sharded Ax plan, shard-local generation, `to_dense` and the
`ax_reducer` hook against the JAX package's.

Host-side packing is held bit for bit: `build_sharded_ax_plan` for every
shard of W in {1, 2, 3, 4} ranks, value-carrying and index-only, on two
instances (one with odd slab row counts at min_width 1), each shard
packed alone equal to the k-th slice of the reference's stacked plan;
`_flat_edges` / `_flat_a` with a row block; `pad_for_sharding`;
`generate(spec, shard=(k, 4))` per shard, and the shards covering the
whole instance's edges; `to_dense`.  The `ax_reducer` hook of
`dual_value_and_grad`, `MatchingObjective` and `GlobalCountObjective`
under one reducer (every part doubled) against the reference's outputs at
rtol 1e-5, and bit for bit the same evaluation with the parts doubled by
hand.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GlobalCountObjective as RGlobal
from repro.core import MatchingObjective as RObjective
from repro.core import dual_value_and_grad as rdual
from repro.core import instance as rinst
from repro.core import precondition as rprecondition
from repro.core.distributed import pad_for_sharding as rpad
from repro_torch.convert import lp_to_numpy, lp_to_torch
from repro_torch.core import GlobalCountObjective as TGlobal
from repro_torch.core import MatchingObjective as TObjective
from repro_torch.core import dual_value_and_grad as tdual
from repro_torch.core import instance as tinst
from repro_torch.core import pad_for_sharding as tpad
from repro_torch.core import precondition as tprecondition

SPECS = {"2000x100": dict(num_sources=2000, num_destinations=100,
                          avg_nnz_per_row=8, seed=42),
         # slabs of 17 and 33 rows of width 1 and 2: odd row counts
         "odd": dict(num_sources=150, num_destinations=23,
                     avg_nnz_per_row=3, seed=5, min_width=1)}


def _padded(name, shards):
    """The instance padded for `shards` by each package, as numpy."""
    kw = SPECS[name]
    lp = rinst.generate(rinst.InstanceSpec(**kw))
    ref = jax.tree.map(np.asarray, rpad(jax.tree.map(jnp.asarray, lp),
                                        shards))
    port = lp_to_numpy(tpad(lp_to_torch(lp, "cpu"), shards))
    return ref, port, kw.get("min_width", 4)


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("carry", [True, False], ids=["carry", "index"])
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_sharded_plan_bitwise(name, shards, carry):
    ref_lp, port_lp, min_width = _padded(name, shards)
    for a, b in zip(jax.tree.leaves(ref_lp), jax.tree.leaves(port_lp)):
        _equal(np.asarray(a), np.asarray(b))
    ref = rinst.build_sharded_ax_plan(ref_lp, shards, min_width=min_width,
                                      carry_values=carry)
    stacked = tinst.build_sharded_ax_plan(port_lp, shards,
                                          min_width=min_width,
                                          carry_values=carry)
    for k in range(shards):
        one = tinst.build_sharded_ax_plan(port_lp, shards,
                                          min_width=min_width,
                                          carry_values=carry, shard=k)
        _equal(np.asarray(ref.inv_perm)[k], one.inv_perm)
        _equal(np.asarray(ref.inv_perm)[k], stacked.inv_perm[k])
        assert len(one.buckets) == len(ref.buckets)
        for rb, sb, tb in zip(ref.buckets, stacked.buckets, one.buckets):
            for field in ("edge_idx", "mask", "dest_ids", "a_dm"):
                r, s, t = (getattr(b, field) for b in (rb, sb, tb))
                if not carry and field == "a_dm":
                    assert r is None and s is None and t is None
                    continue
                _equal(np.asarray(r)[k], t)
                _equal(np.asarray(r)[k], s[k])


@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_flat_edges_and_a_by_row_block(name, shards):
    ref_lp, port_lp, _ = _padded(name, shards)
    for k in range(shards):
        for r, t in zip(rinst._flat_edges(ref_lp.slabs, row_slice=(k, shards)),
                        tinst._flat_edges(port_lp.slabs,
                                          row_slice=(k, shards))):
            np.testing.assert_array_equal(np.asarray(r), np.asarray(t))
        _equal(rinst._flat_a(ref_lp.slabs, row_slice=(k, shards)),
               tinst._flat_a(port_lp.slabs, row_slice=(k, shards)))


def test_row_block_needs_padding():
    lp = tinst.generate(tinst.InstanceSpec(**SPECS["odd"]))
    with pytest.raises(ValueError, match="pad them first"):
        tinst._flat_edges(lp.slabs, row_slice=(0, 2))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_generate_shard_bitwise_and_covering(name):
    kw = SPECS[name]
    full = tinst.generate(tinst.InstanceSpec(**kw))
    edges = 0
    for k in range(4):
        ref = rinst.generate(rinst.InstanceSpec(**kw), shard=(k, 4))
        port = tinst.generate(tinst.InstanceSpec(**kw), shard=(k, 4))
        for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(port)):
            _equal(np.asarray(a), np.asarray(b))
        sources = np.concatenate([s.source_ids for s in port.slabs])
        assert (sources % 4 == k).all()
        edges += sum(int(s.mask.sum()) for s in port.slabs)
    assert edges == sum(int(s.mask.sum()) for s in full.slabs)


def test_to_dense_equals_reference():
    kw = dict(num_sources=30, num_destinations=8, avg_nnz_per_row=3, seed=2,
              num_families=2)
    lp = tinst.generate(tinst.InstanceSpec(**kw))
    A_r, c_r, e_r = rinst.to_dense(lp, 30, 8)
    A_t, c_t, e_t = tinst.to_dense(lp, 30, 8)
    np.testing.assert_array_equal(A_r, A_t)
    np.testing.assert_array_equal(c_r, c_t)
    assert len(e_r) == len(e_t)
    for (i, j, c, a), (it, jt, ct, at) in zip(e_r, e_t):
        assert (i, j, c) == (it, jt, ct)
        np.testing.assert_array_equal(np.asarray(a), at)


def _double(parts):
    return tuple(2 * p for p in parts)


@pytest.fixture(scope="module")
def lps():
    kw = SPECS["2000x100"]
    lp = rinst.generate(rinst.InstanceSpec(**kw))
    lp_r, _ = rprecondition(jax.tree.map(jnp.asarray, lp), row_norm=True)
    lp_t, _ = tprecondition(lp_to_torch(lp, "cpu"), row_norm=True)
    lam = np.random.default_rng(1).uniform(0, 1, (1, 100)).astype(np.float32)
    return lp_r, lp_t, lam


def _close(out_r, out_t):
    g_r, grad_r, aux_r = out_r
    g_t, grad_t, aux_t = out_t
    np.testing.assert_allclose(float(g_t), float(g_r), rtol=1e-5)
    scale = max(1.0, float(np.abs(np.asarray(grad_r)).max()))
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_r),
                               rtol=1e-5, atol=1e-5 * scale)
    for name in ("primal_obj", "x_sq", "infeas"):
        np.testing.assert_allclose(float(getattr(aux_t, name)),
                                   float(getattr(aux_r, name)), rtol=1e-5)


def test_dual_value_and_grad_reducer(lps):
    lp_r, lp_t, lam = lps
    out_r = rdual(lp_r, jnp.asarray(lam), jnp.float32(0.1),
                  ax_reducer=_double)
    out_t = tdual(lp_t, torch.as_tensor(lam), torch.tensor(0.1),
                  ax_reducer=_double)
    _close(out_r, out_t)
    plain = tdual(lp_t, torch.as_tensor(lam), torch.tensor(0.1))
    assert torch.equal(out_t[2].ax, 2 * plain[2].ax)


@pytest.mark.parametrize("mode", ["scatter", "aligned", "aligned_gvals"])
def test_matching_objective_reducer(lps, mode):
    lp_r, lp_t, lam = lps
    out_r = RObjective(lp_r, ax_mode=mode, ax_reducer=_double).calculate(
        jnp.asarray(lam), jnp.float32(0.1))
    obj = TObjective(lp_t, ax_mode=mode, ax_reducer=_double)
    out_t = obj.calculate(torch.as_tensor(lam), torch.tensor(0.1))
    _close(out_r, out_t)
    # the reducer acts between the sweep's sums and grad = Ax − b
    plain = TObjective(lp_t, ax_mode=mode).calculate(torch.as_tensor(lam),
                                                     torch.tensor(0.1))
    assert torch.equal(out_t[2].ax, 2 * plain[2].ax)
    assert torch.equal(out_t[1], 2 * plain[2].ax - lp_t.b)


def test_global_count_reducer(lps):
    lp_r, lp_t, lam = lps
    lam_flat = np.append(lam.reshape(-1), np.float32(0.3))
    out_r = RGlobal(lp_r, count=500.0, ax_mode="aligned",
                    ax_reducer=_double).calculate(jnp.asarray(lam_flat),
                                                  jnp.float32(0.1))
    out_t = TGlobal(lp_t, count=500.0, ax_mode="aligned",
                    ax_reducer=_double).calculate(torch.as_tensor(lam_flat),
                                                  torch.tensor(0.1))
    _close(out_r, out_t)
