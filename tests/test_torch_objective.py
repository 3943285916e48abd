"""The port's MatchingObjective, in each of the four ax modes, against the
JAX package's in the same mode, one evaluation at a time.

Both run on the same generated, row-normalized instance at the same
seeded λ.  calculate: g, ∇g and the aux scalars at rtol 1e-5 (∇g at an
absolute 1e-5·max(1, |b|) — float32 sums in another order); primal x at
atol 1e-5 where |u| = |aᵀλ + c|/γ stays of order 10² (γ = 0.16: x is
resolved only to an ulp of u, 6e-5 at γ = 0.01 and |u| ~ 10³);
primal_rows equals the matching rows of the port's own primal bit for bit
(every operation is row-local).  Each slab's slice of the flat buffers
starts on a 16-byte boundary, with gaps where the slabs' sizes leave them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MatchingObjective as RObjective
from repro.core import instance as rinst
from repro.core import precondition as rprecondition
from repro_torch.convert import lam_to_numpy, lam_to_torch, lp_to_torch
from repro_torch.core import MatchingObjective as TObjective
from repro_torch.core import instance as tinst
from repro_torch.core import precondition as tprecondition

SPECS = [dict(num_sources=2000, num_destinations=100, avg_nnz_per_row=8,
              seed=42),
         dict(num_sources=120, num_destinations=19, avg_nnz_per_row=9,
              seed=11, num_families=2),
         # slabs of 17 and 33 rows of width 1 and 2: the flat buffers get
         # gaps before the later slabs (test_slab_slices_aligned)
         dict(num_sources=150, num_destinations=23, avg_nnz_per_row=3,
              seed=5, min_width=1)]


@pytest.fixture(scope="module", params=[
    (i, mode) for i in range(len(SPECS))
    for mode in ("aligned", "aligned_gvals", "sorted", "scatter")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    i, mode = request.param
    kw = SPECS[i]
    lp_r, _ = jax.jit(rprecondition)(jax.tree.map(
        jnp.asarray, rinst.generate(rinst.InstanceSpec(**kw))))
    lp_t, _ = tprecondition(lp_to_torch(
        tinst.generate(tinst.InstanceSpec(**kw)), "cpu"), row_norm=True)
    return (RObjective(lp_r, ax_mode=mode), TObjective(lp_t, ax_mode=mode))


def _lam(obj_t, seed, scale):
    m, J = obj_t.dual_shape
    return np.random.default_rng(seed).uniform(0, scale, (m, J)).astype(
        np.float32)


@pytest.mark.parametrize("gamma,scale", [(0.01, 0.0), (0.01, 1.0),
                                         (0.16, 3.0)])
def test_calculate_matches(pair, gamma, scale):
    obj_r, obj_t = pair
    lam = _lam(obj_t, 7, scale)
    g_r, grad_r, aux_r = jax.jit(obj_r.calculate)(jnp.asarray(lam),
                                                  jnp.float32(gamma))
    g_t, grad_t, aux_t = obj_t.calculate(lam_to_torch(lam, "cpu"),
                                         torch.tensor(gamma))
    np.testing.assert_allclose(float(g_t), float(g_r), rtol=1e-5)
    bscale = max(1.0, float(np.abs(np.asarray(obj_r.lp.b)).max()))
    np.testing.assert_allclose(lam_to_numpy(grad_t), np.asarray(grad_r),
                               rtol=1e-5, atol=1e-5 * bscale)
    for f in ("primal_obj", "x_sq", "infeas"):
        np.testing.assert_allclose(float(getattr(aux_t, f)),
                                   float(getattr(aux_r, f)), rtol=1e-5,
                                   atol=1e-6)


def test_primal_matches(pair):
    obj_r, obj_t = pair
    lam = _lam(obj_t, 3, 1.0)
    xs_r = obj_r.primal(jnp.asarray(lam), jnp.float32(0.16))
    xs_t = obj_t.primal(lam_to_torch(lam, "cpu"), torch.tensor(0.16))
    assert len(xs_r) == len(xs_t)
    for a, b in zip(xs_r, xs_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


def test_primal_rows_bitwise_equal_primal(pair):
    _, obj_t = pair
    lam = lam_to_torch(_lam(obj_t, 5, 1.0), "cpu")
    gamma = torch.tensor(0.01)
    full = obj_t.primal(lam, gamma)
    rng = np.random.default_rng(0)
    for si, slab in enumerate(obj_t.lp.slabs):
        rows = rng.integers(0, slab.n, size=min(7, slab.n))
        rows[-1] = rows[0]                      # duplicates are allowed
        got = obj_t.primal_rows(lam, gamma, si, torch.from_numpy(rows))
        assert torch.equal(got, full[si][torch.from_numpy(rows)])


def test_unknown_ax_mode_raises(pair):
    _, obj_t = pair
    assert obj_t.ax_mode in ("aligned", "aligned_gvals", "sorted", "scatter")
    with pytest.raises(ValueError):
        TObjective(obj_t.lp, ax_mode="bogus")


def test_slab_slices_aligned(pair):
    """Each slab's slice of the flat x (and gvals) buffer starts on a
    16-byte boundary, as the card's sweep kernels need; where the slab
    sizes leave gaps, the plan and the sorted order follow them, so the
    comparisons above run through the gaps too."""
    _, obj_t = pair
    size = obj_t._xbuf.element_size()
    assert all(o * size % 16 == 0 for o in obj_t._offsets)
    sizes = [s.n * s.width for s in obj_t.lp.slabs]
    ends = [o + n for o, n in zip(obj_t._offsets, sizes)]
    assert all(e <= o for e, o in zip(ends, obj_t._offsets[1:]))
    assert obj_t._xbuf.shape[0] == ends[-1]
    if min(s.width for s in obj_t.lp.slabs) < 4:
        assert obj_t._offsets != list(np.cumsum([0] + sizes[:-1]))


def test_scatter_sum_is_order_free():
    """The scatter mode's destination sum does not depend on the order of
    the edges (on the card, of its atomics): it is the float64 sum rounded
    once to float32, where a float32 sum in edge order loses the 1."""
    from repro_torch.core.objectives import _segment_ax
    vals = torch.tensor([[1e8], [1.0], [-1e8], [0.5], [3.0]])
    dest = torch.tensor([0, 0, 0, 1, 1])
    want = torch.tensor([[1.0, 3.5]])
    assert float(vals[0] + vals[1] + vals[2]) == 0.0
    for perm in ([0, 1, 2, 3, 4], [2, 4, 1, 0, 3], [1, 3, 2, 4, 0]):
        assert torch.equal(_segment_ax(vals[perm], dest[perm], 2), want)
