"""The port's kernel entry points, on the CPU (their plain versions),
against the JAX package's Pallas kernels in interpret mode and its oracles.

Same seeded numpy inputs through both.  float32: x at atol 1e-5, the
scalars and Ax at rtol 1e-5 (float32 sums in another order).  x is
resolved only to an ulp of u = −(aᵀλ + c)/γ, since the threshold τ
cancels most of u, so the inputs keep |u| of order 10 (γ = 0.1); at the
solver's γ = 0.01 and |u| ~ 10³ one ulp is 6e-5.  bfloat16: 5e-2 (the
reference's bf16 tolerance: XLA may fuse a bf16 multiply and its convert
at f32 precision).  The kernels themselves are held against
these plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import Slab as RSlab
from repro.core import instance as rinst
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.convert import lp_to_torch, plan_to_torch
from repro_torch.core import instance as tinst
from repro_torch.core.types import Slab as TSlab
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ax_reduce import ax_reduce_bucket, ax_reduce_bucket_x
from repro_torch.kernels.dual_grad import dual_grad_slab, dual_x_slab
from repro_torch.kernels.proj import proj_boxcut


def _slab_np(seed, n, w, m, J):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, w + 1, size=n)
    mask = np.arange(w)[None, :] < deg[:, None]
    f = np.float32
    return RSlab(
        a_vals=np.where(mask[..., None], rng.lognormal(0, 0.5, (n, w, m)),
                        0).astype(f),
        c_vals=np.where(mask, -rng.lognormal(0, 0.5, (n, w)), 0).astype(f),
        dest_idx=np.where(mask, rng.integers(0, J, (n, w)), 0).astype(np.int32),
        mask=mask,
        ub=np.where(mask, rng.uniform(0.5, 1.0, (n, w)), 0).astype(f),
        s=rng.uniform(0.5, 2.0, n).astype(f),
        source_ids=np.arange(n, dtype=np.int32)), \
        rng.uniform(0, 0.5, (m, J)).astype(f)


def _to(slab, dtype_j, dtype_t):
    fl = ("a_vals", "c_vals", "ub", "s")
    sj = RSlab(*(jnp.asarray(v, dtype_j) if f in fl else jnp.asarray(v)
                 for f, v in zip(RSlab._fields, slab)))
    st = TSlab(*(torch.from_numpy(np.asarray(v)).to(dtype_t) if f in fl
                 else torch.from_numpy(np.asarray(v))
                 for f, v in zip(RSlab._fields, slab)))
    return sj, st


CASES = [(4, 1, 37), (64, 4, 53), (256, 2, 19)]


@pytest.mark.parametrize("w,m,n", CASES)
def test_dual_x_full_matches_pallas_and_oracle(w, m, n):
    slab, lam = _slab_np(w + m, n, w, m, 23)
    sj, st = _to(slab, jnp.float32, torch.float32)
    gamma = 0.1
    before = dual_x_slab.launches
    x, cx, xsq = tops.dual_x_full(st, torch.from_numpy(lam),
                                  torch.tensor(gamma))
    assert dual_x_slab.launches == before        # the CPU runs no kernel
    xp, cxp, xsqp = rops.dual_x_full(sj, jnp.asarray(lam),
                                     jnp.float32(gamma))
    xo, _, cxo, xsqo = rref.dual_xstar_ref(*sj[:6], jnp.asarray(lam),
                                           jnp.float32(gamma))
    for xr, cxr, xsqr in ((xp, cxp, xsqp), (xo, cxo, xsqo)):
        np.testing.assert_allclose(x.numpy(), np.asarray(xr), atol=1e-5)
        np.testing.assert_allclose(float(cx), float(cxr), rtol=1e-5)
        np.testing.assert_allclose(float(xsq), float(xsqr), rtol=1e-5)


@pytest.mark.parametrize("w,m,n", [(16, 1, 41), (128, 2, 17)])
def test_dual_x_full_bf16(w, m, n):
    slab, lam = _slab_np(7 * w, n, w, m, 23)
    sj, st = _to(slab, jnp.bfloat16, torch.bfloat16)
    x, cx, xsq = tops.dual_x_full(st, torch.from_numpy(lam),
                                  torch.tensor(0.01))
    assert x.dtype == torch.bfloat16
    xp, cxp, xsqp = rops.dual_x_full(sj, jnp.asarray(lam), jnp.float32(0.01))
    np.testing.assert_allclose(x.float().numpy(),
                               np.asarray(xp, np.float32), atol=5e-2)
    np.testing.assert_allclose(float(cx), float(cxp), rtol=5e-2)
    np.testing.assert_allclose(float(xsq), float(xsqp), rtol=5e-2)


@pytest.mark.parametrize("kind", ["simplex", "box"])
def test_dual_x_full_kind_dispatch(kind):
    slab, lam = _slab_np(5, 31, 16, 2, 11)
    sj, st = _to(slab, jnp.float32, torch.float32)
    x, cx, _ = tops.dual_x_full(st, torch.from_numpy(lam), torch.tensor(0.05),
                                proj_kind=kind)
    xp, cxp, _ = rops.dual_x_full(sj, jnp.asarray(lam), jnp.float32(0.05),
                                  proj_kind=kind)
    np.testing.assert_allclose(x.numpy(), np.asarray(xp), atol=1e-5)
    np.testing.assert_allclose(float(cx), float(cxp), rtol=1e-5)


def test_dual_x_full_other_kinds_raise():
    slab, lam = _slab_np(5, 4, 4, 1, 3)
    _, st = _to(slab, jnp.float32, torch.float32)
    with pytest.raises(NotImplementedError):
        tops.dual_x_full(st, torch.from_numpy(lam), torch.tensor(0.1),
                         proj_kind="simplex_eq")


def test_dual_x_out_buffer_and_bad_device():
    slab, lam = _slab_np(9, 12, 8, 1, 5)
    _, st = _to(slab, jnp.float32, torch.float32)
    buf = torch.full((12 * 8 + 3,), -7.0)
    view = buf[:96].view(12, 8)
    x, _, _ = tops.dual_x_full(st, torch.from_numpy(lam), torch.tensor(0.1),
                               out=view)
    assert x.data_ptr() == view.data_ptr()
    assert (buf[96:] == -7.0).all()
    meta = TSlab(*(t.to("meta") for t in st))
    with pytest.raises(ValueError):
        tops.dual_x_full(meta, torch.from_numpy(lam).to("meta"), 0.1)


def _bucket_np(seed, r, w, m, E):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, w + 1, size=r)
    mask = np.arange(w)[None, :] < deg[:, None]
    idx = np.where(mask, rng.integers(0, E, (r, w)), 0).astype(np.int32)
    a_dm = np.where(mask[..., None], rng.lognormal(0, 0.5, (r, w, m)),
                    0).astype(np.float32)
    x = rng.uniform(0, 1, E).astype(np.float32)
    return x, a_dm, idx, mask


@pytest.mark.parametrize("w,m,r", [(4, 1, 33), (64, 4, 21), (256, 2, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ax_reduce_bucket_matches_pallas_and_oracle(w, m, r, dtype):
    x, a_dm, idx, mask = _bucket_np(w * m + r, r, w, m, 500)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    dest = np.arange(r, dtype=np.int32)[::-1].copy()
    out = torch.zeros((m, r))
    before = ax_reduce_bucket_x.launches
    ax_reduce_bucket_x(torch.from_numpy(x).to(td),
                       torch.from_numpy(a_dm).to(td), torch.from_numpy(idx),
                       torch.from_numpy(mask), torch.from_numpy(dest), out)
    assert ax_reduce_bucket_x.launches == before
    got = out[:, torch.from_numpy(dest).long()].T.numpy()
    args = (jnp.asarray(x, jd), jnp.asarray(a_dm, jd), jnp.asarray(idx),
            jnp.asarray(mask))
    tol = 1e-5 if dtype == "float32" else 5e-2
    for want in (rops.ax_reduce_bucket_x(*args), rref.ax_reduce_x_ref(*args)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def instance():
    spec = dict(num_sources=300, num_destinations=23, avg_nnz_per_row=6,
                seed=5, num_families=2)
    return (rinst.generate(rinst.InstanceSpec(**spec)),
            tinst.generate(tinst.InstanceSpec(**spec)))


def test_ax_aligned_x_matches_reference(instance):
    r, t = instance
    plan_r = jax.tree.map(jnp.asarray, rinst.build_ax_plan(r))
    plan_t = plan_to_torch(tinst.build_ax_plan(t), "cpu")
    E = sum(s.n * s.width for s in t.slabs)
    x = np.random.default_rng(0).uniform(0, 1, E).astype(np.float32)
    got = tops.ax_aligned_x(plan_t, torch.from_numpy(x)).numpy()
    want = jax.jit(rops.ax_aligned_x)(plan_r, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tref.ax_plan_x_ref(plan_t, torch.from_numpy(x)).numpy(), got,
        rtol=1e-6, atol=1e-7)


def test_plain_versions_match_oracles(instance):
    _, t = instance
    lp = lp_to_torch(t, "cpu")
    s = lp.slabs[-1]
    lam = torch.rand((lp.m, lp.num_destinations),
                     generator=torch.Generator().manual_seed(1))
    x, _, _ = tref.dual_x_ref(*s[:6], lam, torch.tensor(0.01))
    xo, _, _, _ = rref.dual_xstar_ref(*(jnp.asarray(v.numpy()) for v in s[:6]),
                                      jnp.asarray(lam.numpy()),
                                      jnp.float32(0.01))
    np.testing.assert_allclose(x.numpy(), np.asarray(xo), atol=1e-5)


# K3, K4, K5: the CASES above plus one 2,048-wide case (rows past the
# register path of the kernels), float32 and bfloat16.
WIDE_CASES = CASES + [(2048, 1, 8)]
DTYPES = [(jnp.float32, torch.float32, 1e-5),
          (jnp.bfloat16, torch.bfloat16, 5e-2)]


@pytest.mark.parametrize("w,m,n", WIDE_CASES)
@pytest.mark.parametrize("jd,td,tol", DTYPES)
def test_dual_grad_slab_matches_pallas(w, m, n, jd, td, tol):
    slab, lam = _slab_np(w + 3 * m, n, w, m, 23)
    sj, st = _to(slab, jd, td)
    gamma = 0.1
    before = dual_grad_slab.launches
    x, g, cx, xsq = tops.dual_grad_slab(st, torch.from_numpy(lam),
                                        torch.tensor(gamma))
    assert dual_grad_slab.launches == before       # the CPU runs no kernel
    assert g.shape == (n, w, m) and g.dtype == td
    assert (g[~st.mask] == 0).all()
    xp, gp, cxp, xsqp = rops.dual_grad_slab(sj, jnp.asarray(lam),
                                            jnp.float32(gamma))
    np.testing.assert_allclose(x.float().numpy(), np.asarray(xp, np.float32),
                               atol=tol)
    # gvals = a ⊙ x: a reaches ~5, so x's tolerance scales with it
    np.testing.assert_allclose(g.float().numpy(), np.asarray(gp, np.float32),
                               atol=tol * float(slab.a_vals.max()))
    np.testing.assert_allclose(float(cx), float(cxp), rtol=tol)
    np.testing.assert_allclose(float(xsq), float(xsqp), rtol=tol)
    x1, cx1, xsq1 = tops.dual_x_full(st, torch.from_numpy(lam),
                                     torch.tensor(gamma))
    assert torch.equal(x, x1) and torch.equal(cx, cx1)
    assert torch.equal(xsq, xsq1)
    assert torch.equal(tops.dual_xstar(st, torch.from_numpy(lam),
                                       torch.tensor(gamma)), x)


@pytest.mark.parametrize("w,m,n", WIDE_CASES)
@pytest.mark.parametrize("jd,td,tol", DTYPES)
def test_ax_reduce_bucket_gvals_matches_pallas(w, m, n, jd, td, tol):
    E = 500
    rng = np.random.default_rng(w * m + n)
    deg = rng.integers(0, w + 1, size=n)
    mask = np.arange(w)[None, :] < deg[:, None]
    idx = np.where(mask, rng.integers(0, E, (n, w)), 0).astype(np.int32)
    gvals = rng.lognormal(0, 0.5, (E, m)).astype(np.float32)
    before = ax_reduce_bucket.launches
    got = tops.ax_reduce_bucket(torch.from_numpy(gvals).to(td),
                                torch.from_numpy(idx), torch.from_numpy(mask))
    assert ax_reduce_bucket.launches == before
    args = (jnp.asarray(gvals, jd), jnp.asarray(idx), jnp.asarray(mask))
    for want in (rops.ax_reduce_bucket(*args), rref.ax_reduce_ref(*args)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("w,m,n", WIDE_CASES)
@pytest.mark.parametrize("jd,td,tol", DTYPES)
def test_proj_boxcut_matches_pallas(w, m, n, jd, td, tol):
    rng = np.random.default_rng(w + n)
    deg = rng.integers(0, w + 1, size=n)
    mask = np.arange(w)[None, :] < deg[:, None]
    v = np.where(mask, rng.uniform(-1.0, 2.0, (n, w)), 0).astype(np.float32)
    ub = np.where(mask, rng.uniform(0.5, 1.0, (n, w)), 0).astype(np.float32)
    s = rng.uniform(0.5, 4.0, n).astype(np.float32)
    before = proj_boxcut.launches
    x = tops.proj_boxcut(*(torch.from_numpy(a).to(td) for a in (v, ub, s)),
                         torch.from_numpy(mask))
    assert proj_boxcut.launches == before and x.dtype == td
    args = (jnp.asarray(v, jd), jnp.asarray(ub, jd), jnp.asarray(s, jd),
            jnp.asarray(mask))
    for want in (rops.proj_boxcut(*args), rref.boxcut_bisect_ref(*args)):
        np.testing.assert_allclose(x.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol)


def test_ax_aligned_matches_reference(instance):
    """The gvals Ax over the index-only plan against the reference's, and
    equal bit for bit to the x-carry Ax when gvals = a ⊙ x."""
    r, t = instance
    plan_r = jax.tree.map(jnp.asarray, rinst.build_ax_plan(
        r, carry_values=False))
    plan_t = plan_to_torch(tinst.build_ax_plan(t, carry_values=False), "cpu")
    assert all(b.a_dm is None for b in plan_t.buckets)
    E = sum(s.n * s.width for s in t.slabs)
    x = np.random.default_rng(0).uniform(0, 1, E).astype(np.float32)
    a_flat = np.concatenate([s.a_vals.reshape(-1, s.a_vals.shape[-1])
                             for s in t.slabs])
    gvals = torch.from_numpy(a_flat) * torch.from_numpy(x)[:, None]
    got = tops.ax_aligned(plan_t, gvals)
    want = jax.jit(rops.ax_aligned, static_argnames="use_pallas")(
        plan_r, jnp.asarray(gvals.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(tref.ax_plan_ref(plan_t, gvals), got)
    plan_x = plan_to_torch(tinst.build_ax_plan(t), "cpu")
    assert torch.equal(tops.ax_aligned_x(plan_x, torch.from_numpy(x)), got)
