"""The port's CUDA kernels (K1-K5) against their plain PyTorch versions,
and the objective's modes, on the card.

Imports torch and the port only (no JAX), so it also runs where JAX is not
installed:  PYTHONPATH=src python -m pytest tests/test_torch_cuda.py
Every test is marked `cuda` and skips where no NVIDIA GPU is present.

Tolerances: float32 x at atol 1e-4 and the scalars at rtol 1e-5 (only the
order of float32 sums differs between kernel and plain version); bfloat16
at 5e-2 (one bf16 rounding of x, of order 2⁻⁸ relative).  Against their
kernel-order plain versions (`ref.*_lanes_ref`, `ref.*_block_ref`,
`ref.ax_items_ref`), which repeat the kernels' order of the sums, the
kernels are held bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import lp_to_torch
from repro_torch.core import (InstanceSpec, MatchingObjective, Maximizer,
                              SolveConfig, StoppingCriteria, generate,
                              precondition)
from repro_torch.core.types import AxBucket, AxPlan
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ax_reduce import (ax_reduce_bucket, ax_reduce_bucket_x,
                                           ax_reduce_plan, ax_reduce_plan_x,
                                           plan_work)
from repro_torch.kernels.dual_grad import (dual_grad_slab, dual_x_slab,
                                           row_layout)
from repro_torch.kernels.proj import proj_boxcut

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _slab(rng, n, w, m, J):
    """Random (n, w, m) slab with ragged row degrees, as numpy float32."""
    deg = rng.integers(0, w + 1, size=n)
    mask = np.arange(w)[None, :] < deg[:, None]
    a = np.where(mask[..., None], rng.lognormal(0, 0.5, (n, w, m)), 0)
    c = np.where(mask, -rng.lognormal(0, 0.5, (n, w)), 0)
    dest = np.where(mask, rng.integers(0, J, (n, w)), 0)
    ub = np.where(mask, 1.0, 0.0)
    s = np.ones(n)
    lam = rng.uniform(0, 2.0, (m, J))
    f = np.float32
    return (a.astype(f), c.astype(f), dest.astype(np.int32), mask,
            ub.astype(f), s.astype(f), lam.astype(f))


WIDTHS = [4, 8, 16, 32, 64, 128, 256, 1024, 2048, 8192, 32768]


def _rows(w):
    """Rows of a test slab: 1237, fewer for the widest rows."""
    return min(1237, 2_000_000 // w)


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dual_x_kernel_matches_plain(dev, w, m, dtype):
    rng = np.random.default_rng(w * 10 + m)
    n, J = _rows(w), 97
    a, c, dest, mask, ub, s, lam = (torch.from_numpy(v).to(dev) for v in
                                    _slab(rng, n, w, m, J))
    a, c, ub, s = (t.to(dtype) for t in (a, c, ub, s))
    gamma = torch.full((), 0.01, device=dev)
    before = dual_x_slab.launches
    x, cx, xsq = dual_x_slab(a, c, dest, mask, ub, s, lam, gamma)
    torch.cuda.synchronize()
    assert dual_x_slab.launches == before + 1
    xr, cxr, xsqr = ref.dual_x_ref(a, c, dest, mask, ub, s, lam,
                                   gamma.to(dtype))
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(x.float().cpu().numpy(),
                               xr.float().cpu().numpy(), atol=tol)
    rtol = 1e-5 if dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(float(cx), float(cxr), rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(float(xsq), float(xsqr), rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("w", [4, 64, 1024, 2048, 8192, 32768])
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dual_grad_kernel_matches_plain_and_dual_x(dev, w, m, dtype):
    """K3 against its plain version, and its x, cᵀx, ‖x‖² against K1's
    bit for bit; gvals is written everywhere: a ⊙ x of its own x in the
    slab's type (the plain version's product), 0 on padding."""
    rng = np.random.default_rng(w * 7 + m)
    n, J = _rows(w), 97
    a, c, dest, mask, ub, s, lam = (torch.from_numpy(v).to(dev) for v in
                                    _slab(rng, n, w, m, J))
    a, c, ub, s = (t.to(dtype) for t in (a, c, ub, s))
    gamma = torch.full((), 0.01, device=dev)
    gv = torch.full((n, w, m), float("nan"), device=dev).to(dtype)
    before = dual_grad_slab.launches
    x, g, cx, xsq = dual_grad_slab(a, c, dest, mask, ub, s, lam, gamma,
                                   gvals_out=gv)
    torch.cuda.synchronize()
    assert dual_grad_slab.launches == before + 1
    assert g.data_ptr() == gv.data_ptr()
    assert not torch.isnan(g.float()).any()
    assert (g[~mask] == 0).all()
    x1, cx1, xsq1 = dual_x_slab(a, c, dest, mask, ub, s, lam, gamma)
    assert torch.equal(x, x1) and torch.equal(cx, cx1)
    assert torch.equal(xsq, xsq1)
    xr, _, cxr, xsqr = ref.dual_grad_ref(a, c, dest, mask, ub, s, lam,
                                          gamma.to(dtype))
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(x.float().cpu().numpy(),
                               xr.float().cpu().numpy(), atol=tol)
    zero = torch.zeros((), dtype=dtype, device=dev)
    assert torch.equal(g, torch.where(mask[..., None], a * x[..., None],
                                      zero))
    rtol = 1e-5 if dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(float(cx), float(cxr), rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(float(xsq), float(xsqr), rtol=rtol, atol=1e-6)


def _hard_slab(rng, n, w, m, J):
    """A slab with non-prefix masks, all-padding rows, rows whose f0 <= s
    (they run no bisection step) and rows that need the loop."""
    mask = ((np.arange(w)[None, :] < rng.integers(0, w + 1, n)[:, None])
            & (rng.random((n, w)) < 0.8))
    mask[rng.random(n) < 0.05] = False
    a = np.where(mask[..., None], rng.lognormal(0, 0.5, (n, w, m)), 0)
    c = np.where(mask, -rng.lognormal(0, 0.5, (n, w)), 0)
    dest = np.where(mask, rng.integers(0, J, (n, w)), 0)
    ub = np.where(mask, rng.uniform(0.5, 1.0, (n, w)), 0)
    s = np.where(rng.random(n) < 0.3, 1e6, rng.uniform(0.5, 4.0, n))
    lam = rng.uniform(0, 2.0, (m, J))
    f = np.float32
    return (a.astype(f), c.astype(f), dest.astype(np.int32), mask,
            ub.astype(f), s.astype(f), lam.astype(f))


@pytest.mark.parametrize("w", [w for w in WIDTHS if w <= 1024]
                         + [3, 24, 100, 1000])
@pytest.mark.parametrize("m", [1, 2])
def test_dual_x_kernels_equal_lanes_ref(dev, w, m):
    """K1 and K3 in float32 equal their kernel-order plain version
    `ref.dual_x_lanes_ref` / `dual_grad_lanes_ref` bit for bit (the early
    exit gives the fixed count's τ), at γ = 0.001; K3's x, cᵀx, ‖x‖² are
    K1's; two runs give the same bits.  Widths that are not a multiple of
    VPT (3, 100, 1000) take the kernels' value-by-value loads."""
    rng = np.random.default_rng(w * 13 + m)
    n, J = _rows(w), 97
    a, c, dest, mask, ub, s, lam = (torch.from_numpy(v).to(dev) for v in
                                    _hard_slab(rng, n, w, m, J))
    gamma = torch.full((), 0.001, device=dev)
    lay = row_layout(w)
    xr, gr, cxr, xsqr = ref.dual_grad_lanes_ref(a, c, dest, mask, ub, s, lam,
                                                gamma, 40, lay)
    runs = [dual_x_slab(a, c, dest, mask, ub, s, lam, gamma)
            for _ in range(2)]
    for u, v in zip(*runs):
        assert torch.equal(u, v)
    x, cx, xsq = runs[0]
    assert torch.equal(x, xr) and torch.equal(cx, cxr)
    assert torch.equal(xsq, xsqr)
    x3, g3, cx3, xsq3 = dual_grad_slab(a, c, dest, mask, ub, s, lam, gamma)
    assert torch.equal(x3, x) and torch.equal(cx3, cx)
    assert torch.equal(xsq3, xsq) and torch.equal(g3, gr)


@pytest.mark.parametrize("w", [8, 32, 100])
def test_dual_x_kernels_drop_nan_as_lanes_ref(dev, w):
    """NaN multipliers at a few destinations make NaN entries of u in many
    rows: K1 and K3 drop them as `dual_x_lanes_ref` does (x 0 there, the
    row's τ from its other entries), bit for bit."""
    rng = np.random.default_rng(w)
    n, J = _rows(w), 97
    a, c, dest, mask, ub, s, lam = (torch.from_numpy(v).to(dev) for v in
                                    _hard_slab(rng, n, w, 2, J))
    lam[0, :5] = float("nan")
    lam[1, 90:] = float("nan")
    gamma = torch.full((), 0.001, device=dev)
    want = ref.dual_grad_lanes_ref(a, c, dest, mask, ub, s, lam, gamma, 40,
                                   row_layout(w))
    got = dual_grad_slab(a, c, dest, mask, ub, s, lam, gamma)
    got1 = dual_x_slab(a, c, dest, mask, ub, s, lam, gamma)
    assert bool((mask & (dest < 5)).any())
    for u, v in zip(got, want):
        torch.testing.assert_close(u, v, rtol=0, atol=0, equal_nan=True)
    for u, v in zip(got1, (want[0], want[2], want[3])):
        torch.testing.assert_close(u, v, rtol=0, atol=0, equal_nan=True)
    assert not got[0].isnan().any()


def test_dual_x_refuses_misaligned_out(dev):
    """The vector stores need x's rows 16-byte aligned: an `out` one float
    off is refused, not written."""
    rng = np.random.default_rng(4)
    args = [torch.from_numpy(v).to(dev) for v in _slab(rng, 64, 32, 1, 50)]
    gamma = torch.full((), 0.01, device=dev)
    buf = torch.full((64 * 32 + 1,), 7.0, device=dev)
    before = dual_x_slab.launches
    with pytest.raises(ValueError, match="aligned"):
        dual_x_slab(*args, gamma, out=buf[1:].view(64, 32))
    with pytest.raises(ValueError, match="aligned"):
        dual_grad_slab(*args, gamma, out=buf[1:].view(64, 32))
    assert dual_x_slab.launches == before and (buf == 7.0).all()
    x, _, _ = dual_x_slab(*args, gamma, out=buf[:-1].view(64, 32))
    assert x.data_ptr() == buf.data_ptr()


@pytest.mark.parametrize("w", [4, 16, 64, 1024, 2048, 8192, 32768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_proj_kernel_matches_plain(dev, w, dtype):
    rng = np.random.default_rng(w + 5)
    n = _rows(w)
    deg = rng.integers(0, w + 1, size=n)
    mask = np.arange(w)[None, :] < deg[:, None]
    v = np.where(mask, rng.uniform(-1.0, 2.0, (n, w)), 0)
    ub = np.where(mask, rng.uniform(0.5, 1.0, (n, w)), 0)
    s = rng.uniform(0.5, 4.0, n)
    vt, ubt, st = (torch.from_numpy(t).to(dev).to(dtype) for t in (v, ub, s))
    mt = torch.from_numpy(mask).to(dev)
    before = proj_boxcut.launches
    x = proj_boxcut(vt, ubt, st, mt)
    torch.cuda.synchronize()
    assert proj_boxcut.launches == before + 1
    xr = ref.proj_boxcut_ref(vt, ubt, st, mt)
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(x.float().cpu().numpy(),
                               xr.float().cpu().numpy(), atol=tol)


@pytest.mark.parametrize("w", [64, 1024, 2048, 8192, 32768])
def test_proj_of_u_gives_dual_x(dev, w):
    """K5 fed a slab's pre-projection u gives K1's x bit for bit: the same
    layout (lanes up to 1,024, a block a row past it), the same sums and
    the same stopping rule."""
    rng = np.random.default_rng(w + 9)
    n, J = _rows(w), 97
    a, c, dest, mask, ub, s, lam = (torch.from_numpy(v).to(dev) for v in
                                    _slab(rng, n, w, 1, J))
    gamma = torch.full((), 0.1, device=dev)
    x1, _, _ = dual_x_slab(a, c, dest, mask, ub, s, lam, gamma)
    u = -(a[:, :, 0] * lam[0][dest.long()] + c) / gamma
    x5 = proj_boxcut(u, ub, s, mask)
    assert torch.equal(x5, x1)


def _order_ref(v, ub, s, mask, iters=40):
    """K5's kernel-order plain version for rows of v's width."""
    w = v.shape[1]
    if w > 1024:
        return ref.proj_block_ref(v, ub, s, mask, iters)
    return ref.proj_lanes_ref(v, ub, s, mask, iters, row_layout(w))


@pytest.mark.parametrize("w", [4, 16, 64, 100, 1024, 1500, 2048, 8192,
                               32768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_proj_kernel_equals_order_ref(dev, w, dtype):
    """K5 equals its kernel-order plain version (`proj_lanes_ref`, or
    `proj_block_ref` past 1,024) bit for bit, twice; widths 100 and 1,500
    take the value-by-value loads."""
    rng = np.random.default_rng(w + 6)
    n = _rows(w)
    deg = rng.integers(0, w + 1, size=n)
    mask = ((np.arange(w)[None, :] < deg[:, None])
            & (rng.random((n, w)) < 0.9))
    v = np.where(mask, rng.uniform(-1.0, 2.0, (n, w)), 0)
    ub = np.where(mask, rng.uniform(0.5, 1.0, (n, w)), 0)
    s = np.where(rng.random(n) < 0.3, 1e6, rng.uniform(0.5, 4.0, n))
    vt, ubt, st = (torch.from_numpy(t).to(dev).to(dtype) for t in (v, ub, s))
    mt = torch.from_numpy(mask).to(dev)
    runs = [proj_boxcut(vt, ubt, st, mt) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0], _order_ref(vt, ubt, st, mt))


@pytest.mark.parametrize("w", [1500, 2048, 8192, 16384, 32768])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_wide_kernels_equal_block_ref(dev, w, m):
    """K1, K3 and K5 on rows wider than 1,024 (chunks in registers up to
    8,192, in shared memory up to 16,384, in global scratch past it) equal
    their block-order plain versions bit for bit at γ = 0.001: x, gvals
    (vector stores for m <= 2, value by value for m = 3 and at w = 1,500),
    cᵀx, ‖x‖²; K5 fed u gives K1's x; two runs give the same bits."""
    rng = np.random.default_rng(w * 17 + m)
    n, J = _rows(w), 97
    a, c, dest, mask, ub, s, lam = (torch.from_numpy(v).to(dev) for v in
                                    _hard_slab(rng, n, w, m, J))
    gamma = torch.full((), 0.001, device=dev)
    xr, gr, cxr, xsqr = ref.dual_grad_block_ref(a, c, dest, mask, ub, s, lam,
                                                gamma, 40)
    runs = [dual_x_slab(a, c, dest, mask, ub, s, lam, gamma)
            for _ in range(2)]
    for u, v in zip(*runs):
        assert torch.equal(u, v)
    x, cx, xsq = runs[0]
    assert torch.equal(x, xr) and torch.equal(cx, cxr)
    assert torch.equal(xsq, xsqr)
    x3, g3, cx3, xsq3 = dual_grad_slab(a, c, dest, mask, ub, s, lam, gamma)
    assert torch.equal(x3, x) and torch.equal(g3, gr)
    assert torch.equal(cx3, cx) and torch.equal(xsq3, xsq)
    atl = torch.zeros_like(c)
    for k in range(m):
        atl = atl + a[:, :, k] * lam[k][dest.long()]
    u = -(atl + c) / gamma
    x5 = proj_boxcut(u, ub, s, mask)
    assert torch.equal(x5, x)
    assert torch.equal(x5, ref.proj_block_ref(u, ub, s, mask, 40))


@pytest.mark.parametrize("w", [1500, 2048, 4096, 8192])
@pytest.mark.parametrize("store", ["SHARED", "GLOBAL"])
def test_wide_storage_gives_the_same_bits(dev, w, store):
    """A wide row's chunks staged in shared memory or in global scratch,
    at the layout the wrappers use, give the bits of its block-order
    plain version, as the chunks in registers do: K1, K3 (gvals) and
    K5."""
    from repro_torch.kernels import dual_grad as dg
    from repro_torch.kernels import proj
    rng = np.random.default_rng(w + len(store))
    n, m, J = 97, 2, 61
    a, c, dest, mask, ub, s, lam = (torch.from_numpy(v).to(dev) for v in
                                    _hard_slab(rng, n, w, m, J))
    gamma = torch.full((), 0.001, device=dev)
    st = getattr(dg, f"STORE_{store}")
    lay = ref.block_layout(w)
    xr, gr, cxr, xsqr = ref.dual_grad_block_ref(a, c, dest, mask, ub, s, lam,
                                                gamma, 40)
    x, cx, xsq = dg._launch(dual_x_slab, a, c, dest, mask, ub, s, lam, gamma,
                            40, None, None, lay, st)
    assert torch.equal(x, xr) and torch.equal(cx, cxr)
    assert torch.equal(xsq, xsqr)
    g = torch.empty_like(a)
    x3, cx3, xsq3 = dg._launch(dual_grad_slab, a, c, dest, mask, ub, s, lam,
                               gamma, 40, None, g, lay, st)
    assert torch.equal(x3, xr) and torch.equal(g, gr)
    assert torch.equal(cx3, cxr) and torch.equal(xsq3, xsqr)
    atl = torch.zeros_like(c)
    for k in range(m):
        atl = atl + a[:, :, k] * lam[k][dest.long()]
    u = -(atl + c) / gamma
    assert torch.equal(proj._launch(u, ub, s, mask, 40, lay, st), xr)


def test_wide_layout_without_instance_is_refused(dev):
    """A wide layout the kernels have no instance for (chunks of 64 in
    registers) or one that does not cover the row raises, and nothing is
    launched: no fallback to another layout."""
    from repro_torch.kernels import dual_grad as dg
    from repro_torch.kernels import proj
    n, w = 4, 16384
    v = torch.zeros((n, w), device=dev)
    mask = torch.ones((n, w), dtype=torch.bool, device=dev)
    s = torch.ones(n, device=dev)
    before = proj_boxcut.launches
    for lay in ((256, 64), (256, 32)):
        with pytest.raises(RuntimeError, match="not supported"):
            proj._launch(v, v, s, mask, 40, lay, dg.STORE_REGS)
    assert proj_boxcut.launches == before


@pytest.mark.parametrize("w", [32, 2048])
def test_proj_refuses_misaligned_input(dev, w):
    """K5's vector loads need v, ub and the mask 16-byte aligned (8 bytes
    for the mask at 8 values a lane): a v one float off is refused, not
    launched."""
    rng = np.random.default_rng(w)
    n = 16
    buf = torch.from_numpy(rng.uniform(-1, 2, n * w + 1).astype(
        np.float32)).to(dev)
    ub = torch.ones((n, w), device=dev)
    s = torch.ones(n, device=dev)
    mask = torch.ones((n, w), dtype=torch.bool, device=dev)
    before = proj_boxcut.launches
    with pytest.raises(ValueError, match="aligned"):
        proj_boxcut(buf[1:].view(n, w), ub, s, mask)
    assert proj_boxcut.launches == before
    x = proj_boxcut(buf[:-1].view(n, w), ub, s, mask)
    assert proj_boxcut.launches == before + 1
    assert torch.equal(x, _order_ref(buf[:-1].view(n, w), ub, s, mask))


def test_dual_x_kernel_is_deterministic(dev):
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(v).to(dev) for v in _slab(rng, 5000, 64, 1, 300)]
    gamma = torch.full((), 0.01, device=dev)
    r1 = dual_x_slab(*args, gamma)
    r2 = dual_x_slab(*args, gamma)
    for u, v in zip(r1, r2):
        assert torch.equal(u, v)


@pytest.mark.parametrize("w", [4, 64, 1024, 2048, 8192, 16384, 131072])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ax_reduce_kernel_matches_plain(dev, w, m, dtype):
    rng = np.random.default_rng(w + m)
    E = 300_000
    r = max(1, min(300, 2_000_000 // w))
    deg = rng.integers(1, w + 1, size=r)
    mask = np.arange(w)[None, :] < deg[:, None]
    idx = np.where(mask, rng.integers(0, E, (r, w)), 0).astype(np.int32)
    a_dm = np.where(mask[..., None], rng.lognormal(0, 0.5, (r, w, m)), 0)
    x = rng.uniform(0, 1, E)
    J = r + 5
    dest_ids = rng.permutation(J)[:r].astype(np.int32)
    x_t = torch.from_numpy(x).to(dev).to(dtype)
    a_t = torch.from_numpy(a_dm).to(dev).to(dtype)
    idx_t, mask_t, d_t = (torch.from_numpy(v).to(dev)
                          for v in (idx, mask, dest_ids))
    out = torch.full((m, J), float("nan"), device=dev)
    before = ax_reduce_bucket_x.launches
    ax_reduce_bucket_x(x_t, a_t, idx_t, mask_t, d_t, out)
    torch.cuda.synchronize()
    assert ax_reduce_bucket_x.launches == before + 1
    want = ref.ax_reduce_x_ref(x_t, a_t, idx_t, mask_t).T
    got = out[:, d_t.long()]
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=tol, atol=tol)
    untouched = torch.ones(J, dtype=torch.bool, device=dev)
    untouched[d_t.long()] = False
    assert torch.isnan(out[:, untouched]).all()


@pytest.mark.parametrize("w", [4, 64, 1024, 2048, 8192, 131072])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ax_reduce_gvals_kernel_matches_plain_and_x_carry(dev, w, m, dtype):
    """K4 against its plain version; fed gvals = a ⊙ x it gives K2's Ax
    from (x, a_dm) bit for bit (the same products, summed in one order)."""
    rng = np.random.default_rng(w * 3 + m)
    E = 300_000
    r = max(1, min(300, 2_000_000 // w))
    deg = rng.integers(1, w + 1, size=r)
    mask = np.arange(w)[None, :] < deg[:, None]
    idx = np.where(mask, rng.integers(0, E, (r, w)), 0).astype(np.int32)
    a_flat = rng.lognormal(0, 0.5, (E, m))
    x = rng.uniform(0, 1, E)
    J = r + 5
    dest_ids = rng.permutation(J)[:r].astype(np.int32)
    x_t = torch.from_numpy(x).to(dev).to(dtype)
    af_t = torch.from_numpy(a_flat).to(dev).to(dtype)
    idx_t, mask_t, d_t = (torch.from_numpy(v).to(dev)
                          for v in (idx, mask, dest_ids))
    a_dm = torch.where(mask_t[..., None], af_t[idx_t.long()],
                       torch.zeros((), dtype=dtype, device=dev))
    gvals = af_t * x_t[:, None]
    out = torch.full((m, J), float("nan"), device=dev)
    before = ax_reduce_bucket.launches
    ax_reduce_bucket(gvals, idx_t, mask_t, d_t, out)
    torch.cuda.synchronize()
    assert ax_reduce_bucket.launches == before + 1
    want = ref.ax_reduce_ref(gvals, idx_t, mask_t).T
    got = out[:, d_t.long()]
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=tol, atol=tol)
    untouched = torch.ones(J, dtype=torch.bool, device=dev)
    untouched[d_t.long()] = False
    assert torch.isnan(out[:, untouched]).all()
    out_x = torch.full((m, J), float("nan"), device=dev)
    ax_reduce_bucket_x(x_t, a_dm.contiguous(), idx_t, mask_t, d_t, out_x)
    assert torch.equal(out[:, d_t.long()], out_x[:, d_t.long()])


# A multi-bucket plan: widths 4 to 262,144; rows of extent 0 (width 4),
# of one item and of many (the widest); bucket 64 with a non-prefix mask
# (holes inside, padding after).
PLAN_SHAPE = [(4, 300), (16, 200), (64, 100), (1024, 40), (4096, 20),
              (32768, 4), (262144, 1)]


def _plan_np(rng, m, E):
    """(a_flat (E, m), x (E,), [(edge_idx, mask, dest_ids, a_dm)]) of a
    random plan of PLAN_SHAPE, a_dm = a_flat[edge_idx] on real entries."""
    a_flat = rng.lognormal(0, 0.5, (E, m))
    x = rng.uniform(0, 1, E)
    J = sum(r for _, r in PLAN_SHAPE)
    dests = rng.permutation(J).astype(np.int32)
    buckets, off = [], 0
    for w, r in PLAN_SHAPE:
        if w == 64:
            end = rng.integers(w // 2 + 1, w, size=r)
            mask = ((rng.random((r, w)) < 0.5)
                    & (np.arange(w)[None, :] < end[:, None]))
        else:
            lo = 0 if w == 4 else w // 2 + 1
            deg = rng.integers(lo, w + 1, size=r)
            mask = np.arange(w)[None, :] < deg[:, None]
        idx = np.where(mask, rng.integers(0, E, (r, w)), 0).astype(np.int32)
        a_dm = np.where(mask[..., None], a_flat[idx], 0.0)
        buckets.append((idx, mask, dests[off:off + r], a_dm))
        off += r
    return a_flat, x, buckets


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ax_plan_kernels_match_plain(dev, m, dtype):
    """K2 and K4 over a whole multi-bucket plan, one launch each (plus the
    second pass), against their plain versions; K4 fed a ⊙ x equals K2 bit
    for bit; two runs are bit-identical; every destination is written."""
    rng = np.random.default_rng(40 + m)
    E = 1_000_000
    a_flat, x, buckets = _plan_np(rng, m, E)
    to = lambda v: torch.from_numpy(v).to(dev)
    x_t, af_t = to(x).to(dtype), to(a_flat).to(dtype)
    plan = AxPlan(tuple(AxBucket(to(i), to(mk), to(d), to(a).to(dtype))
                        for i, mk, d, a in buckets),
                  inv_perm=torch.zeros(sum(r for _, r in PLAN_SHAPE),
                                       dtype=torch.int32, device=dev))
    plan_g = AxPlan(tuple(b._replace(a_dm=None) for b in plan.buckets),
                    plan.inv_perm)
    J = plan.num_destinations
    work = plan_work(plan)
    assert work.multi.shape[0] > 0 and work.items.shape[0] > J
    outs = []
    for _ in range(2):
        out = torch.full((m, J), float("nan"), device=dev)
        before = ax_reduce_plan_x.launches
        ax_reduce_plan_x(x_t, plan, out, work)
        torch.cuda.synchronize()
        assert ax_reduce_plan_x.launches == before + 1
        outs.append(out)
    assert not torch.isnan(outs[0]).any()
    assert torch.equal(outs[0], outs[1])
    # the kernel's own order of the sums, in plain torch
    assert torch.equal(outs[0], ref.ax_items_ref(plan, work, x=x_t))
    # the inv_perm-free reference: each bucket's rows at its dest_ids
    want = torch.empty((m, J), device=dev)
    for b in plan.buckets:
        want[:, b.dest_ids.long()] = ref.ax_reduce_x_ref(
            x_t, b.a_dm, b.edge_idx, b.mask).T
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(outs[0].cpu().numpy(), want.cpu().numpy(),
                               rtol=tol, atol=tol)
    gvals = af_t * x_t[:, None]
    out_g = torch.full((m, J), float("nan"), device=dev)
    before = ax_reduce_plan.launches
    ax_reduce_plan(gvals, plan_g, out_g, plan_work(plan_g))
    torch.cuda.synchronize()
    assert ax_reduce_plan.launches == before + 1
    assert torch.equal(out_g, outs[0])
    want_g = torch.empty((m, J), device=dev)
    for b in plan_g.buckets:
        want_g[:, b.dest_ids.long()] = ref.ax_reduce_ref(
            gvals, b.edge_idx, b.mask).T
    np.testing.assert_allclose(out_g.cpu().numpy(), want_g.cpu().numpy(),
                               rtol=tol, atol=tol)
    # a table is bound to the tensors it was built for, and to a big
    # enough x and out
    with pytest.raises(ValueError):
        ax_reduce_plan_x(x_t, plan, out_g, plan_work(plan_g))
    with pytest.raises(ValueError):
        ax_reduce_plan_x(x_t[:10], plan, out_g, work)
    with pytest.raises(ValueError):
        ax_reduce_plan_x(x_t, plan, out_g[:, :5].contiguous(), work)
    # the entry points build the table themselves when none is given
    assert torch.equal(ops.ax_aligned_x(plan, x_t, out_dtype=torch.float32),
                       outs[0])
    assert torch.equal(ops.ax_aligned(plan_g, gvals, out_dtype=torch.float32),
                       outs[0])


def test_ax_plan_against_plan_reference(dev):
    """The plan-level K2 and K4 on a generated instance's plans against
    `ref.ax_plan_x_ref` / `ref.ax_plan_ref` (the inv_perm assembly)."""
    from repro_torch.convert import plan_to_torch
    from repro_torch.core import build_ax_plan
    lp_np = generate(InstanceSpec(num_sources=20000, num_destinations=300,
                                  avg_nnz_per_row=30, seed=3,
                                  num_families=2))
    E = sum(s.n * s.width for s in lp_np.slabs)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(0, 1, E).astype(np.float32)).to(dev)
    plan = plan_to_torch(build_ax_plan(lp_np), dev)
    got = ops.ax_aligned_x(plan, x, work=plan_work(plan))
    np.testing.assert_allclose(got.cpu().numpy(),
                               ref.ax_plan_x_ref(plan, x).cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    plan_g = plan_to_torch(build_ax_plan(lp_np, carry_values=False), dev)
    gvals = torch.from_numpy(rng.uniform(0, 1, (E, 2)).astype(
        np.float32)).to(dev)
    got_g = ops.ax_aligned(plan_g, gvals, work=plan_work(plan_g))
    np.testing.assert_allclose(got_g.cpu().numpy(),
                               ref.ax_plan_ref(plan_g, gvals).cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_aligned_gvals_equals_aligned_on_card(dev):
    """One evaluation and a 300-iteration trajectory: `aligned_gvals`
    (K3 + K4) equals `aligned` (K1 + K2) bit for bit."""
    lp_np = generate(InstanceSpec(num_sources=20000, num_destinations=300,
                                  avg_nnz_per_row=30, seed=1))
    lp, _ = precondition(lp_to_torch(lp_np, dev), row_norm=True)
    objs = [MatchingObjective(lp, ax_mode=mode)
            for mode in ("aligned", "aligned_gvals")]
    lam = torch.rand(objs[0].dual_shape, device=dev,
                     generator=torch.Generator(dev).manual_seed(0))
    gamma = torch.full((), 0.01, device=dev)
    (g1, d1, a1), (g2, d2, a2) = (o.calculate(lam, gamma) for o in objs)
    assert torch.equal(g1, g2) and torch.equal(d1, d2)
    assert all(torch.equal(u, v) for u, v in zip(a1, a2))
    cfg = SolveConfig(iterations=300, gamma=0.01, max_step=0.1)
    k3, k4 = dual_grad_slab.launches, ax_reduce_plan.launches
    r1, r2 = (Maximizer(cfg).maximize(o) for o in objs)
    assert dual_grad_slab.launches > k3 and ax_reduce_plan.launches > k4
    assert torch.equal(r1.lam, r2.lam)
    assert np.array_equal(r1.stats.dual_obj, r2.stats.dual_obj)


@pytest.mark.parametrize("mode", ["scatter", "sorted"])
def test_scatter_modes_on_card(dev, mode):
    """scatter and sorted on the card against the CPU's calculate, and
    both repeatable bit for bit (scatter's atomics sum in float64)."""
    lp_np = generate(InstanceSpec(num_sources=20000, num_destinations=300,
                                  avg_nnz_per_row=30, seed=2))
    out = {}
    for d in ("cpu", dev):
        lp, _ = precondition(lp_to_torch(lp_np, d), row_norm=True)
        obj = MatchingObjective(lp, ax_mode=mode)
        lam = torch.from_numpy(np.random.default_rng(0).uniform(
            0, 1, obj.dual_shape).astype(np.float32)).to(d)
        gamma = torch.full((), 0.01, device=d)
        out[str(d)] = [obj.calculate(lam, gamma) for _ in range(2)]
    (gc, dc, _), _ = out["cpu"]
    (g1, d1, _), (g2, d2, _) = out["cuda"]
    np.testing.assert_allclose(float(g1), float(gc), rtol=1e-5)
    np.testing.assert_allclose(d1.cpu().numpy(), dc.numpy(), rtol=1e-5,
                               atol=1e-4)
    assert torch.equal(g1, g2) and torch.equal(d1, d2)


def test_solve_on_card_matches_cpu(dev):
    """A small tolerance-terminated solve runs through both kernels on the
    card and lands where the CPU's plain versions land."""
    lp_np = generate(InstanceSpec(num_sources=2000, num_destinations=100,
                                  avg_nnz_per_row=8, seed=42))
    cfg = SolveConfig(iterations=1500, gamma=0.01, max_step=0.1,
                      gamma_init=0.16, adaptive_continuation=True)
    crit = StoppingCriteria(tol_rel_dual=1e-6, check_every=25)
    out = {}
    for d in ("cpu", dev):
        lp, _ = precondition(lp_to_torch(lp_np, d), row_norm=True)
        obj = MatchingObjective(lp)
        k1, k2 = dual_x_slab.launches, ax_reduce_plan_x.launches
        res = Maximizer(cfg).maximize(obj, criteria=crit)
        out[str(d)] = (res, dual_x_slab.launches - k1,
                       ax_reduce_plan_x.launches - k2)
    cpu, gpu = out["cpu"], out["cuda"]
    assert cpu[1] == 0 and cpu[2] == 0
    assert gpu[1] > 0 and gpu[2] > 0
    assert gpu[0].stop_reason == cpu[0].stop_reason
    g_cpu = float(cpu[0].stats.dual_obj[-1])
    g_gpu = float(gpu[0].stats.dual_obj[-1])
    assert abs(g_gpu - g_cpu) <= 1e-5 * abs(g_cpu)


# min_width = 1: slabs of 17, 33, 72 and 25 rows of width 1, 2, 4 and 8,
# so each later slab's slice of the objective's flat buffers starts past a
# gap that keeps it 16-byte aligned
ODD_SPEC = InstanceSpec(num_sources=150, num_destinations=23,
                        avg_nnz_per_row=3, seed=5, min_width=1)


def _odd_objective(d, mode, dtype):
    from repro_torch.convert import lp_to_numpy, plan_to_torch
    from repro_torch.core.instance import build_ax_plan
    from repro_torch.core.types import LPData, Slab
    lp, _ = precondition(lp_to_torch(generate(ODD_SPEC), d), row_norm=True)
    plan = None
    if mode.startswith("aligned"):
        plan = plan_to_torch(build_ax_plan(
            lp_to_numpy(lp), carry_values=mode == "aligned"), d)
        plan = plan._replace(buckets=tuple(
            b._replace(a_dm=None if b.a_dm is None else b.a_dm.to(dtype))
            for b in plan.buckets))
    lp = LPData(slabs=tuple(
        Slab(*(t.to(dtype) if t.is_floating_point() else t for t in s))
        for s in lp.slabs), b=lp.b)
    return MatchingObjective(lp, ax_mode=mode, ax_plan=plan)


@pytest.mark.parametrize("mode", ["aligned", "aligned_gvals", "scatter",
                                  "sorted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_odd_slab_rows_on_card(dev, mode, dtype):
    """Slabs whose sizes leave the next slab's slice of the flat buffers
    off a 16-byte boundary: the objective pads the slices, the kernels'
    vector stores run, and one evaluation matches the CPU's."""
    out = {}
    for d in ("cpu", dev):
        obj = _odd_objective(d, mode, dtype)
        sizes = [s.n * s.width for s in obj.lp.slabs]
        assert obj._offsets != list(np.cumsum([0] + sizes[:-1]))
        lam = torch.from_numpy(np.random.default_rng(0).uniform(
            0, 1, obj.dual_shape).astype(np.float32)).to(d)
        out[str(d)] = obj.calculate(lam, torch.full((), 0.01, device=d))
    (gc, dc, _), (g1, d1, _) = out["cpu"], out["cuda"]
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(float(g1), float(gc), rtol=tol)
    np.testing.assert_allclose(d1.cpu().numpy(), dc.numpy(), rtol=tol,
                               atol=tol * max(1.0, float(dc.abs().max())))


def test_odd_slab_rows_solve_on_card(dev):
    """A tolerance-terminated solve over those slabs runs K1 and K2 on the
    card and lands where the CPU's plain versions land."""
    cfg = SolveConfig(iterations=1500, gamma=0.01, max_step=0.1,
                      gamma_init=0.16, adaptive_continuation=True)
    crit = StoppingCriteria(tol_rel_dual=1e-6, check_every=25)
    out = {}
    for d in ("cpu", dev):
        obj = _odd_objective(d, "aligned", torch.float32)
        k1 = dual_x_slab.launches
        res = Maximizer(cfg).maximize(obj, criteria=crit)
        out[str(d)] = (res, dual_x_slab.launches - k1)
    cpu, gpu = out["cpu"], out["cuda"]
    assert cpu[1] == 0 and gpu[1] > 0
    assert gpu[0].stop_reason == cpu[0].stop_reason
    g_cpu = float(cpu[0].stats.dual_obj[-1])
    g_gpu = float(gpu[0].stats.dual_obj[-1])
    assert abs(g_gpu - g_cpu) <= 1e-5 * abs(g_cpu)


def test_row_norms_repeatable_and_match_cpu(dev):
    """Preconditioning sums each row in a fixed order on the card too."""
    from repro_torch.core import row_norms
    lp_np = generate(InstanceSpec(num_sources=20000, num_destinations=300,
                                  avg_nnz_per_row=30, seed=1))
    on_card = [row_norms(lp_to_torch(lp_np, dev)) for _ in range(3)]
    assert all(torch.equal(on_card[0], r) for r in on_card[1:])
    np.testing.assert_allclose(on_card[0].cpu().numpy(),
                               row_norms(lp_to_torch(lp_np, "cpu")).numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("mode", ["aligned", "aligned_gvals"])
@pytest.mark.parametrize("name", ["matching", "global_count", "multi_budget",
                                  "assignment_eq"])
def test_composed_objective_on_card_matches_cpu(dev, name, mode):
    """A compiled formulation on the card against the CPU's plain versions
    at γ = 0.1: g at rtol 1e-5 and ∇g at atol 1e-5·max(1, ‖∇g‖∞) (float32
    sums in another order).  The box-cut slabs launch K1 (K3 in
    aligned_gvals) once each, with the coupling rows folded into c;
    assignment_eq's simplex_eq slabs launch neither and take the plain
    sweep; the Ax launches K2 (K4) once."""
    from repro_torch import formulations
    lp_np = generate(InstanceSpec(num_sources=20000, num_destinations=300,
                                  avg_nnz_per_row=30, seed=3))
    sweep = dual_x_slab if mode == "aligned" else dual_grad_slab
    ax = ax_reduce_plan_x if mode == "aligned" else ax_reduce_plan
    out = {}
    for d in ("cpu", dev):
        obj = formulations.make_objective(name, lp_to_torch(lp_np, d),
                                          ax_mode=mode, row_norm=True)
        lam = torch.from_numpy(np.random.default_rng(0).uniform(
            0, 0.5, obj.dual_shape).astype(np.float32)).to(d)
        k = (sweep.launches, ax.launches)
        g, grad, _ = obj.calculate(lam, torch.full((), 0.1, device=d))
        out[str(d)] = (g, grad, sweep.launches - k[0], ax.launches - k[1],
                       len(obj.lp.slabs))
    gc, dc, s_cpu, a_cpu, _ = out["cpu"]
    g1, d1, s_gpu, a_gpu, n_slabs = out["cuda"]
    assert s_cpu == 0 and a_cpu == 0
    assert s_gpu == (0 if name == "assignment_eq" else n_slabs)
    assert a_gpu == 1
    np.testing.assert_allclose(float(g1), float(gc), rtol=1e-5)
    np.testing.assert_allclose(d1.cpu().numpy(), dc.numpy(),
                               atol=1e-5 * max(1.0, float(dc.abs().max())))


def test_plain_sweep_graph_equals_eager(dev):
    """assignment_eq's simplex_eq slabs project through one CUDA graph of
    the plain projection each (`objectives.ProjectionGraph`): the sweep's
    x equals `primal`'s eager projection bit for bit, and two evaluations
    give the same bits."""
    from repro_torch import formulations
    lp_np = generate(InstanceSpec(num_sources=20000, num_destinations=300,
                                  avg_nnz_per_row=30, seed=4))
    obj = formulations.make_objective("assignment_eq", lp_to_torch(lp_np, dev),
                                      row_norm=True)
    assert sorted(obj._graphs) == list(range(len(obj.lp.slabs)))
    lam = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 0.5, obj.dual_shape).astype(np.float32)).to(dev)
    gamma = torch.full((), 0.05, device=dev)
    first = obj.calculate(lam, gamma)
    xs = obj.primal(lam, gamma)
    for i, slab in enumerate(obj.lp.slabs):
        assert torch.equal(obj._views(i, slab)[0], xs[i])
    again = obj.calculate(lam, gamma)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def test_server_on_card_bitwise_and_streams(dev):
    """The allocation server on the card: warmup launches K1 once a
    shape; served rows equal `primal` bit for bit on every slab, the
    2,048-wide one included (a block a row); queries and re-solves run on
    two streams of the server's own, neither the default one."""
    from repro_torch import primal
    from repro_torch.kernels import dual_grad
    lp_np = generate(InstanceSpec(num_sources=3000, num_destinations=5000,
                                  avg_nnz_per_row=1000, seed=42))
    lp, _ = precondition(lp_to_torch(lp_np, dev), row_norm=True)
    obj = MatchingObjective(lp, ax_mode="aligned")
    assert max(s.width for s in lp.slabs) > 1024
    lam = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 0.05, obj.dual_shape).astype(np.float32)).to(dev)
    srv = primal.AllocationServer(obj, lam, 0.1, max_batch=64)
    before = dual_grad.dual_x_slab.launches
    n = srv.warmup()
    assert dual_grad.dual_x_slab.launches - before == n > 0
    full = obj.primal(srv.lam, torch.full((), 0.1, device=dev))
    got = srv.query(srv.source_ids().tolist())
    for d in got.values():
        assert np.array_equal(d.x, full[d.slab_index][d.row].cpu().numpy())
    default = torch.cuda.default_stream(dev)
    assert srv._query_stream != default and srv._resolve_stream != default
    assert srv._query_stream != srv._resolve_stream


def test_frontend_refresh_on_card(dev):
    """A background refresh on the card (its own stream) while the
    frontend answers: every response OK, each bit for bit the old or the
    new pair's rows, and the new pair served after it."""
    from repro_torch import primal
    lp_np = generate(InstanceSpec(num_sources=20000, num_destinations=300,
                                  avg_nnz_per_row=20, seed=9))
    lp, _ = precondition(lp_to_torch(lp_np, dev), row_norm=True)
    obj = MatchingObjective(lp, ax_mode="aligned")
    cfg = SolveConfig(iterations=400, gamma=0.01, max_step=1e-1,
                      initial_step=1e-5)
    res = Maximizer(cfg).maximize(obj)
    srv = primal.AllocationServer(obj, res.lam, 0.01, config=cfg)
    srv.warmup()
    tight = MatchingObjective(lp._replace(b=lp.b * 0.9), ax_mode="aligned")
    gamma = torch.full((), 0.01, device=dev)
    old = [x.cpu().numpy() for x in obj.primal(srv.lam, gamma)]
    fe = primal.ServerFrontend(srv)
    ids = srv.source_ids()
    assert fe.refresh(obj=tight)
    answers, k = [], 0
    while fe.refresh_in_flight() and k < 500:
        answers.append(fe.query(ids[k % 40 * 8:k % 40 * 8 + 8].tolist(),
                                deadline_s=30.0, timeout=60.0))
        k += 1
    status, warm = fe.wait_refresh(timeout=300.0)
    assert status == "accepted" and srv.obj is tight
    new = [x.cpu().numpy() for x in tight.primal(srv.lam, gamma)]
    for r in answers:
        assert r.status is primal.RequestStatus.OK
        rows = list(r.decisions.values())
        assert (all(np.array_equal(d.x, old[d.slab_index][d.row])
                    for d in rows)
                or all(np.array_equal(d.x, new[d.slab_index][d.row])
                       for d in rows))
    after = fe.query(ids[:8].tolist(), deadline_s=30.0, timeout=60.0)
    for d in after.decisions.values():
        assert np.array_equal(d.x, new[d.slab_index][d.row])
    fe.drain(timeout=30.0)


def _obs_objective(dev):
    lp_np = generate(InstanceSpec(num_sources=20000, num_destinations=300,
                                  avg_nnz_per_row=20, seed=9))
    lp, _ = precondition(lp_to_torch(lp_np, dev), row_norm=True)
    return MatchingObjective(lp, ax_mode="aligned")


def test_profiler_window_names_k1_and_k2(dev, tmp_path):
    """The trace of chunks 1-2 holds K1's and K2's kernels, as many as the
    launch counters counted over those chunks (a K2 call is two CUDA
    launches: the items, then the second pass); the observed solve
    equals the bare one bit for bit."""
    import json
    from repro_torch.kernels.ax_reduce import ax_reduce_plan_x
    from repro_torch.obs import ProfilerHook
    obj = _obs_objective(dev)
    cfg = SolveConfig(iterations=40, gamma=0.01, max_step=1e-1,
                      initial_step=1e-5)
    crit = StoppingCriteria(tol_grad_norm=0.0, check_every=10)
    bare = Maximizer(cfg).maximize(obj, criteria=crit)
    snaps = []
    prof = ProfilerHook(str(tmp_path), start_chunk=1, num_chunks=2)
    res = Maximizer(cfg).maximize(
        obj, criteria=crit, profiler=prof,
        diagnostics_fn=lambda rec: snaps.append(
            (dual_x_slab.launches, ax_reduce_plan_x.launches)))
    assert torch.equal(bare.lam, res.lam)
    k1 = snaps[2][0] - snaps[0][0]
    k2 = snaps[2][1] - snaps[0][1]
    with open(prof.trace_paths[0]) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    n_k1 = sum("dual_x_kernel" in n and "false>" in n for n in names)
    n_items = sum("ax_items_kernel" in n and "XSrc" in n for n in names)
    n_second = sum("sum_items_kernel" in n for n in names)
    assert n_k1 == k1 == 20 * len(obj.lp.slabs)
    assert n_items == k2 == 20
    assert n_second == (k2 if obj._work.multi.shape[0] else 0)


def test_sampler_reads_the_cards_allocator(dev):
    from repro_torch.obs import ListSink, MemorySampler, Telemetry
    obj = _obs_objective(dev)
    sink = ListSink()
    tel = Telemetry(sink=sink)
    sampler = MemorySampler(telemetry=tel, device=dev)
    s = sampler.sample()
    assert s.device_bytes_in_use > 0 and s.peak_hbm_bytes > 0
    Maximizer(SolveConfig(iterations=20, gamma=0.01)).maximize(
        obj, criteria=StoppingCriteria(tol_grad_norm=0.0, check_every=10),
        telemetry=tel, sampler=sampler)
    mem = [r for r in sink.records if r["type"] == "memory"]
    assert len(mem) == 2
    for r in mem:
        assert r["device_bytes_in_use"] > 0 and r["device_peak_bytes"] > 0
    assert sampler.watermarks()["peak_hbm_bytes"] <= \
        torch.cuda.max_memory_allocated(dev)


def test_census_k1_bytes_are_phase4s_formula(dev):
    """chip_smoke.py phase 4's K1 bytes on a small objective on the card:
    a, c, dest, ub at the real edges, the mask and x over every padded
    entry, s a row, λ once."""
    from repro_torch.launch import census
    obj = _obs_objective(dev)
    slabs, m, J = obj.lp.slabs, obj.lp.m, obj.lp.num_destinations
    real = sum(int(s.mask.sum()) for s in slabs)
    padded = sum(s.n * s.width for s in slabs)
    rows = sum(s.n for s in slabs)
    want = (real * (4 * m + 4 + 4 + 4) + padded + rows * 4 + m * J * 4
            + padded * 4)
    got = census.evaluation_census(obj)["kernels"]["dual_x_slab"]["bytes"]
    assert got == want
