"""K5's kernel-order plain versions and the wide rows' block bisection, on
the CPU: `ref.proj_lanes_ref` (rows up to 1,024 wide, K5's lane layout)
and `ref.proj_block_ref` / `dual_x_block_ref` / `dual_grad_block_ref`
(wider rows, a block a row) against the fixed count, the JAX package's
Pallas kernels (interpret mode), its oracles and its exact sort-based
projection; and K5's instances in `proj.cu`.

The early exit must give the fixed count's τ bit for bit, whatever the
row.  Against the Pallas kernel and `boxcut_bisect_ref` (another order of
the sums) the tolerances of tests/test_kernels.py: float32 x at atol
1e-6 (|v| ~ 3, so x resolves to an ulp of τ), bfloat16 at 5e-2 (one
bf16 rounding of x).
Against `project_boxcut_exact_1d` (float64, exact) atol 1e-5: 40 steps
of bisection bracket τ to its float32 ulp.  The kernels themselves are
held to these plain versions bit for bit by tests/test_torch_cuda.py and
chip_smoke.py.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.projections import project_boxcut_exact_1d
from repro.kernels import dual_grad as rdg
from repro.kernels import ref as rref
from repro.kernels.proj import proj_boxcut as pallas_proj
from repro_torch.kernels import ref
from repro_torch.kernels import dual_grad as dg
from repro_torch.kernels._build import check_aligned
from repro_torch.kernels.dual_grad import (NARROW_MAX_WIDTH, kernel_layout,
                                           row_layout, vector_values)

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
        "kernels" / "csrc" / "proj.cu")
KINDS = dict(mask_kind=st.sampled_from(["empty", "full", "prefix", "holes"]),
             u_kind=st.sampled_from(["mixed", "nonpos", "ties", "huge"]),
             s_kind=st.sampled_from(["below", "above", "mixed"]),
             nan=st.booleans(), iters=st.sampled_from([5, 20, 40]))


def _rows(rng, n, w, mask_kind, u_kind, s_kind, nan):
    """(v, ub, s, mask) of n rows of width w: ties, |v| up to 10^38.5 (lo
    + hi may overflow), NaN entries, all-masked rows, rows whose f0 <= s
    (no step) and rows that need the loop."""
    if mask_kind == "empty":
        mask = np.zeros((n, w), bool)
    elif mask_kind == "full":
        mask = np.ones((n, w), bool)
    elif mask_kind == "prefix":
        mask = np.arange(w)[None, :] < rng.integers(0, w + 1, n)[:, None]
    else:                                    # holes anywhere
        mask = rng.random((n, w)) < rng.uniform(0.2, 0.9)
    mag = 10.0 ** rng.uniform(-3, 4, (n, w))
    if u_kind == "ties":
        v = rng.choice([-2.5, -1.0, 0.0, 0.25, 0.5, 1.0, 3.0], (n, w))
    elif u_kind == "nonpos":
        v = -mag
    elif u_kind == "huge":
        v = rng.choice([-1.0, 1.0], (n, w)) * 10.0 ** rng.uniform(
            37, 38.5, (n, w))
    else:
        v = rng.choice([-1.0, 1.0], (n, w)) * mag
    v = v.astype(np.float32)
    if nan:
        v[rng.integers(0, n), rng.integers(0, w)] = np.nan
    ub = np.where(rng.random((n, w)) < 0.5, rng.uniform(0.1, 2.0, (n, w)),
                  1e30).astype(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        f0 = np.where(mask, np.clip(v, 0, ub), 0).sum(axis=1)
    fin = np.where(np.isfinite(f0), f0, 1.0)
    if s_kind == "below":                    # f0 <= s: no step
        s = fin * rng.uniform(1.0, 2.0, n) + rng.uniform(0, 1, n)
    elif s_kind == "above":
        s = fin * rng.uniform(0.0, 0.99, n)
    else:
        s = rng.uniform(0, 5, n) * np.maximum(fin, 1.0) * rng.uniform(0, 1, n)
    return tuple(torch.from_numpy(a) for a in
                 (v, ub, s.astype(np.float32), mask))


def _f0(vp, ubp):
    return torch.fmin(torch.fmax(vp, torch.zeros_like(vp)), ubp).sum(1)


@settings(max_examples=120, deadline=None)
@given(w=st.integers(1, NARROW_MAX_WIDTH), seed=st.integers(0, 2 ** 32 - 1),
       **KINDS)
def test_lanes_early_exit_equals_fixed_count(w, seed, mask_kind, u_kind,
                                             s_kind, nan, iters):
    """K5's bisection at its lane layout: the early exit gives the fixed
    count's τ bit for bit, and runs no step where f0 <= s; x too."""
    rng = np.random.default_rng(seed)
    v, ub, s, mask = _rows(rng, 24, w, mask_kind, u_kind, s_kind, nan)
    lay = row_layout(w)
    vp, ubp = ref.pad_rows(v, ub, mask, lay[0] * lay[1])
    tau_e, steps_e = ref.bisect_lanes_ref(vp, ubp, s, iters, lay)
    tau_f, steps_f = ref.bisect_lanes_ref(vp, ubp, s, iters, lay,
                                          early_exit=False)
    assert torch.equal(tau_e.view(torch.int32), tau_f.view(torch.int32))
    assert (steps_f == iters).all() and (steps_e <= iters).all()
    assert (steps_e[~(_f0(vp, ubp) > s)] == 0).all()
    x_e = ref.proj_lanes_ref(v, ub, s, mask, iters, lay)
    x_f = ref.proj_lanes_ref(v, ub, s, mask, iters, lay, early_exit=False)
    assert torch.equal(x_e.view(torch.int32), x_f.view(torch.int32))
    assert not x_e.isnan().any() and (x_e[~mask] == 0).all()


@settings(max_examples=25, deadline=None)
@given(w=st.sampled_from([1025, 1500, 2048, 3000, 8192]),
       seed=st.integers(0, 2 ** 32 - 1), **KINDS)
def test_block_early_exit_equals_fixed_count(w, seed, mask_kind, u_kind,
                                             s_kind, nan, iters):
    """The wide rows' block bisection: the early exit gives the fixed
    count's τ bit for bit, and runs no step where f0 <= s; x too."""
    rng = np.random.default_rng(seed)
    v, ub, s, mask = _rows(rng, 6, w, mask_kind, u_kind, s_kind, nan)
    L, C = ref.block_layout(w)
    vp, ubp = ref.pad_rows(v, ub, mask, L * C)
    tau_e, steps_e = ref.bisect_block_ref(vp, ubp, s, iters)
    tau_f, steps_f = ref.bisect_block_ref(vp, ubp, s, iters,
                                          early_exit=False)
    assert torch.equal(tau_e.view(torch.int32), tau_f.view(torch.int32))
    assert (steps_f == iters).all() and (steps_e <= iters).all()
    assert (steps_e[~(_f0(vp, ubp) > s)] == 0).all()
    x_e = ref.proj_block_ref(v, ub, s, mask, iters)
    x_f = ref.proj_block_ref(v, ub, s, mask, iters, early_exit=False)
    assert torch.equal(x_e.view(torch.int32), x_f.view(torch.int32))
    assert not x_e.isnan().any() and (x_e[~mask] == 0).all()


@pytest.mark.parametrize("w", [2048, 8192])
def test_block_early_exit_saves_steps(w):
    """At |v| up to ~10³ a wide row's bracket is fixed after ~25 of the 40
    steps."""
    rng = np.random.default_rng(w)
    v, ub, s, mask = _rows(rng, 40, w, "prefix", "mixed", "above", False)
    v = v / 10
    L, C = ref.block_layout(w)
    vp, ubp = ref.pad_rows(v, ub, mask, L * C)
    _, steps = ref.bisect_block_ref(vp, ubp, s, 40)
    ran = steps[steps > 0].float()
    assert 15 < float(ran.mean()) < 36 and int(steps.max()) <= 40


def _order_ref(v, ub, s, mask, iters=40):
    w = v.shape[1]
    if w > NARROW_MAX_WIDTH:
        return ref.proj_block_ref(v, ub, s, mask, iters)
    return ref.proj_lanes_ref(v, ub, s, mask, iters, row_layout(w))


@pytest.mark.parametrize("w,n", [(4, 37), (64, 25), (100, 19), (1024, 9),
                                 (2048, 5), (8192, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_order_refs_match_pallas(w, n, dtype):
    """K5's kernel-order plain versions against the JAX package's Pallas
    kernel (interpret mode) and its oracle, on tests/test_kernels.py's
    draw.  bfloat16 inputs are held against the reference run in float32
    on the same bf16-rounded values: the port projects bf16 input in
    float32 (as K1 does), while the reference bisects in bf16 arithmetic,
    whose τ resolves only to a bf16 ulp of τ (0.0625 at |τ| ~ 10 here)."""
    rng = np.random.default_rng(w * 7 + n)
    v = rng.normal(0, 3, (n, w)).astype(np.float32)
    ub = rng.uniform(0.1, 2, (n, w)).astype(np.float32)
    s = rng.uniform(0.5, 3, (n,)).astype(np.float32)
    mask = rng.random((n, w)) < 0.8
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    vt, ubt, st_ = (torch.from_numpy(a).to(dt) for a in (v, ub, s))
    x = _order_ref(vt, ubt, st_, torch.from_numpy(mask))
    assert x.dtype == dt
    args = tuple(jnp.asarray(t.float().numpy()) for t in (vt, ubt, st_)) + (
        jnp.asarray(mask),)
    tol = 1e-6 if dtype == "float32" else 5e-2
    for want in (pallas_proj(*args, interpret=True),
                 rref.boxcut_bisect_ref(*args)):
        np.testing.assert_allclose(x.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol)


@pytest.mark.parametrize("w", [8, 100, 1024, 2048, 8192])
def test_order_refs_match_exact_projection(w):
    """An independent check that the early exit stops at the right τ: the
    exact sort-based projection of a few rows, in float64."""
    rng = np.random.default_rng(w + 1)
    n = 4
    v = rng.normal(0, 3, (n, w)).astype(np.float32)
    ub = rng.uniform(0.1, 2, (n, w)).astype(np.float32)
    mask = rng.random((n, w)) < 0.8
    f0 = np.where(mask, np.clip(v, 0, ub), 0).sum(axis=1)
    s = (f0 * np.array([0.2, 0.5, 0.9, 1.5])).astype(np.float32)
    x = _order_ref(*(torch.from_numpy(a) for a in (v, ub, s)),
                   torch.from_numpy(mask)).numpy()
    for r in range(n):
        want = project_boxcut_exact_1d(v[r][mask[r]], ub[r][mask[r]],
                                       float(s[r]))
        np.testing.assert_allclose(x[r][mask[r]], want, atol=1e-5)
        assert (x[r][~mask[r]] == 0).all()


def _slab(seed, n, w, m, J):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, w + 1, size=n)
    mask = np.arange(w)[None, :] < deg[:, None]
    mask &= rng.random((n, w)) < 0.8          # holes: a non-prefix mask
    mask[0] = False                           # an all-padding row
    f = np.float32
    return dict(
        a_vals=np.where(mask[..., None], rng.lognormal(0, 0.5, (n, w, m)),
                        0).astype(f),
        c_vals=np.where(mask, -rng.lognormal(0, 0.5, (n, w)), 0).astype(f),
        dest_idx=np.where(mask, rng.integers(0, J, (n, w)), 0).astype(
            np.int32),
        mask=mask,
        ub=np.where(mask, rng.uniform(0.5, 1.0, (n, w)), 0).astype(f),
        s=rng.uniform(0.5, 2.0, n).astype(f),
    ), rng.uniform(0, 0.5, (m, J)).astype(f)


def _torch_args(slab, lam, dtype=torch.float32):
    fl = ("a_vals", "c_vals", "ub", "s")
    t = [torch.from_numpy(v).to(dtype) if k in fl else torch.from_numpy(v)
         for k, v in slab.items()]
    return t + [torch.from_numpy(lam)]


def _u(a_vals, c_vals, dest_idx, lam, gamma):
    """u = −(Σ_k a_k λ_k[dest] + c)/γ in K1's order, float32."""
    atl = torch.zeros(c_vals.shape)
    for k in range(a_vals.shape[2]):
        atl = atl + a_vals[:, :, k] * lam[k][dest_idx.long()]
    return -(atl + c_vals) / gamma


@pytest.mark.parametrize("w,m,n", [(1, 1, 33), (8, 1, 65), (32, 2, 40),
                                   (100, 1, 21), (1024, 1, 5), (1500, 2, 4),
                                   (2048, 1, 5), (8192, 1, 3)])
def test_proj_of_u_gives_dual_x(w, m, n):
    """Fed a slab's u, K5's kernel-order plain version gives K1's x bit for
    bit: the same layout, sums and stopping rule (γ = 0.01, |u| ~ 10²)."""
    slab, lam = _slab(w + m, n, w, m, 29)
    a, c, dest, mask, ub, s, lam_t = _torch_args(slab, lam)
    gamma = torch.tensor(0.01)
    u = _u(a, c, dest, lam_t, gamma)
    if w > NARROW_MAX_WIDTH:
        x1, _, _ = ref.dual_x_block_ref(a, c, dest, mask, ub, s, lam_t,
                                        gamma, 40)
    else:
        x1, _, _ = ref.dual_x_lanes_ref(a, c, dest, mask, ub, s, lam_t,
                                        gamma, 40, row_layout(w))
    x5 = _order_ref(u, ub, s, mask)
    assert torch.equal(x5.view(torch.int32), x1.view(torch.int32))


@pytest.mark.parametrize("w,m,n", [(1025, 1, 7), (2048, 2, 5), (3000, 1, 3),
                                   (8192, 3, 3), (16384, 1, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_refs_match_plain(w, m, n, dtype):
    """K1's and K3's wide-path plain versions against `dual_x_ref` /
    `dual_grad_ref` (another order of the sums): x at atol 1e-4 in
    float32 (γ = 0.01, |u| ~ 10², an ulp of u 8e-6), 5e-2 in bfloat16;
    the scalars at rtol 1e-5 / 5e-2; K3's x and scalars are K1's."""
    slab, lam = _slab(w * 3 + m, n, w, m, 31)
    args = _torch_args(slab, lam, dtype)
    gamma = torch.tensor(0.01).to(dtype)
    x, g, cx, xsq = ref.dual_grad_block_ref(*args, gamma, 40)
    x1, cx1, xsq1 = ref.dual_x_block_ref(*args, gamma, 40)
    assert torch.equal(x, x1) and torch.equal(cx, cx1)
    assert torch.equal(xsq, xsq1)
    xr, gr, cxr, xsqr = ref.dual_grad_ref(*args, gamma, 40)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(x.float().numpy(), xr.float().numpy(),
                               atol=tol)
    np.testing.assert_allclose(g.float().numpy(), gr.float().numpy(),
                               atol=tol)
    rtol = 1e-5 if dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(float(cx), float(cxr), rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(float(xsq), float(xsqr), rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("w,m,n", [(2048, 1, 5), (2048, 2, 3)])
def test_block_refs_match_pallas(w, m, n):
    """K1's and K3's wide-path plain versions against the JAX package's
    Pallas kernels in interpret mode (γ = 0.1, x at atol 1e-5, the
    scalars at rtol 1e-5, as tests/test_torch_kernels.py)."""
    slab, lam = _slab(w + 11 * m, n, w, m, 23)
    args = _torch_args(slab, lam)
    x, g, cx, xsq = ref.dual_grad_block_ref(*args, torch.tensor(0.1), 40)
    aj = [jnp.asarray(v) for v in slab.values()]
    xp, cxp, xsqp = rdg.dual_x_slab(*aj, jnp.asarray(lam), jnp.float32(0.1),
                                    interpret=True)
    xg, gp, cxg, xsqg = rdg.dual_grad_slab(*aj, jnp.asarray(lam),
                                           jnp.float32(0.1), interpret=True)
    for xr, cxr, xsqr in ((xp, cxp, xsqp), (xg, cxg, xsqg)):
        np.testing.assert_allclose(x.numpy(), np.asarray(xr), atol=1e-5)
        np.testing.assert_allclose(float(cx), float(cxr), rtol=1e-5)
        np.testing.assert_allclose(float(xsq), float(xsqr), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(gp), atol=1e-5)


@pytest.mark.parametrize("w,chunk", [(1025, 8), (2048, 8), (2049, 16),
                                     (4096, 16), (8192, 32), (16384, 64),
                                     (32768, 128)])
def test_block_layout(w, chunk):
    """A wide row: 256 threads of C contiguous columns, 256·C the next
    power of two of w; no block layout at 1,024 or below."""
    assert ref.block_layout(w) == (256, chunk)
    with pytest.raises(ValueError):
        ref.block_layout(NARROW_MAX_WIDTH)


def test_order_refs_refuse_the_other_path():
    v, ub, s, mask = (torch.zeros(2, 2048), torch.ones(2, 2048),
                      torch.ones(2), torch.ones(2, 2048, dtype=torch.bool))
    with pytest.raises(ValueError):
        ref.proj_lanes_ref(v, ub, s, mask, 40, row_layout(2048))
    with pytest.raises(ValueError):
        ref.proj_block_ref(v[:, :64], ub[:, :64], s, mask[:, :64], 40)


def test_every_layout_has_a_proj_kernel():
    """Each (L, VPT) that row_layout gives is a kernel instance of
    proj.cu (for both types)."""
    text = CSRC.read_text().split("#define REPRO_PROJ_LAYOUTS(X)")[1]
    text = text.split("\n\n")[0]
    built = {(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)",
                                                     text)}
    assert {row_layout(w) for w in range(1, NARROW_MAX_WIDTH + 1)} <= built


def test_wide_misaligned_pointer_is_refused():
    """Wide rows move 8 values a vector: a slice one float off a 16-byte
    boundary is refused; a width that is not a multiple of 8 takes no
    vector loads."""
    buf = torch.zeros(2 * 2048 + 1)
    vals = vector_values(kernel_layout(2048))
    assert vals == 8
    check_aligned("proj_boxcut", {"v": buf[:4096].view(2, 2048)}, 2048, 1,
                  vals)
    with pytest.raises(ValueError, match="aligned"):
        check_aligned("proj_boxcut", {"v": buf[1:4097].view(2, 2048)},
                      2048, 1, vals)
    check_aligned("proj_boxcut", {"v": buf[1:3003].view(2, 1501)}, 1501, 1,
                  vector_values(kernel_layout(1501)))


COMMON = CSRC.with_name("common.cuh")


def test_every_register_chunk_has_a_wide_kernel():
    """The chunks that `wide_store` keeps in registers are the ones
    common.cuh instantiates every wide kernel for, and their
    `block_layout` widths (1,025 to 256·C) are the ones held there."""
    text = COMMON.read_text().split("#define REPRO_WIDE_REG_CHUNKS(X)")[1]
    built = {int(c) for c in re.findall(r"X\((\d+)\)", text.split("\n")[0])}
    assert built == set(dg.WIDE_REG_CHUNKS)
    held = {ref.block_layout(w)[1] for w in range(NARROW_MAX_WIDTH + 1, 65537)
            if dg.wide_store(ref.block_layout(w)[1]) == dg.STORE_REGS}
    assert held == built


@pytest.mark.parametrize("w,layout,store", [
    (1, (1, 1), "REGS"), (64, (8, 8), "REGS"), (1024, (32, 32), "REGS"),
    (1025, (256, 8), "REGS"), (2048, (256, 8), "REGS"),
    (4096, (256, 16), "REGS"), (8192, (256, 32), "REGS"),
    (8193, (256, 64), "SHARED"), (16384, (256, 64), "SHARED"),
    (16385, (256, 128), "GLOBAL"), (32768, (256, 128), "GLOBAL")])
def test_kernel_layout_and_store(w, layout, store):
    """The layout and the storage that the wrappers pass to the kernels:
    a group of lanes up to 1,024 wide, then a block whose chunks live in
    registers, shared memory (v and ub in 227 KB) or global scratch."""
    assert dg.kernel_layout(w) == layout
    assert dg.layout_store(layout) == getattr(dg, f"STORE_{store}")
