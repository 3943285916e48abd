"""K1's and K3's kernel-order plain versions and their bisection, on the
CPU: the early-exit bisection against the fixed count, `dual_x_lanes_ref`
and `dual_grad_lanes_ref` against the plain versions and the JAX package's
Pallas kernels (interpret mode), and the lane layout `row_layout`.

The early exit must give the fixed count's τ bit for bit, whatever the
row.  Against `dual_x_ref` (another order of the sums): x at atol 1e-4 in
float32 (γ = 0.01, |u| ~ 10³, where an ulp of u is 6e-5), 5e-2 in
bfloat16, the scalars at rtol 1e-5 / 5e-2.  Against the Pallas kernels
the tolerances of tests/test_torch_kernels.py: γ = 0.1, x at atol 1e-5,
the scalars at rtol 1e-5; bfloat16 5e-2.  The kernels themselves are held
to `dual_x_lanes_ref` bit for bit by tests/test_torch_cuda.py and
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

from repro.kernels import dual_grad as rdg
from repro_torch.kernels import ref
from repro_torch.kernels._build import check_aligned
from repro_torch.kernels.dual_grad import (NARROW_MAX_WIDTH, row_layout,
                                           vector_values)

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
        "kernels" / "csrc" / "dual_x.cu")
# the widths of tests/test_torch_cuda.py
WIDTHS = [4, 8, 16, 32, 64, 128, 256, 1024, 2048, 8192, 32768]


def _rows(rng, n, w, mask_kind, u_kind, s_kind, nan):
    """(v, ub, s) of n rows as the kernels hold them (KNEG and ub 0 past
    the real entries), laid out for `row_layout(w)`."""
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
        u = rng.choice([-2.5, -1.0, 0.0, 0.25, 0.5, 1.0, 3.0], (n, w))
    elif u_kind == "nonpos":
        u = -mag
    elif u_kind == "huge":                   # lo + hi may overflow
        u = rng.choice([-1.0, 1.0], (n, w)) * 10.0 ** rng.uniform(37, 38.5,
                                                                 (n, w))
    else:
        u = rng.choice([-1.0, 1.0], (n, w)) * mag
    u = u.astype(np.float32)
    if nan:
        u[rng.integers(0, n), rng.integers(0, w)] = np.nan
    ub = np.where(rng.random((n, w)) < 0.5, rng.uniform(0.1, 2.0, (n, w)),
                  1e30).astype(np.float32)
    f0 = np.where(mask, np.clip(u, 0, ub), 0).sum(axis=1)
    fin = np.where(np.isfinite(f0), f0, 1.0)
    if s_kind == "below":                    # f0 <= s: no step
        s = fin * rng.uniform(1.0, 2.0, n) + rng.uniform(0, 1, n)
    elif s_kind == "above":
        s = fin * rng.uniform(0.0, 0.99, n)
    else:
        s = rng.uniform(0, 5, n) * np.maximum(fin, 1.0) * rng.uniform(0, 1, n)
    L, V = row_layout(w)
    v = np.full((n, L * V), ref.KNEG, np.float32)
    ubp = np.zeros((n, L * V), np.float32)
    v[:, :w] = np.where(mask, u, ref.KNEG)
    ubp[:, :w] = np.where(mask, ub, 0)
    return (torch.from_numpy(v), torch.from_numpy(ubp),
            torch.from_numpy(s.astype(np.float32)), (L, V))


@settings(max_examples=150, deadline=None)
@given(w=st.integers(1, 64), seed=st.integers(0, 2 ** 32 - 1),
       mask_kind=st.sampled_from(["empty", "full", "prefix", "holes"]),
       u_kind=st.sampled_from(["mixed", "nonpos", "ties", "huge"]),
       s_kind=st.sampled_from(["below", "above", "mixed"]),
       nan=st.booleans(), iters=st.sampled_from([5, 20, 40]))
def test_early_exit_equals_fixed_count(w, seed, mask_kind, u_kind, s_kind,
                                       nan, iters):
    """The bisection that stops once its bracket is fixed gives the τ of
    all `iters` steps bit for bit, and runs no step where f0 <= s.  A NaN
    entry is dropped (it adds 0 to f0, as padding does), as the kernels'
    fmaxf and fminf drop it."""
    rng = np.random.default_rng(seed)
    v, ub, s, layout = _rows(rng, 48, w, mask_kind, u_kind, s_kind, nan)
    tau_e, steps_e = ref.bisect_lanes_ref(v, ub, s, iters, layout)
    tau_f, steps_f = ref.bisect_lanes_ref(v, ub, s, iters, layout,
                                          early_exit=False)
    assert torch.equal(tau_e.view(torch.int32), tau_f.view(torch.int32))
    assert (steps_f == iters).all() and (steps_e <= iters).all()
    f0 = torch.fmin(torch.fmax(v, torch.zeros_like(v)), ub).sum(1)
    assert (steps_e[~(f0 > s)] == 0).all()


def test_nan_entries_are_dropped():
    """A row's NaN entries of u change neither its τ nor its other x: the
    row gives what it gives with those entries made padding."""
    rng = np.random.default_rng(3)
    v, ub, s, layout = _rows(rng, 64, 32, "full", "mixed", "mixed", False)
    holes = torch.from_numpy(rng.random(v.shape) < 0.2)
    tau_nan, _ = ref.bisect_lanes_ref(torch.where(holes, np.nan, v), ub, s,
                                      40, layout)
    tau_pad, _ = ref.bisect_lanes_ref(torch.where(holes, ref.KNEG, v),
                                      torch.where(holes, 0.0, ub), s, 40,
                                      layout)
    assert torch.equal(tau_nan, tau_pad) and not tau_nan.isnan().any()


def test_early_exit_saves_steps():
    """At γ = 0.01 (|u| up to ~10³) the bracket is fixed after ~25 of the
    40 steps."""
    rng = np.random.default_rng(7)
    v, ub, s, layout = _rows(rng, 2000, 32, "prefix", "mixed", "above", False)
    v = torch.where(v > ref.KNEG, v / 10, v)
    _, steps = ref.bisect_lanes_ref(v, ub, s, 40, layout)
    ran = steps[steps > 0].float()
    assert 15 < float(ran.mean()) < 36 and int(steps.max()) <= 40


def _slab(seed, n, w, m, J, lam_hi):
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
    ), rng.uniform(0, lam_hi, (m, J)).astype(f)


def _torch_args(slab, lam, dtype):
    fl = ("a_vals", "c_vals", "ub", "s")
    t = [torch.from_numpy(v).to(dtype) if k in fl else torch.from_numpy(v)
         for k, v in slab.items()]
    return t + [torch.from_numpy(lam)]


@pytest.mark.parametrize("w,m,n", [(1, 1, 70), (4, 1, 37), (8, 2, 300),
                                   (16, 1, 129), (32, 2, 257), (64, 3, 90),
                                   (256, 1, 40), (1024, 2, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lanes_ref_matches_plain(w, m, n, dtype):
    slab, lam = _slab(w * 3 + m, n, w, m, 31, 0.5)
    args = _torch_args(slab, lam, dtype)
    gamma = torch.tensor(0.01).to(dtype)
    x, g, cx, xsq = ref.dual_grad_lanes_ref(*args, gamma, 40, row_layout(w))
    x1, cx1, xsq1 = ref.dual_x_lanes_ref(*args, gamma, 40, row_layout(w))
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


@pytest.mark.parametrize("w,m,n", [(4, 1, 37), (32, 2, 65), (256, 2, 19)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lanes_ref_matches_pallas(w, m, n, dtype):
    slab, lam = _slab(w + 11 * m, n, w, m, 23, 0.5)
    dt, dj = ((torch.float32, jnp.float32) if dtype == "float32"
              else (torch.bfloat16, jnp.bfloat16))
    args = _torch_args(slab, lam, dt)
    x, g, cx, xsq = ref.dual_grad_lanes_ref(*args, torch.tensor(0.1).to(dt),
                                            40, row_layout(w))
    fl = ("a_vals", "c_vals", "ub", "s")
    aj = [jnp.asarray(v, dj) if k in fl else jnp.asarray(v)
          for k, v in slab.items()]
    xp, cxp, xsqp = rdg.dual_x_slab(*aj, jnp.asarray(lam), jnp.float32(0.1),
                                    interpret=True)
    xg, gp, cxg, xsqg = rdg.dual_grad_slab(*aj, jnp.asarray(lam),
                                           jnp.float32(0.1), interpret=True)
    tol = 1e-5 if dtype == "float32" else 5e-2
    for xr, cxr, xsqr in ((xp, cxp, xsqp), (xg, cxg, xsqg)):
        np.testing.assert_allclose(x.float().numpy(),
                                   np.asarray(xr, np.float32), atol=tol)
        np.testing.assert_allclose(float(cx), float(cxr), rtol=tol)
        np.testing.assert_allclose(float(xsq), float(xsqr), rtol=tol)
    np.testing.assert_allclose(g.float().numpy(), np.asarray(gp, np.float32),
                               atol=tol)


def test_lanes_ref_refuses_wide_rows():
    slab, lam = _slab(1, 3, 2048, 1, 7, 0.5)
    with pytest.raises(ValueError):
        ref.dual_x_lanes_ref(*_torch_args(slab, lam, torch.float32),
                             torch.tensor(0.1), 40, row_layout(2048))


@pytest.mark.parametrize("w", WIDTHS)
def test_row_layout(w):
    """L·VPT is the next power of two of w, at most 32 lanes, VPT = min(w,
    8) up to 256; no layout past 1,024 (one block a row)."""
    lay = row_layout(w)
    if w > NARROW_MAX_WIDTH:
        assert lay is None
        return
    L, V = lay
    p = 1 << (w - 1).bit_length()
    assert L * V == p and L <= 32 and V >= 1
    assert V == (min(w, 8) if w <= 256 else w // 32)


def _built_layouts(macro):
    text = CSRC.read_text().split(f"#define {macro}(X)")[1].split("\n\n")[0]
    text = text.split("#define")[0]
    return {(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)",
                                                     text)}


def test_every_layout_has_a_kernel():
    """Each (L, VPT) that row_layout gives is a kernel instance of
    dual_x.cu for both types; those of the swept caps of 4 and 16 values a
    lane, for rows up to 64 wide (the main path's), for float32."""
    both = _built_layouts("REPRO_LAYOUTS")
    f32 = both | _built_layouts("REPRO_SWEEP_LAYOUTS")
    assert {row_layout(w) for w in range(1, NARROW_MAX_WIDTH + 1)} <= both
    assert {row_layout(w, cap) for w in range(1, 65)
            for cap in (4, 8, 16)} <= f32


def test_misaligned_pointer_is_refused():
    """The wrapper's alignment check: a slice one float off a 16-byte
    boundary is refused where the vector loads would touch it."""
    buf = torch.zeros(4 * 32 + 1)
    good, bad = buf[:128].view(4, 32), buf[1:129].view(4, 32)
    vals = vector_values(row_layout(32))
    check_aligned("dual_x_slab", {"out": good}, 32, 1, vals)
    with pytest.raises(ValueError, match="aligned"):
        check_aligned("dual_x_slab", {"out": bad}, 32, 1, vals)
    # a width that is not a multiple of VPT takes no vector loads
    check_aligned("dual_x_slab", {"out": buf[1:25].view(4, 6)}, 6, 1,
                  vector_values(row_layout(6)))
