"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch and the port only (no JAX), so it also runs where JAX is not
installed:  PYTHONPATH=src python -m pytest tests/test_torch_cuda.py
Every test is marked `cuda` and skips where no NVIDIA GPU is present.

Tolerances: float32 x at atol 1e-4 and the scalars at rtol 1e-5 (only the
order of float32 sums differs between kernel and plain version); bfloat16
at 5e-2 (one bf16 rounding of x, of order 2⁻⁸ relative).
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import lp_to_torch
from repro_torch.core import (InstanceSpec, MatchingObjective, Maximizer,
                              SolveConfig, StoppingCriteria, generate,
                              precondition)
from repro_torch.kernels import ref
from repro_torch.kernels.ax_reduce import ax_reduce_bucket_x
from repro_torch.kernels.dual_grad import dual_x_slab

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


@pytest.mark.parametrize("w", [4, 8, 16, 32, 64, 128, 256, 1024])
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dual_x_kernel_matches_plain(dev, w, m, dtype):
    rng = np.random.default_rng(w * 10 + m)
    n, J = 1237, 97
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
        k1, k2 = dual_x_slab.launches, ax_reduce_bucket_x.launches
        res = Maximizer(cfg).maximize(obj, criteria=crit)
        out[str(d)] = (res, dual_x_slab.launches - k1,
                       ax_reduce_bucket_x.launches - k2)
    cpu, gpu = out["cpu"], out["cuda"]
    assert cpu[1] == 0 and cpu[2] == 0
    assert gpu[1] > 0 and gpu[2] > 0
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
