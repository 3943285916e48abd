"""The port's blockwise projections against `repro.core.projections`.

Same inputs (numpy, seeded) through both; atol 1e-6 — the bisection steps
are the same arithmetic, only the float32 row sums run in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import projections as rproj
from repro_torch.core import projections as tproj


def _rows(seed, n, w, scale):
    rng = np.random.default_rng(seed)
    v = (rng.normal(0, scale, (n, w))).astype(np.float32)
    deg = rng.integers(0, w + 1, n)
    mask = np.arange(w)[None, :] < deg[:, None]
    ub = rng.uniform(0.2, 1.5, (n, w)).astype(np.float32)
    s = rng.uniform(0.3, 3.0, n).astype(np.float32)
    return v, ub, s, mask


@pytest.mark.parametrize("kind", ["box", "boxcut", "simplex", "simplex_eq"])
@pytest.mark.parametrize("w,scale", [(4, 1.0), (16, 3.0), (64, 0.5),
                                     (256, 2.0)])
def test_project_matches_reference(kind, w, scale):
    v, ub, s, mask = _rows(w, 53, w, scale)
    want = np.asarray(rproj.project(kind, jnp.asarray(v), jnp.asarray(ub),
                                    jnp.asarray(s), jnp.asarray(mask)))
    got = tproj.project(kind, torch.from_numpy(v), torch.from_numpy(ub),
                        torch.from_numpy(s), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (got[~mask] == 0).all()


@pytest.mark.parametrize("iters", [10, 20, 60])
def test_boxcut_iteration_count_matches(iters):
    v, ub, s, mask = _rows(7, 40, 32, 2.0)
    want = np.asarray(rproj.project_boxcut(
        jnp.asarray(v), jnp.asarray(ub), jnp.asarray(s), jnp.asarray(mask),
        iters=iters))
    got = tproj.project_boxcut(torch.from_numpy(v), torch.from_numpy(ub),
                               torch.from_numpy(s), torch.from_numpy(mask),
                               iters=iters).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_unknown_kind_raises():
    v, ub, s, mask = (torch.from_numpy(a) for a in _rows(1, 3, 4, 1.0))
    with pytest.raises(ValueError):
        tproj.project("nope", v, ub, s, mask)
