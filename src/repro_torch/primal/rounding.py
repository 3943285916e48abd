"""Capacity-respecting repair of extracted decisions; port of the part of
`repro.primal.rounding` the certificate uses.

Host numpy on purpose: the repaired point is the independent witness the
duality-gap certificate rides on (primal.certify), so it shares no code
with the solver's Ax path.  The LP passed here has numpy leaves.

  primal_ax      (m, J) A·x̂ of a candidate point, float64
  scale_repair   shrink every edge by (1−eps)·min over its families of
                 b/(Ax) at its destination: feasible by construction
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def primal_ax(lp, xs: Sequence[np.ndarray]) -> np.ndarray:
    """(m, J) A·x of a candidate per-slab primal point, host numpy; padded
    positions are masked out."""
    m, J = lp.b.shape
    ax = np.zeros((m, J))
    for slab, x in zip(lp.slabs, xs):
        xv = np.where(np.asarray(slab.mask), np.asarray(x, np.float64), 0.0)
        flat_dest = np.asarray(slab.dest_idx).reshape(-1)
        av = np.asarray(slab.a_vals, np.float64)
        for k in range(m):
            ax[k] += np.bincount(flat_dest,
                                 weights=(av[..., k] * xv).reshape(-1),
                                 minlength=J)
    return ax


def scale_repair(xs: Sequence[np.ndarray], lp,
                 eps: float = 1e-6) -> List[np.ndarray]:
    """Fractional capacity repair: each edge scaled by (1−eps)·min_k
    b_kj/(Ax)_kj at its destination (clipped at 1), a monotone shrink that
    keeps box bounds and budgets and makes every capacity row feasible."""
    ax = primal_ax(lp, xs)
    b = np.asarray(lp.b, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        f = np.where(ax > b, (1.0 - eps) * b / np.maximum(ax, 1e-300), 1.0)
    f = np.minimum(f, 1.0)
    f_dest = f.min(axis=0)
    out = []
    for slab, x in zip(lp.slabs, xs):
        x = np.asarray(x)
        fac = f_dest[np.asarray(slab.dest_idx)]
        out.append(np.where(np.asarray(slab.mask),
                            x * fac, 0.0).astype(x.dtype))
    return out
