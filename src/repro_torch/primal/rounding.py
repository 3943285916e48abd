"""Integral rounding and capacity-respecting repair of extracted decisions;
port of `repro.primal.rounding`.

Host numpy on purpose: the repaired point is the independent witness the
duality-gap certificate rides on (primal.certify), so it shares no code
with the solver's Ax path.  The LP passed here has numpy leaves.

  primal_ax        (m, J) A·x̂ of a candidate point, float64
  threshold_round  x̂ = ub where x >= frac·ub, else 0
  topk_round       each source's k largest-x edges at ub, the rest 0
  scale_repair     shrink every edge by (1−eps)·min over its families of
                   b/(Ax) at its destination: feasible by construction
  greedy_repair    keep candidate edges at ub in decreasing fractional-x
                   order while the source budget, every destination's
                   headroom and every coupling row allow: integral and
                   feasible

Rounding targets blocks with finite per-edge upper bounds; entries with
non-finite ub pass through unrounded.  Equality blocks (simplex_eq) are
out of its scope: dropping an edge breaks Σx = s.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

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


def threshold_round(xs: Sequence[np.ndarray], lp,
                    frac: float = 0.5) -> List[np.ndarray]:
    """Per-edge threshold rounding: x̂ = ub where x >= frac·ub, else 0."""
    out = []
    for slab, x in zip(lp.slabs, xs):
        x = np.asarray(x)
        ub = np.asarray(slab.ub)
        mask = np.asarray(slab.mask)
        roundable = mask & np.isfinite(ub) & (ub > 0)
        xhat = np.where(roundable & (x >= frac * ub), ub, 0.0)
        out.append(np.where(roundable, xhat,
                            np.where(mask, x, 0.0)).astype(x.dtype))
    return out


def topk_round(xs: Sequence[np.ndarray], lp, k: int = 1) -> List[np.ndarray]:
    """Keep each source's k largest-x edges at ub, zero the rest.  Only
    edges with x > 0 are eligible; non-finite-ub entries pass through
    unrounded, as in `threshold_round`."""
    out = []
    for slab, x in zip(lp.slabs, xs):
        x = np.asarray(x)
        ub = np.asarray(slab.ub)
        mask = np.asarray(slab.mask)
        roundable = mask & np.isfinite(ub) & (ub > 0)
        score = np.where(roundable & (x > 0), x, -np.inf)
        keep = np.zeros_like(score, dtype=bool)
        kk = min(k, score.shape[1])
        top = np.argpartition(-score, kk - 1, axis=1)[:, :kk]
        np.put_along_axis(keep, top, True, axis=1)
        keep &= np.isfinite(score)
        xhat = np.where(keep, ub, 0.0)
        out.append(np.where(roundable, xhat,
                            np.where(mask, x, 0.0)).astype(x.dtype))
    return out


def greedy_repair(xs_round: Sequence[np.ndarray], lp,
                  xs_frac: Optional[Sequence[np.ndarray]] = None,
                  global_rows: Sequence[tuple] = (),
                  eps: float = 1e-9) -> List[np.ndarray]:
    """Capacity-respecting repair of an integral candidate.

    Visits the candidate's edges in decreasing `xs_frac` order (default:
    the candidate itself) and keeps an edge at its full ub only when the
    source budget, every family's destination headroom and every coupling
    row's headroom can take it; otherwise drops it.  `global_rows` is a
    list of (per-slab weights or None for all ones, limit) in original
    units, as `primal.certify.global_row_caps(obj)` builds it.  The
    result is integral and feasible.
    """
    scores = xs_round if xs_frac is None else xs_frac
    cap_left = np.asarray(lp.b, np.float64).copy()
    g_left = np.asarray([lim for _, lim in global_rows], np.float64)
    out = [np.zeros_like(np.asarray(x), dtype=np.float64)
           for x in xs_round]
    cand = []       # (score, slab, row, col) of every candidate edge
    for si, (slab, xh, sc) in enumerate(zip(lp.slabs, xs_round, scores)):
        xh = np.asarray(xh)
        pos = np.nonzero(np.asarray(slab.mask) & (xh > 0))
        if len(pos[0]):
            cand.append((np.asarray(sc)[pos], np.full(len(pos[0]), si),
                         pos[0], pos[1]))
    if not cand:
        return [o.astype(np.float32) for o in out]
    score = np.concatenate([c[0] for c in cand])
    order = np.argsort(-score, kind="stable")
    sis = np.concatenate([c[1] for c in cand])[order]
    rrs = np.concatenate([c[2] for c in cand])[order]
    qqs = np.concatenate([c[3] for c in cand])[order]
    src_left = [np.asarray(s.s, np.float64).copy() for s in lp.slabs]
    for si, r, q in zip(sis, rrs, qqs):
        slab = lp.slabs[si]
        amount = float(np.asarray(slab.ub)[r, q])
        if not np.isfinite(amount) or amount <= 0:
            continue
        if src_left[si][r] < amount - eps:
            continue
        j = int(np.asarray(slab.dest_idx)[r, q])
        a = np.asarray(slab.a_vals, np.float64)[r, q]       # (m,)
        if np.any(a * amount > cap_left[:, j] + eps):
            continue
        contrib = np.asarray(
            [amount if w is None else float(w[si][r, q]) * amount
             for w, _ in global_rows], np.float64)
        if np.any(contrib > g_left + eps):
            continue
        out[si][r, q] = amount
        src_left[si][r] -= amount
        cap_left[:, j] -= a * amount
        g_left -= contrib
    return [o.astype(np.float32) for o in out]
