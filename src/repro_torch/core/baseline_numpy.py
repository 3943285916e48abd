"""Prior-CPU-solver stand-in: an independent, pure-numpy DuaLip
implementation; the port's own copy of `repro.core.baseline_numpy`, with
the same arithmetic, reading the port's `core/types.py`.  An LP with
torch tensor leaves (on any device) is copied to the host first.

Role in the reproduction (paper §7):
  * the *parity* target — the paper validates PyTorch-DuaLip against
    Scala-DuaLip (Fig. 1/2, <1% relative dual error in 100 iters).  The Scala
    solver is not available here, so this module is the independent reference
    implementation: same algorithm (AGD with adaptive Lipschitz), same
    math, but written against a CSC-style edge layout with numpy semantics —
    no JAX, no slabs, no bisection (exact sort-based projection).
  * the *speed* baseline — the Table-2 analogue measures our jitted/bucketed
    solver against this CPU-idiomatic implementation on identical instances
    (matched stopping criterion), standing in for the Spark/Scala runtime.
  The AGD here is the reference's, so it holds the port's solver as it
  holds the JAX one (<1 % relative dual after warm-up).

Layout: CSC by source (the paper's §6 choice): edges sorted by source with
`indptr` per source — the tuple-sequence / pointer-chasing style the paper
describes replacing.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from .types import LPData, SolveConfig


def _np(x) -> np.ndarray:
    """A host numpy view of a numpy array or a torch tensor."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class CscLP:
    """CSC-by-source edge layout."""
    indptr: np.ndarray    # (I+1,) edge range per source
    dst: np.ndarray       # (nnz,)
    a: np.ndarray         # (m, nnz)
    c: np.ndarray         # (nnz,)
    ub: np.ndarray        # (nnz,)
    s: np.ndarray         # (I,)
    b: np.ndarray         # (m, J)

    @property
    def num_sources(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_destinations(self) -> int:
        return self.b.shape[1]


def from_slabs(lp: LPData) -> CscLP:
    """Flatten the bucketed layout back into CSC-by-source."""
    srcs, dsts, avs, cvs, ubs, ss = [], [], [], [], [], {}
    for slab in lp.slabs:
        mask = _np(slab.mask)
        n, w = mask.shape
        sid = _np(slab.source_ids)
        rows, cols = np.nonzero(mask)
        srcs.append(sid[rows])
        dsts.append(_np(slab.dest_idx)[rows, cols])
        avs.append(_np(slab.a_vals)[rows, cols].T)   # (m, k)
        cvs.append(_np(slab.c_vals)[rows, cols])
        ubs.append(_np(slab.ub)[rows, cols])
        for r, s_ in zip(sid, _np(slab.s)):
            ss[int(r)] = float(s_)
    src = np.concatenate(srcs)
    order = np.argsort(src, kind="stable")
    src = src[order]
    dst = np.concatenate(dsts)[order]
    a = np.concatenate(avs, axis=1)[:, order]
    c = np.concatenate(cvs)[order]
    ub = np.concatenate(ubs)[order]
    uniq = np.unique(src)
    remap = {int(u): k for k, u in enumerate(uniq)}
    I = len(uniq)
    counts = np.zeros(I + 1, np.int64)
    for u in src:
        counts[remap[int(u)] + 1] += 1
    indptr = np.cumsum(counts)
    s_arr = np.array([ss[int(u)] for u in uniq])
    return CscLP(indptr=indptr, dst=dst, a=a.astype(np.float64),
                 c=c.astype(np.float64), ub=ub.astype(np.float64),
                 s=s_arr, b=_np(lp.b).astype(np.float64))


def _project_boxcut_sorted(v: np.ndarray, ub: np.ndarray, s: float) -> np.ndarray:
    """Exact box-cut projection of one block via breakpoint search."""
    x0 = np.clip(v, 0.0, ub)
    if x0.sum() <= s:
        return x0
    bps = np.unique(np.concatenate([v - ub, v]))
    f = np.array([np.clip(v - t, 0.0, ub).sum() for t in bps])
    k = int(np.searchsorted(-f, -s, side="right")) - 1
    k = max(min(k, len(bps) - 2), 0)
    t0, t1, f0, f1 = bps[k], bps[k + 1], f[k], f[k + 1]
    tau = t0 if f0 == f1 else t0 + (f0 - s) * (t1 - t0) / (f0 - f1)
    tau = max(tau, 0.0)
    return np.clip(v - tau, 0.0, ub)


def _project_all(lp: CscLP, u: np.ndarray, kind: str) -> np.ndarray:
    if kind == "box":
        return np.clip(u, 0.0, lp.ub)
    x = np.empty_like(u)
    big = 1e30
    for i in range(lp.num_sources):
        sl = slice(lp.indptr[i], lp.indptr[i + 1])
        ub = lp.ub[sl] if kind == "boxcut" else np.full(sl.stop - sl.start, big)
        x[sl] = _project_boxcut_sorted(u[sl], ub, lp.s[i])
    return x


def dual_value_and_grad(lp: CscLP, lam: np.ndarray, gamma: float,
                        kind: str = "boxcut"):
    """g(λ), ∇g(λ) on the CSC layout (per-edge gather + np.add.at scatter)."""
    m, J = lp.b.shape
    atl = np.einsum("me,me->e", lp.a, lam[:, lp.dst])     # (Aᵀλ) per edge
    u = -(atl + lp.c) / gamma
    x = _project_all(lp, u, kind)
    ax = np.zeros((m, J))
    for k in range(m):
        np.add.at(ax[k], lp.dst, lp.a[k] * x)
    grad = ax - lp.b
    g = float(lp.c @ x + 0.5 * gamma * (x @ x) + np.vdot(lam, grad))
    aux = {"primal_obj": float(lp.c @ x), "x": x,
           "infeas": float(np.linalg.norm(np.maximum(grad, 0.0)))}
    return g, grad, aux


def solve(lp: CscLP, config: SolveConfig, kind: str = "boxcut",
          lam0: Optional[np.ndarray] = None, time_limit: Optional[float] = None):
    """AGD identical in math to the solvers' agd rule (independent code)."""
    m, J = lp.b.shape
    lam = np.zeros((m, J)) if lam0 is None else lam0.astype(np.float64)
    y, lam_prev, y_prev = lam.copy(), lam.copy(), lam.copy()
    grad_prev = np.zeros_like(lam)
    l_est, k_mom = 0.0, 0
    history = {"dual_obj": [], "infeas": [], "step": [], "iter_time": []}
    t_start = time.perf_counter()
    for it in range(config.iterations):
        t0 = time.perf_counter()
        gamma = config.gamma
        if config.gamma_init is not None and config.gamma_init > config.gamma:
            gamma = max(config.gamma,
                        config.gamma_init * config.gamma_decay_rate
                        ** (it // config.gamma_decay_every))
        cap = config.max_step
        if (config.gamma_init is not None and config.scale_step_with_gamma
                and config.gamma_init > config.gamma):
            cap = config.max_step * gamma / config.gamma
        g, grad, aux = dual_value_and_grad(lp, y, gamma, kind)
        # running-max local Lipschitz estimate (as the agd rule keeps it)
        dy = np.linalg.norm(y - y_prev)
        dgn = np.linalg.norm(grad - grad_prev)
        obs = dgn / max(dy, 1e-30) if dy > 0 else 0.0
        l_est = max(l_est * 0.97, obs)
        if it == 0:
            step = config.initial_step
        else:
            step = min(1.0 / l_est if l_est > 0 else cap, cap)
        lam_new = np.maximum(y + step * grad, 0.0)
        # adaptive restart (O'Donoghue & Candès)
        if float(np.vdot(grad, lam_new - lam)) < 0.0:
            k_mom = 0
        else:
            k_mom += 1
        beta = k_mom / (k_mom + 3.0)
        y_new = lam_new + beta * (lam_new - lam)
        lam_prev, lam = lam, lam_new
        grad_prev, y_prev, y = grad, y, y_new
        history["dual_obj"].append(g)
        history["infeas"].append(aux["infeas"])
        history["step"].append(step)
        history["iter_time"].append(time.perf_counter() - t0)
        if time_limit and time.perf_counter() - t_start > time_limit:
            break
    return lam, history
