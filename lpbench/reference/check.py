"""The comparison that decides `correct`.

Each completed solve of the window returns a dual (lam) and reports the
dual value at which its engine stopped.  The reference judges each
distinct answer (solves that return the same bits are judged once), at
the gamma the solve ended on, by three numbers, each held to a limit of
its configuration's `checks`:

  dual_rel   |g_reported - g_ref(lam)| / |g_ref(lam)|: the value the solve
             says it reached against what the returned lam gives.  Covers
             the evaluation (K1, K2, the coupling rows, the preconditioning)
             and the stop's report, and an answer altered after it was
             evaluated.
  grad_rel   the program's gradient at lam (its `calculate`, the window's
             own objective and kernels) against the reference's: the
             destination block relative to |b'|, each coupling row relative
             to its limit.
  kkt_rel    |lam - max(lam + grad_ref(lam), 0)| over the same at lam = 0:
             how far the returned lam is from a maximizer, against where
             the solve began.  Covers the engine's stop: a stop before the
             dual has converged, or a step that leaves lam where it was,
             reads near 1.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .lp import ReferenceLP, grad_gap, kkt_residual, relative


def judge(ref: ReferenceLP, answers: List[dict]) -> Dict[str, float]:
    """The worst reading of each number over `answers`, each a dict with
    `lam`, `gamma`, `dual` (the reported value) and `grad` (the
    program's gradient at lam, or None)."""
    worst = {"dual_rel": 0.0, "grad_rel": 0.0, "kkt_rel": 0.0}
    base = {}
    for ans in answers:
        gamma = float(ans["gamma"])
        lam = ans["lam"].reshape(-1).to(ref.acc)
        g_ref, grad_ref = ref.evaluate(lam, gamma)
        if gamma not in base:
            _, grad0 = ref.evaluate(torch.zeros_like(lam), gamma)
            base[gamma] = kkt_residual(torch.zeros_like(lam), grad0)
        readings = {
            "dual_rel": relative(float(ans["dual"]), g_ref),
            "kkt_rel": kkt_residual(lam, grad_ref) / max(base[gamma], 1e-300),
            "grad_rel": (grad_gap(ans["grad"], grad_ref, ref)
                         if ans.get("grad") is not None else float("inf")),
        }
        for k, v in readings.items():
            if not v <= worst[k] or v != v:    # NaN stays the worst
                worst[k] = v if worst[k] == worst[k] else worst[k]
    return worst


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number is within its limit (NaN never is)."""
    return all(readings[k] <= limits[k] for k in limits)
