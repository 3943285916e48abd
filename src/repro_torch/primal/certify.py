"""Solution certification: duality-gap bounds and per-family slack reports;
port of `repro.primal.certify`.

For min cᵀx s.t. Ax ≤ b, x ∈ C and its ridge-perturbed dual g_γ(λ):

  * g_γ(λ) − (γ/2)·B ≤ OPT for any λ ≥ 0, with B ≥ max_{x∈C} ‖x‖²;
  * OPT ≤ cᵀx̂ for any feasible x̂.

So gap = cᵀx̂ − (g_γ(λ) − (γ/2)B) certifies the witness x̂ whenever the
slack report — host numpy, independent of the solver's Ax path — shows it
feasible.  The report covers every constraint family — through the
compiled formulations' `family_report` hook, else the destination-capacity
block and the global count row of `GlobalCountObjective` (in count units:
its `row_scale` σ writes the same constraint as σ·Σx <= σ·count) — and the
blockwise set C itself, per slab kind.  The default witness is
`repair_witness`: the capacity repair, then one uniform shrink until every
global row holds.  A simplex_eq block's witness breaks Σx = s under the
shrinks, and its `blocks` family then reports the certificate INVALID.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..convert import lp_to_numpy, to_numpy
from .extract import extract_primal
from .rounding import primal_ax, scale_repair


class FamilySlack(NamedTuple):
    label: str
    kind: str               # "dest_capacity" | "global" | "blocks"
    used: float             # Σx (global) / ‖(Ax−b)₊‖ (dest block)
    limit: float            # count (global) / 0.0
    max_violation: float    # worst signed residual (≤ 0 means slack)
    norm_violation: float   # ‖positive residuals‖₂
    violation_rel: float    # max_violation / family scale


class Certificate(NamedTuple):
    dual_value: float          # g_γ(λ) from the objective's calculate
    gamma: float
    x_sq_bound: float          # B
    deregularization: float    # (γ/2)·B
    dual_bound: float          # g_γ(λ) − (γ/2)·B  ≤ OPT
    primal_value: float        # cᵀx̂ of the witness
    gap: float
    gap_rel: float
    slacks: Dict[str, FamilySlack]
    max_violation_rel: float
    feasible: bool
    tol: float

    @property
    def valid(self) -> bool:
        """Finite nonnegative gap on a feasible witness."""
        return (self.feasible and np.isfinite(self.gap)
                and self.gap >= -self.tol * max(1.0, abs(self.primal_value)))


def x_sq_bound(lp) -> float:
    """B ≥ max ‖x‖² over the blockwise set: per row the smaller of Σub²
    and, with a finite budget, s·min(s, max ub)."""
    total = 0.0
    for slab in lp.slabs:
        ub = np.where(np.asarray(slab.mask),
                      np.asarray(slab.ub, np.float64), 0.0)
        s = np.asarray(slab.s, np.float64)
        box = np.sum(ub * ub, axis=1)
        ubmax = ub.max(axis=1) if ub.shape[1] else np.zeros(len(s))
        budget = np.where(np.isfinite(s), s * np.minimum(s, ubmax), np.inf)
        total += float(np.sum(np.minimum(box, budget)))
    return total


def primal_value(lp, xs: Sequence[np.ndarray]) -> float:
    """cᵀx̂ (minimization convention: c = −value)."""
    val = 0.0
    for slab, x in zip(lp.slabs, xs):
        xv = np.where(np.asarray(slab.mask), np.asarray(x, np.float64), 0.0)
        val += float(np.sum(np.asarray(slab.c_vals, np.float64) * xv))
    return val


def _fallback_family_report(obj, lp, xs) -> Dict[str, dict]:
    """The destination-capacity block and, when `obj` has a `count`, the
    global count row Σx <= count (the reference's report for objectives
    without the formulations' `family_report` hook)."""
    res = primal_ax(lp, xs) - np.asarray(lp.b, np.float64)
    b = np.asarray(lp.b)
    out = {"dest_capacity": {
        "kind": "dest_capacity",
        "used": float(np.linalg.norm(np.maximum(res, 0.0))),
        "limit": 0.0,
        "max_violation": float(res.max()) if res.size else 0.0,
        "norm_violation": float(np.linalg.norm(np.maximum(res, 0.0))),
        "scale": 1.0 + float(np.abs(b).max() if b.size else 0.0),
    }}
    count = getattr(obj, "count", None)
    if count is not None:
        used = sum(float(np.where(np.asarray(s.mask),
                                  np.asarray(x, np.float64), 0.0).sum())
                   for s, x in zip(lp.slabs, xs))
        out["global_count"] = {
            "kind": "global", "used": used, "limit": float(count),
            "max_violation": used - float(count),
            "norm_violation": max(used - float(count), 0.0),
            "scale": 1.0 + abs(float(count)),
        }
    return out


def _block_report(obj, lp, xs) -> dict:
    """Residuals of the blockwise set C: x >= 0, x <= ub, Σx <= s (= s
    for the objective's simplex_eq slabs, from its per-slab table)."""
    kinds = getattr(obj, "_slab_proj", None)
    worst = 0.0
    scale = 1.0
    for si, (slab, x) in enumerate(zip(lp.slabs, xs)):
        mask = np.asarray(slab.mask)
        xv = np.where(mask, np.asarray(x, np.float64), 0.0)
        ub = np.where(mask, np.asarray(slab.ub, np.float64), np.inf)
        worst = max(worst, float(np.max(-xv, initial=0.0)))
        box = xv - ub
        worst = max(worst, float(np.max(box[np.isfinite(box)], initial=0.0)))
        s = np.asarray(slab.s, np.float64)
        fin = np.isfinite(s)
        if fin.any():
            resid = xv.sum(axis=1)[fin] - s[fin]
            if kinds is not None and kinds[si][0] == "simplex_eq":
                resid = np.abs(resid)
            worst = max(worst, float(np.max(resid, initial=0.0)))
            scale = max(scale, 1.0 + float(np.max(s[fin])))
    return {"kind": "blocks", "used": worst, "limit": 0.0,
            "max_violation": worst, "norm_violation": worst, "scale": scale}


def family_slacks(obj, xs, lp=None) -> Dict[str, FamilySlack]:
    """Slack report at a candidate point: the row families (the
    objective's `family_report` where it has one) and the blockwise set
    C.  `lp` is `obj.lp` on the host, when the caller has it already."""
    lp = lp_to_numpy(obj.lp) if lp is None else lp
    raw = (obj.family_report(xs, lp) if hasattr(obj, "family_report")
           else _fallback_family_report(obj, lp, xs))
    raw = dict(raw, blocks=_block_report(obj, lp, xs))
    return {label: FamilySlack(
                label=label, kind=d["kind"], used=d["used"], limit=d["limit"],
                max_violation=d["max_violation"],
                norm_violation=d["norm_violation"],
                violation_rel=d["max_violation"] / d.get("scale", 1.0))
            for label, d in raw.items()}


def global_row_caps(obj):
    """[(per-slab host weights or None for all ones, limit)] of every
    coupling row of `obj`, in ORIGINAL units (σ taken back out of a
    compiled formulation's weights): the shape `rounding.greedy_repair`
    takes.  One all-ones row for `GlobalCountObjective`, none for a plain
    `MatchingObjective`."""
    rows = getattr(obj, "_global_rows", None)
    if not rows:
        count = getattr(obj, "count", None)
        return [(None, float(count))] if count is not None else []
    out = []
    for r in range(len(rows)):
        w = obj._global_weights[r]
        out.append((None if w is None else
                    [to_numpy(ws).astype(np.float64) / obj._scales[r]
                     for ws in w], obj._limits_raw[r]))
    return out


def repair_witness(obj, xs: Sequence[np.ndarray], eps: float = 1e-6,
                   lp=None) -> List[np.ndarray]:
    """Make a candidate feasible for every family: `scale_repair` fixes
    the capacity rows, then one uniform factor fixes any violated global
    row (its weights are nonnegative, so a uniform shrink scales its use
    linearly).  Shrinking only loosens the capacity rows, the budgets and
    the box bounds."""
    lp = lp_to_numpy(obj.lp) if lp is None else lp
    xs = scale_repair(xs, lp, eps=eps)
    f = 1.0
    for s in family_slacks(obj, xs, lp).values():
        if s.kind == "global" and s.used > s.limit and s.used > 0:
            f = min(f, (1.0 - eps) * s.limit / s.used)
    if f < 1.0:
        xs = [np.where(np.asarray(slab.mask),
                       np.asarray(x) * f, 0.0).astype(np.asarray(x).dtype)
              for slab, x in zip(lp.slabs, xs)]
    return xs


def certify(obj, lam, gamma, xs: Optional[Sequence[np.ndarray]] = None,
            tol: float = 1e-5, chunk_rows: int = 4096,
            sampler=None) -> Certificate:
    """Build the duals-to-decisions certificate.  `xs` is the witness;
    when omitted it is extracted from λ in chunks and made feasible across
    every family by `repair_witness`.  `sampler` (a
    `repro_torch.obs.MemorySampler`) is read once an extraction chunk and
    once after the family sums, the certify path's host high; None reads
    nothing, and the certificate is the same either way."""
    dev = obj.lp.b.device
    g = float(obj.calculate(torch.as_tensor(lam, device=dev),
                            torch.as_tensor(gamma, dtype=torch.float32,
                                            device=dev))[0])
    lp = lp_to_numpy(obj.lp)
    if xs is None:
        xs = repair_witness(obj, extract_primal(obj, lam, gamma,
                                                chunk_rows=chunk_rows,
                                                sampler=sampler),
                            lp=lp)
    slacks = family_slacks(obj, xs, lp)
    if sampler is not None:
        sampler.sample(where="certify")
    worst = max((s.violation_rel for s in slacks.values()), default=0.0)
    B = x_sq_bound(lp)
    dereg = 0.5 * float(gamma) * B
    p_val = primal_value(lp, xs)
    gap = p_val - (g - dereg)
    return Certificate(
        dual_value=g, gamma=float(gamma), x_sq_bound=B,
        deregularization=dereg, dual_bound=g - dereg,
        primal_value=p_val, gap=gap, gap_rel=gap / max(1.0, abs(p_val)),
        slacks=slacks, max_violation_rel=worst,
        feasible=worst <= tol, tol=tol)


def format_certificate(cert: Certificate) -> str:
    """Human-readable certificate block (the CLI report)."""
    lines = [
        f"dual value g_γ(λ)        {cert.dual_value:.6f}   (γ = {cert.gamma:.4g})",
        f"deregularization (γ/2)B  {cert.deregularization:.6f}   "
        f"(B = {cert.x_sq_bound:.4g})",
        f"certified dual bound     {cert.dual_bound:.6f}  <=  OPT",
        f"primal witness value     {cert.primal_value:.6f}  >=  OPT",
        f"duality gap              {cert.gap:.6f}   "
        f"(relative {cert.gap_rel:.3e})",
    ]
    for s in cert.slacks.values():
        if s.kind == "global":
            lines.append(
                f"family {s.label:<16} used {s.used:.3f} / limit {s.limit:.3f}"
                f"   violation {max(s.max_violation, 0.0):.2e}")
        else:
            lines.append(
                f"family {s.label:<16} ‖(Ax−b)₊‖ {s.norm_violation:.2e}"
                f"   worst row {s.max_violation:+.2e}")
    lines.append(
        f"certificate: {'VALID' if cert.valid else 'INVALID'} "
        f"(feasible={cert.feasible}, worst rel violation "
        f"{cert.max_violation_rel:.2e}, tol {cert.tol:.0e})")
    return "\n".join(lines)
