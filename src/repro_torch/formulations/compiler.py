"""Formulation compiler: lower a declarative spec onto the solver
(DESIGN.md §5); port of `repro.formulations.compiler`.

`compile_formulation(form, lp)` turns a `Formulation` into a
`ComposedObjective`, an objective the unchanged `Maximizer` and stopping
criteria consume.  Lowering steps:

  1. **Weights**: each GlobalBudgetFamily's per-edge weights become
     per-slab (n, w) tensors, or None for the all-ones "count" row (which
     keeps the scalar shift).  They are read from the *original*
     coefficients, before family slicing and row normalization.
  2. **Coupling-row scaling**: under `row_norm` each coupling row r gets
     σ_r = 1/‖w_r‖₂ over the real edges (w' = σw, limit' = σ·limit),
     folded into weighted tensors and kept symbolic for count rows.  At
     γ = 0.01 a few ulps of σ move x coherently through the value row's
     shift, so ‖w_r‖ is summed on the host in float64, the same on every
     device.
  3. **Row-block selection**: the LP is sliced to the DestCapacityFamily's
     lp_families, its rhs overridden and scaled.
  4. **Row normalization** (§5.1) of the destination rows under
     `row_norm`.
  5. **Projection lowering**: the BlockConstraint becomes a ProjectionMap,
     one (kind, iters) a slab.  Kinds with a kernel (box, simplex, boxcut)
     always run it on the card; simplex_eq and boxcut_newton run the plain
     sweep, as the reference's compiler keeps them off its kernels.
  6. **Ax lowering**: the destination block inherits MatchingObjective's
     ax modes (plan, work table, flat buffers); a global row's Ax entry is
     the scalar Σ w·x.

The dual vector is 1-D: `[dest block (m·J, family-major) | one entry per
global row, declaration order]`.  With no global rows the evaluation is
`MatchingObjective`'s operation for operation; with one un-normalized count
row it is `GlobalCountObjective`'s.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..convert import lp_to_numpy, to_numpy
from ..core.instance import validate_lp
from ..core.objectives import AX_MODES, MatchingObjective, ObjectiveAux
from ..core.preconditioning import row_normalize
from ..core.projections import ProjectionMap
from ..core.types import AxPlan, LPData
from ..primal.rounding import primal_ax
from .spec import Formulation, GlobalBudgetFamily


def _slice_lp(lp: LPData, dest) -> LPData:
    """The DestCapacityFamily's transform of the LP: family selection, rhs
    override, rhs scaling."""
    if dest.lp_families is not None:
        idx = torch.tensor([int(k) for k in dest.lp_families],
                           device=lp.b.device)
        slabs = tuple(s._replace(a_vals=s.a_vals.index_select(2, idx))
                      for s in lp.slabs)
        lp = LPData(slabs=slabs, b=lp.b.index_select(0, idx))
    if dest.rhs is not None:
        b = torch.as_tensor(np.asarray(dest.rhs), dtype=lp.b.dtype,
                            device=lp.b.device)
        if tuple(b.shape) != tuple(lp.b.shape):
            raise ValueError(
                f"rhs override shape {tuple(b.shape)} != expected "
                f"{tuple(lp.b.shape)}")
        lp = LPData(slabs=lp.slabs, b=b)
    if dest.rhs_scale != 1.0:
        lp = LPData(slabs=lp.slabs, b=lp.b * dest.rhs_scale)
    return lp


def _materialize_weights(lp: LPData, row: GlobalBudgetFamily):
    """Per-slab (n, w) weight tensors of one global row; None = all ones.
    Zero on padding by construction (c_vals and a_vals are 0 there)."""
    if row.weight == "count":
        return None
    if row.weight == "value":
        # minimization convention: c = −value, so the edge's value is −c
        return tuple(-s.c_vals for s in lp.slabs)
    _, k = row.weight                       # ("lp_family", k), validated
    return tuple(s.a_vals[..., int(k)].contiguous() for s in lp.slabs)


class ComposedObjective(MatchingObjective):
    """The compiled form of a Formulation: the dual value and gradient
    summed over its constraint families, λ concatenated across row blocks.

    The destination block runs MatchingObjective's sweep (`_sweep_slab`:
    the per-slab projection table, every ax mode, the kernels).  Global
    rows enter through the sweep's shift hook and add one gradient entry
    each.  Build it with `compile_formulation`.

    `global_scales` is σ_r of each coupling row (1 without row_norm):
    weighted rows carry it inside their tensors, count rows apply it here,
    so a uniform row keeps the scalar shift.
    """

    def __init__(self, lp: LPData, formulation: Formulation,
                 global_weights: Tuple, global_scales: Tuple = None,
                 row_scaling=None, **kw):
        super().__init__(lp, **kw)
        self.formulation = formulation
        self._global_rows = formulation.global_rows
        self._global_weights = tuple(global_weights)
        self._scales = (tuple(global_scales) if global_scales is not None
                        else (1.0,) * len(self._global_rows))
        self._limits_raw = tuple(float(r.limit) for r in self._global_rows)
        self._limits = tuple(lim * s for lim, s
                             in zip(self._limits_raw, self._scales))
        self.row_scaling = row_scaling       # to map duals back
        if not (len(self._global_weights) == len(self._scales)
                == len(self._global_rows)):
            raise ValueError("one weight and one scale a global row")

    @property
    def dual_shape(self) -> Tuple[int]:
        m, J = self.lp.m, self.lp.num_destinations
        return (m * J + len(self._global_rows),)

    def row_slices(self):
        """{family label: slice into the composed λ vector}."""
        m, J = self.lp.m, self.lp.num_destinations
        out = {self.formulation.dest.label: slice(0, m * J)}
        for i, row in enumerate(self._global_rows):
            out[row.label] = slice(m * J + i, m * J + i + 1)
        return out

    def _split(self, lam_flat):
        """(dest block λ (m, J), [μ_r])."""
        m, J = self.lp.m, self.lp.num_destinations
        k = m * J
        return (lam_flat[:k].reshape(m, J),
                [lam_flat[k + r] for r in range(len(self._global_rows))])

    def _shift_for(self, slab_index: int, mus):
        """Σ_r μ_r·w_r for one slab: a scalar when every row is all ones.
        Weighted rows carry σ in their tensors, count rows apply it here
        (σ == 1 keeps the exact expression of GlobalCountObjective)."""
        shift = None
        for mu, w, s in zip(mus, self._global_weights, self._scales):
            if w is None:
                term = mu if s == 1.0 else mu * s
            else:
                term = mu * w[slab_index]
            shift = term if shift is None else shift + term
        return shift

    def _forward_rows(self, lam, gamma, mus):
        """The sweep with the coupling rows: (Ax, cᵀx, ‖x‖², [Σ w_r·x]).

        `MatchingObjective._forward` with each slab's shift from the rows
        and one weighted-sum accumulator a row; both run `_sweep_slab` (the
        x-carry sweep and `ax_aligned_x` in `aligned`, the gvals sweep in
        the other modes), so the two stay in lockstep."""
        c_x = torch.zeros((), dtype=lam.dtype, device=lam.device)
        x_sq = torch.zeros((), dtype=lam.dtype, device=lam.device)
        wx = [torch.zeros((), dtype=lam.dtype, device=lam.device)
              for _ in self._global_rows]
        for si in range(len(self.lp.slabs)):
            x, c_s, sq_s = self._sweep_slab(si, lam, gamma,
                                            self._shift_for(si, mus))
            c_x = c_x + c_s
            x_sq = x_sq + sq_s
            for r, (w, s) in enumerate(zip(self._global_weights,
                                           self._scales)):
                if w is None:
                    val = x.float().sum()
                    if s != 1.0:
                        val = s * val
                else:
                    val = (w[si].float() * x.float()).sum()
                wx[r] = wx[r] + val
        return self._reduce_ax().to(lam.dtype), c_x, x_sq, wx

    def calculate(self, lam_flat, gamma):
        lam, mus = self._split(lam_flat)
        if not self._global_rows:
            # the destination block alone: MatchingObjective.calculate
            ax, c_x, x_sq, _ = self._forward(lam, gamma)
            wx = []
        elif (len(self._global_rows) == 1
                and self._global_weights[0] is None
                and self._scales[0] == 1.0):
            # one un-normalized all-ones row: GlobalCountObjective.calculate
            ax, c_x, x_sq, x_sum = self._forward(lam, gamma, shift=mus[0],
                                                 with_xsum=True)
            wx = [x_sum]
        else:
            ax, c_x, x_sq, wx = self._forward_rows(lam, gamma, mus)
        grad_main = ax - self.lp.b
        g = c_x + 0.5 * gamma * x_sq + torch.sum(lam * grad_main)
        pieces = [grad_main.reshape(-1)]
        for mu, limit, w in zip(mus, self._limits, wx):
            grad_r = w - limit
            g = g + mu * grad_r
            pieces.append(grad_r.reshape(1))
        grad = torch.cat(pieces) if len(pieces) > 1 else pieces[0]
        infeas = torch.linalg.vector_norm(torch.clamp_min(grad, 0.0))
        return g, grad, ObjectiveAux(primal_obj=c_x, x_sq=x_sq, ax=ax,
                                     infeas=infeas)

    def _dual_parts(self, lam_flat):
        """Dest block + the composed per-slab coupling shift, so `primal`
        and the row-subset `primal_rows` recover the x* of `calculate`."""
        lam, mus = self._split(lam_flat)
        return lam, lambda si: self._shift_for(si, mus)

    def _row_usage(self, xs, r: int) -> float:
        """Σ w_r·x over all slabs in ORIGINAL row units (σ taken back out
        of weighted tensors), summed in float64."""
        w = self._global_weights[r]
        total = 0.0
        for si, x in enumerate(xs):
            x = torch.as_tensor(x).double()
            if w is None:
                total += float(x.sum())
            else:
                ws = w[si].to(x.device).double()
                total += float((ws * x).sum()) / self._scales[r]
        return total

    def family_report(self, xs, lp=None):
        """Per-family slack report at a candidate point `xs` (per-slab
        (n, w) host arrays, padding ignored): the certification hook
        (DESIGN.md §8).  The destination block in the compiled (possibly
        row-normalized) units, coupling rows in original units, each
        through its spec's `residual`.  `lp` is `self.lp` on the host, when
        the caller has it.  {label: {kind, used, limit, max_violation,
        norm_violation, scale}}."""
        lp = lp_to_numpy(self.lp) if lp is None else lp
        b = np.asarray(lp.b)
        dest = self.formulation.dest
        res = np.asarray(dest.residual(primal_ax(lp, xs),
                                       b.astype(np.float64)))
        pos = float(np.linalg.norm(np.maximum(res, 0.0)))
        out = {dest.label: {
            "kind": "dest_capacity", "used": pos, "limit": 0.0,
            "max_violation": float(res.max()) if res.size else 0.0,
            "norm_violation": pos,
            "scale": 1.0 + float(np.abs(b).max() if b.size else 0.0),
        }}
        masked = [np.where(np.asarray(s.mask), np.asarray(x, np.float64),
                           0.0) for s, x in zip(lp.slabs, xs)]
        for r, row in enumerate(self._global_rows):
            used = self._row_usage(masked, r)
            viol = float(row.residual(used))
            out[row.label] = {
                "kind": "global", "used": used,
                "limit": self._limits_raw[r], "max_violation": viol,
                "norm_violation": max(viol, 0.0),
                "scale": 1.0 + abs(self._limits_raw[r]),
            }
        return out

    def global_usage(self, lam_flat, gamma):
        """{row label: (Σ w·x at x*(λ), limit)} in ORIGINAL row units."""
        xs = self.primal(lam_flat, gamma)
        return {row.label: (self._row_usage(xs, r), self._limits_raw[r])
                for r, row in enumerate(self._global_rows)}


def compile_formulation(form: Formulation, lp: LPData, *,
                        ax_mode: str = "aligned",
                        ax_plan: Optional[AxPlan] = None,
                        row_norm: bool = False) -> ComposedObjective:
    """Lower a Formulation onto the solver (module docstring).  `lp` has
    tensor leaves on the device the objective runs on."""
    # a malformed instance fails here, naming every problem, instead of
    # as NaN duals hundreds of iterations later
    validate_lp(lp_to_numpy(lp), name=f"lp for formulation {form.name!r}")
    form.validate(lp.m)
    if ax_mode not in AX_MODES:
        raise ValueError(f"ax_mode must be one of {AX_MODES}, got {ax_mode!r}")
    # weights read the original coefficients: lp_family indices refer to
    # the un-sliced LP, and row normalization must not rescale them
    weights = [_materialize_weights(lp, r) for r in form.global_rows]
    scales = [1.0] * len(weights)
    if row_norm:
        for r, w in enumerate(weights):
            if w is None:
                nnz = sum(int(s.mask.sum()) for s in lp.slabs)
                norm = nnz ** 0.5
            else:
                # summed on the host in float64, so that σ is the same
                # on every device (the reference's float32 vdot differs
                # from it by a few float32 ulps)
                norm = float(sum(np.square(to_numpy(ws).astype(np.float64))
                                 .sum() for ws in w)) ** 0.5
            if norm > 0:
                scales[r] = 1.0 / norm
                if w is not None:
                    weights[r] = tuple(ws * scales[r] for ws in w)
    lp = _slice_lp(lp, form.dest)
    row_scaling = None
    if row_norm:
        lp, row_scaling = row_normalize(lp)
    pmap = ProjectionMap(kind=form.block.kind, overrides=form.block.overrides,
                         iters=form.block.iters)
    return ComposedObjective(
        lp, form, tuple(weights), global_scales=tuple(scales),
        row_scaling=row_scaling, projection_map=pmap, ax_mode=ax_mode,
        ax_plan=ax_plan)
