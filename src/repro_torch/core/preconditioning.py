"""Paper §5.1: Jacobi row normalization and primal (per-block) scaling;
port of `repro.core.preconditioning`.

Row normalization: A' = D A, b' = D b with D = diag(‖A_r·‖₂⁻¹); zero-norm
rows are left unscaled.  Primal scaling: z = v_i·x per source block, with
v_i the RMS of the block's column norms.  Both act on the slab layout on
whatever device the LP lives on, and return a new LPData plus what is
needed to map duals and primals back.  `gram_condition_number` is κ(AAᵀ)
on the host in float64, for small instances.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..obs.telemetry import current
from .types import LPData


class RowScaling(NamedTuple):
    d: torch.Tensor  # (m, J): A' = D A with D = diag(d)


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor,
                 num: int) -> torch.Tensor:
    """Per-segment sums of the rows of `vals` (N, m) by id `seg` (N,), in
    float64, summed on the host in index order so that every run and device
    gives the same bits.  On the card `index_add_` sums with atomics and
    `cumsum` scans in an order that depends on timing, so their last bits
    change from run to run, and the solve's trajectory with them."""
    seg_h, vals_h = seg.cpu(), vals.cpu().double()
    sums = [torch.bincount(seg_h, weights=vals_h[:, k], minlength=num)
            for k in range(vals_h.shape[1])]
    return torch.stack(sums, dim=1).to(vals.device)


def row_norms(lp: LPData) -> torch.Tensor:
    """‖A_r·‖₂ per dual row, from the slabs: (m, J), float32."""
    dest = torch.cat([s.dest_idx.reshape(-1) for s in lp.slabs]).long()
    a2 = torch.cat([(s.a_vals ** 2).reshape(-1, lp.m) for s in lp.slabs])
    sq = _segment_sum(a2, dest, lp.num_destinations)
    return torch.sqrt(sq.T).to(torch.float32)


def row_normalize(lp: LPData) -> Tuple[LPData, RowScaling]:
    """Jacobi preconditioning: returns (scaled LP, scaling to undo duals);
    λ = D λ' maps a dual of the scaled problem back.  Runs in a
    `row_norm` span of the thread's active recorder."""
    with current().span("row_norm"):
        norms = row_norms(lp)
        d = torch.where(norms > 0, 1.0 / torch.clamp_min(norms, 1e-30),
                        torch.ones_like(norms))
        slabs = []
        for slab in lp.slabs:
            d_e = d[:, slab.dest_idx.long()]             # (m, n, w)
            slabs.append(slab._replace(
                a_vals=slab.a_vals * d_e.permute(1, 2, 0)))
        return LPData(slabs=tuple(slabs), b=lp.b * d), RowScaling(d=d)


def undo_row_scaling(lam_scaled: torch.Tensor,
                     scaling: RowScaling) -> torch.Tensor:
    return lam_scaled * scaling.d


class PrimalScaling(NamedTuple):
    v: Tuple[torch.Tensor, ...]  # per-slab (n,) block scale factors


def block_scales(lp: LPData) -> PrimalScaling:
    """v_i = RMS column norm within block i (column norm over families)."""
    vs = []
    for slab in lp.slabs:
        col_sq = (slab.a_vals ** 2).sum(dim=-1)
        cnt = torch.clamp_min(slab.mask.sum(dim=-1), 1)
        rms = torch.sqrt(torch.where(slab.mask, col_sq,
                                     torch.zeros_like(col_sq)).sum(dim=-1)
                         / cnt)
        vs.append(torch.where(rms > 0, rms, torch.ones_like(rms)))
    return PrimalScaling(v=tuple(vs))


def primal_scale(lp: LPData, scaling: PrimalScaling = None):
    """Apply z = D_v x blockwise: c' = c/v, A' = A/v, ub' = v·ub, s' = v·s."""
    if scaling is None:
        scaling = block_scales(lp)
    slabs = []
    for slab, v in zip(lp.slabs, scaling.v):
        inv = (1.0 / v)[:, None]
        slabs.append(slab._replace(
            a_vals=slab.a_vals * inv[..., None], c_vals=slab.c_vals * inv,
            ub=slab.ub * v[:, None], s=slab.s * v))
    return LPData(slabs=tuple(slabs), b=lp.b), scaling


def undo_primal_scaling(xs, scaling: PrimalScaling):
    """Map per-slab primal solutions of the scaled problem back: x = z/v."""
    return [z / v[:, None] for z, v in zip(xs, scaling.v)]


def precondition(lp: LPData, row_norm: bool = True, primal: bool = False):
    """Apply the §5.1 transforms; returns (lp', (row_scaling, p_scaling))."""
    row_scaling = None
    p_scaling = None
    if primal:
        lp, p_scaling = primal_scale(lp)
    if row_norm:
        lp, row_scaling = row_normalize(lp)
    return lp, (row_scaling, p_scaling)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:     # numpy has no bfloat16
            a = a.float()
        return a.detach().cpu().numpy()
    return np.asarray(a)


def gram_condition_number(lp: LPData) -> float:
    """κ(AAᵀ) from the dense Gram matrix over the m·J dual rows, summed in
    numpy float64 — small instances only (tests, the Lemma 5.1 check).
    Rows with a zero diagonal are dropped, and so are eigenvalues under
    1e-12 of the largest.  A row (k, j) meets only edges into destination
    j, so an edge adds a_k1·a_k2 at (k1·J + j, k2·J + j).  As in the
    reference, each product is formed in the slab's dtype (float32) and
    the entries are summed slab by slab, row by row: its rounding then
    sets the smallest eigenvalues kept, and κ with them."""
    m, J = lp.m, lp.num_destinations
    gram = np.zeros((m * J, m * J))
    for slab in lp.slabs:
        a = _host(slab.a_vals)                          # (n, w, m)
        d = _host(slab.dest_idx).reshape(-1)            # (n·w,)
        flat = a.reshape(-1, a.shape[-1])
        for k1 in range(a.shape[-1]):
            for k2 in range(a.shape[-1]):
                np.add.at(gram, (k1 * J + d, k2 * J + d),
                          flat[:, k1] * flat[:, k2])
    nz = np.diag(gram) > 0
    gram = gram[np.ix_(nz, nz)]
    ev = np.linalg.eigvalsh(gram)
    ev = ev[ev > max(ev.max() * 1e-12, 0)]
    return float(ev.max() / ev.min())
