"""Dual value and gradient of the matching LP (paper §3-§4); port of
`repro.core.objectives`.

    g(λ) = min_{x∈C} cᵀx + (γ/2)‖x‖² + λᵀ(Ax − b),   ∇g(λ) = A x*(λ) − b

One evaluation is a per-slab sweep and an Ax reduction, and `ax_mode`
selects both (DESIGN.md §3):

  "aligned"        the x-carry sweep (`slab_xcarry`, kernel `dual_x`),
                   each slab writing its x into one flat (E,) buffer, then
                   the value-carrying reduction through the plan's static
                   `a_dm` copy (`ops.ax_aligned_x`, kernel `ax_reduce_x`,
                   one kernel call an evaluation over the plan's work
                   table);
  "aligned_gvals"  the gvals sweep (`slab_xgvals`, kernel `dual_grad`),
                   each slab writing gvals = a ⊙ x into one flat (E, m)
                   buffer, then the index-only plan's gather row-sum
                   (`ops.ax_aligned`, kernel `ax_reduce`) — on the card it
                   equals "aligned" bit for bit;
  "sorted"         the gvals sweep, then a segment sum over the real edges
                   sorted by destination once at construction
                   (`torch.segment_reduce`: a fixed order, repeatable);
  "scatter"        the gvals sweep, then a destination-keyed scatter-add
                   (`index_add_`, the paper-faithful baseline; on the card
                   by atomics, in float64 so that their order does not
                   move the float32 result).

`GlobalCountObjective` adds one all-ones dual row through the scalar
`shift` hook of both sweeps.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from .instance import build_ax_plan
from .types import AxPlan, LPData, Slab

AX_MODES = ("scatter", "sorted", "aligned", "aligned_gvals")


class ObjectiveAux(NamedTuple):
    primal_obj: torch.Tensor   # cᵀx*(λ)
    x_sq: torch.Tensor         # ‖x‖²
    ax: torch.Tensor           # (m, J)  A x*(λ)
    infeas: torch.Tensor       # ‖(Ax−b)₊‖₂


def _check_shift(shift):
    if shift is not None and torch.as_tensor(shift).ndim:
        raise NotImplementedError(
            "only a scalar shift is ported; the per-edge coupling shift "
            "comes with the formulations (ROADMAP queue A item 11)")


def slab_xcarry(slab: Slab, lam, gamma, proj_kind: str, proj_iters: int = 40,
                out: Optional[torch.Tensor] = None, shift=None):
    """Gvals-free per-slab forward pass: (x*, cᵀx, ‖x‖²).  `out` (n, w)
    receives x when given.

    `shift` is a scalar coupling-row contribution to u (GlobalCount's μ):
    it is folded into c for the kernel, and the kernel's cᵀx, which then
    includes shift·Σx (x is 0 on padding), is corrected back, as the
    reference's kernel path does.
    """
    _check_shift(shift)
    if shift is None:
        return kops.dual_x_full(slab, lam, gamma, proj_kind, proj_iters,
                                out=out)
    x, c_x, x_sq = kops.dual_x_full(
        slab._replace(c_vals=slab.c_vals + shift), lam, gamma, proj_kind,
        proj_iters, out=out)
    return x, c_x - shift * x.float().sum(), x_sq


def slab_xgvals(slab: Slab, lam, gamma, proj_kind: str, proj_iters: int = 40,
                shift=None, out: Optional[torch.Tensor] = None,
                gvals_out: Optional[torch.Tensor] = None):
    """Fused per-slab forward pass: (x*, gvals, cᵀx, ‖x‖²), kernel
    `dual_grad`.  `out` (n, w) and `gvals_out` (n, w, m) receive x and
    gvals when given.  `shift` as in `slab_xcarry`; x, cᵀx and ‖x‖² are
    the x-carry sweep's bit for bit."""
    _check_shift(shift)
    kslab = slab if shift is None else slab._replace(
        c_vals=slab.c_vals + shift)
    x, gvals, c_x, x_sq = kops.dual_grad_full(
        kslab, lam, gamma, proj_kind, proj_iters, out=out,
        gvals_out=gvals_out)
    if shift is not None:
        c_x = c_x - shift * x.float().sum()
    return x, gvals, c_x, x_sq


def _segment_ax(gvals_flat: torch.Tensor, flat_dest: torch.Tensor,
                num_destinations: int) -> torch.Tensor:
    """(m, J) float32 destination-keyed scatter-add of flattened gvals
    (E, m) by `index_add_` (atomics on the card), summed in float64 and
    rounded once: a float64 sum of float32 values is exact, so the same
    whatever order the atomics land in, while the values' magnitudes span
    less than 2^29, and past that differs by far less than a float32
    ulp.  A float32 sum's result moved with that order, and with it the
    stopping iteration."""
    ax = torch.zeros((num_destinations, gvals_flat.shape[1]),
                     dtype=torch.float64, device=gvals_flat.device)
    return ax.index_add_(0, flat_dest, gvals_flat.double()).float().T


def slab_contribution(slab: Slab, lam, gamma, num_destinations: int,
                      proj_kind: str, proj_iters: int = 40):
    """One slab's (Ax partial, cᵀx, ‖x‖²) via the destination scatter."""
    _, gvals, c_x, x_sq = slab_xgvals(slab, lam, gamma, proj_kind,
                                      proj_iters)
    ax = _segment_ax(gvals.reshape(-1, slab.m),
                     slab.dest_idx.reshape(-1).long(), num_destinations)
    return ax, c_x, x_sq


def dual_value_and_grad(lp: LPData, lam, gamma, proj_kind: str = "boxcut",
                        proj_iters: int = 40):
    """g(λ), ∇g(λ), and diagnostics (functional scatter-mode entry point).
    The reference's `ax_reducer` distribution hook comes with distribution
    (ROADMAP queue A item 12)."""
    J = lp.num_destinations
    ax = torch.zeros((lp.m, J), dtype=lam.dtype, device=lam.device)
    c_x = torch.zeros((), dtype=lam.dtype, device=lam.device)
    x_sq = torch.zeros((), dtype=lam.dtype, device=lam.device)
    for slab in lp.slabs:
        ax_s, c_s, sq_s = slab_contribution(slab, lam, gamma, J, proj_kind,
                                            proj_iters)
        ax, c_x, x_sq = ax + ax_s, c_x + c_s, x_sq + sq_s
    grad = ax - lp.b
    g = c_x + 0.5 * gamma * x_sq + torch.sum(lam * grad)
    infeas = torch.linalg.vector_norm(torch.clamp_min(grad, 0.0))
    return g, grad, ObjectiveAux(primal_obj=c_x, x_sq=x_sq, ax=ax,
                                 infeas=infeas)


def _edge_map(starts, offsets, device):
    """The map of an edge index from the slabs' concatenated edge space
    (slab k's edges from `starts[k]`) to the flat buffers' (from
    `offsets[k]`), as a function of an index tensor; None where the two
    spaces are one."""
    if starts == offsets:
        return None
    first = torch.tensor(starts, dtype=torch.long, device=device)
    shift = torch.tensor([o - s for o, s in zip(offsets, starts)],
                         dtype=torch.long, device=device)

    def to_buf(idx):
        k = torch.searchsorted(first, idx.long(), right=True) - 1
        return (idx + shift[k]).to(idx.dtype)
    return to_buf


class MatchingObjective:
    """Paper §4 `ObjectiveFunction` facade over an LP on one device, in any
    of the reference's `ax_mode`s (module docstring).

    The sweep writes each slab's x (and, in the gvals modes, its gvals)
    into a slice of one flat buffer in slab-concatenation order, allocated
    once here.  Each slice starts on a 16-byte boundary, and the plan's
    edge indices are mapped to that layout where it leaves gaps.
    """

    def __init__(self, lp: LPData, proj_kind: str = "boxcut",
                 proj_iters: int = 40, ax_mode: str = "aligned",
                 ax_plan: Optional[AxPlan] = None):
        if ax_mode not in AX_MODES:
            raise ValueError(f"ax_mode must be one of {AX_MODES}, got {ax_mode!r}")
        self.lp = lp
        self.proj_kind = proj_kind
        self.proj_iters = proj_iters
        self.ax_mode = ax_mode
        device = lp.b.device
        if ax_mode in ("aligned", "aligned_gvals"):
            carry = ax_mode == "aligned"
            if ax_plan is None:
                from ..convert import lp_to_numpy, plan_to_torch  # convert imports core
                ax_plan = plan_to_torch(build_ax_plan(
                    lp_to_numpy(lp), carry_values=carry), device)
            if carry and any(b.a_dm is None for b in ax_plan.buckets):
                raise ValueError(
                    "ax_mode='aligned' (x-carry) needs a value-carrying "
                    "plan; rebuild with build_ax_plan(lp, carry_values=True) "
                    "or use ax_mode='aligned_gvals'")
        dtype = lp.slabs[0].c_vals.dtype if lp.slabs else torch.float32
        # each slab's slice of the flat buffers starts on a 16-byte
        # boundary, as the sweep kernels' vector stores need: the slabs'
        # concatenated edge space with a gap of at most 15 bytes before a
        # slab, which the plan's edge indices and the sorted order follow
        align = 16 // torch.empty((), dtype=dtype).element_size()
        starts, self._offsets, end, off = [], [], 0, 0
        for s in lp.slabs:
            off = -(-off // align) * align
            starts.append(end)
            self._offsets.append(off)
            end += s.n * s.width
            off += s.n * s.width
        to_buf = _edge_map(starts, self._offsets, device)
        if ax_plan is not None and to_buf is not None:
            ax_plan = ax_plan._replace(buckets=tuple(
                b._replace(edge_idx=to_buf(b.edge_idx))
                for b in ax_plan.buckets))
        self._plan = ax_plan
        # the Ax kernels' work table, built once a plan (on the card only:
        # the CPU's plain versions sum bucket by bucket)
        self._work = (kops.plan_work(ax_plan)
                      if ax_plan is not None and device.type == "cuda"
                      else None)
        # the flat (E,) x buffer every evaluation's sweep writes into, and
        # in the gvals modes the flat (E, m) gvals buffer; the gaps stay 0
        self._xbuf = torch.zeros(off, dtype=dtype, device=device)
        self._gbuf = None
        if ax_mode != "aligned":
            self._gbuf = torch.zeros((off, lp.m), dtype=dtype, device=device)
        if ax_mode == "scatter":
            # the gaps add their zeros to destination 0, as padding does
            self._flat_dest = torch.zeros(off, dtype=torch.long,
                                          device=device)
            for o, s in zip(self._offsets, lp.slabs):
                self._flat_dest[o:o + s.n * s.width] = s.dest_idx.reshape(-1)
        elif ax_mode == "sorted":
            # host-side stable sort of the real edges by destination, once;
            # padding adds only zeros to destination 0, so it is left out
            dests = np.concatenate([s.dest_idx.cpu().numpy().reshape(-1)
                                    for s in lp.slabs])
            real = np.nonzero(np.concatenate(
                [s.mask.cpu().numpy().reshape(-1) for s in lp.slabs]))[0]
            order = torch.from_numpy(
                real[np.argsort(dests[real], kind="stable")]).to(device)
            self._perm = order if to_buf is None else to_buf(order)
            self._lengths = torch.from_numpy(np.bincount(
                dests[real], minlength=lp.num_destinations)).to(device)

    @property
    def dual_shape(self) -> Tuple[int, ...]:
        return (self.lp.m, self.lp.num_destinations)

    def _views(self, i: int, slab: Slab):
        off, size = self._offsets[i], slab.n * slab.width
        x = self._xbuf[off:off + size].view(slab.n, slab.width)
        g = (None if self._gbuf is None else
             self._gbuf[off:off + size].view(slab.n, slab.width, slab.m))
        return x, g

    def _reduce_ax(self) -> torch.Tensor:
        """(m, J) float32 Ax from the filled buffers, per the mode."""
        J = self.lp.num_destinations
        if self.ax_mode == "aligned":
            return kops.ax_aligned_x(self._plan, self._xbuf,
                                     out_dtype=torch.float32,
                                     work=self._work)
        if self.ax_mode == "aligned_gvals":
            return kops.ax_aligned(self._plan, self._gbuf,
                                   out_dtype=torch.float32, work=self._work)
        if self.ax_mode == "sorted":
            data = self._gbuf.index_select(0, self._perm).float()
            return torch.segment_reduce(data, "sum", lengths=self._lengths,
                                        axis=0, unsafe=True, initial=0.0).T
        return _segment_ax(self._gbuf, self._flat_dest, J)

    def _forward(self, lam, gamma, shift=None, with_xsum: bool = False):
        """The slab sweep and the Ax reduction: (Ax, cᵀx, ‖x‖², Σx); Σx is
        0 unless `with_xsum`."""
        c_x = torch.zeros((), dtype=lam.dtype, device=lam.device)
        x_sq = torch.zeros((), dtype=lam.dtype, device=lam.device)
        x_sum = torch.zeros((), dtype=lam.dtype, device=lam.device)
        for i, slab in enumerate(self.lp.slabs):
            xv, gv = self._views(i, slab)
            if gv is None:
                x, c_s, sq_s = slab_xcarry(slab, lam, gamma, self.proj_kind,
                                           self.proj_iters, out=xv,
                                           shift=shift)
            else:
                x, _, c_s, sq_s = slab_xgvals(slab, lam, gamma,
                                              self.proj_kind,
                                              self.proj_iters, shift=shift,
                                              out=xv, gvals_out=gv)
            c_x = c_x + c_s
            x_sq = x_sq + sq_s
            if with_xsum:
                x_sum = x_sum + x.float().sum()
        return self._reduce_ax().to(lam.dtype), c_x, x_sq, x_sum

    def calculate(self, lam, gamma):
        ax, c_x, x_sq, _ = self._forward(lam, gamma)
        grad = ax - self.lp.b
        g = c_x + 0.5 * gamma * x_sq + torch.sum(lam * grad)
        infeas = torch.linalg.vector_norm(torch.clamp_min(grad, 0.0))
        return g, grad, ObjectiveAux(primal_obj=c_x, x_sq=x_sq, ax=ax,
                                     infeas=infeas)

    def _dual_parts(self, lam):
        """Split a dual vector into (destination block λ, the scalar shift
        of the extra rows or None): the hook every primal-recovery surface
        goes through, so subclasses with extra dual rows recover x*
        unchanged."""
        return lam, None

    def primal(self, lam, gamma):
        """The (padded) primal solution x*(λ), slab by slab."""
        lam_block, shift = self._dual_parts(lam)
        return [slab_xcarry(s, lam_block, gamma, self.proj_kind,
                            self.proj_iters, shift=shift)[0]
                for s in self.lp.slabs]

    def primal_rows(self, lam, gamma, slab_index: int, rows) -> torch.Tensor:
        """x*(λ) for a subset of one slab's source rows — the serving path.
        Every operation is row-local, so the result equals the matching
        rows of `primal` bit for bit."""
        lam_block, shift = self._dual_parts(lam)
        slab = self.lp.slabs[slab_index]
        rows = torch.as_tensor(rows, device=slab.c_vals.device).long()
        sub = Slab(*(leaf.index_select(0, rows) for leaf in slab))
        return slab_xcarry(sub, lam_block, gamma, self.proj_kind,
                           self.proj_iters, shift=shift)[0]


class GlobalCountObjective(MatchingObjective):
    """The paper's §4 extension: a global count constraint Σ_ij x_ij <=
    count as ONE extra dual row μ, appended to the flattened (m·J,) dual:
    the dual is (m·J + 1,).  μ enters u uniformly through the scalar
    `shift` hook of the shared sweep, and the row's Ax entry is Σx, so it
    runs in every `ax_mode`.

    `row_scale` σ writes the row as σ·Σx <= σ·count: the same constraint,
    with μ's shift σ·μ and its gradient σ·(Σx − count).  σ = 1 is the
    reference class; σ = 1/√(real edges) is the Jacobi factor the
    reference's formulations compiler gives a global row under
    `row_norm=True`, without which the all-ones row's curvature dwarfs the
    row-normalized destination rows' and agd crawls (PERF.md §6).
    """

    def __init__(self, lp: LPData, count: float, row_scale: float = 1.0,
                 **kw):
        super().__init__(lp, **kw)
        self.count = count
        self.row_scale = row_scale

    @property
    def dual_shape(self) -> Tuple[int, ...]:
        m, J = super().dual_shape
        return (m * J + 1,)

    def _dual_parts(self, lam_flat):
        m, J = self.lp.m, self.lp.num_destinations
        return lam_flat[:-1].reshape(m, J), lam_flat[-1] * self.row_scale

    def calculate(self, lam_flat, gamma):
        lam, shift = self._dual_parts(lam_flat)
        mu = lam_flat[-1]
        ax, c_x, x_sq, x_sum = self._forward(lam, gamma, shift=shift,
                                             with_xsum=True)
        grad_main = ax - self.lp.b
        grad_cnt = self.row_scale * (x_sum - self.count)
        g = (c_x + 0.5 * gamma * x_sq + torch.sum(lam * grad_main)
             + mu * grad_cnt)
        grad = torch.cat([grad_main.reshape(-1), grad_cnt.reshape(1)])
        infeas = torch.linalg.vector_norm(torch.clamp_min(grad, 0.0))
        return g, grad, ObjectiveAux(primal_obj=c_x, x_sq=x_sq, ax=ax,
                                     infeas=infeas)
