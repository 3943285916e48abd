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

Each slab projects with its own (kind, iters) from a `ProjectionMap`;
the kinds with no kernel (simplex_eq, boxcut_newton) run the plain sweep,
as the reference's compiler keeps them off its kernels.
`GlobalCountObjective` adds one all-ones dual row through the scalar
`shift` hook of both sweeps; the formulations' `ComposedObjective` adds
weighted rows through its per-edge form.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from ..obs.telemetry import current
from . import projections
from .instance import build_ax_plan
from .types import AxPlan, LPData, Slab

AX_MODES = ("scatter", "sorted", "aligned", "aligned_gvals")


class ObjectiveAux(NamedTuple):
    primal_obj: torch.Tensor   # cᵀx*(λ)
    x_sq: torch.Tensor         # ‖x‖²
    ax: torch.Tensor           # (m, J)  A x*(λ)
    infeas: torch.Tensor       # ‖(Ax−b)₊‖₂


def _shift_term(shift, x) -> torch.Tensor:
    """The shift's part of cᵀx when the kernel saw c + shift: shift·Σx for
    a scalar shift, <shift, x> for an (n, w) one (x is 0 on padding)."""
    if torch.as_tensor(shift).ndim:
        return (shift.float() * x.float()).sum()
    return shift * x.float().sum()


def _plain_u(slab: Slab, lam, gamma, shift):
    """u = −(Σ_k a_k ⊙ λ_k[dest] + shift + c)/γ in the reference's order of
    operations (its jnp sweep)."""
    d = slab.dest_idx.long()
    atl = torch.zeros(slab.c_vals.shape, dtype=slab.a_vals.dtype,
                      device=slab.a_vals.device)
    for k in range(slab.m):
        atl = atl + slab.a_vals[:, :, k] * lam[k][d]
    if shift is not None:
        atl = atl + shift
    gamma = torch.as_tensor(gamma, device=slab.c_vals.device).to(
        slab.c_vals.dtype)
    return -(atl + slab.c_vals) / gamma


class ProjectionGraph:
    """One slab's plain projection, `projections.project(kind, u, ub, s,
    mask, iters)`, captured once as a CUDA graph and replayed with u
    copied in.  Its fixed-count bisection is ~10 small launches a step,
    ~600 a slab, which eager PyTorch launches one by one (35–43
    ms/iteration at parity size on an H100, PERF.md §6); a replay
    runs the same kernels, so x keeps its bits.  Returns a buffer the next
    replay overwrites."""

    def __init__(self, slab: Slab, kind: str, iters: int):
        self.u = torch.zeros_like(slab.c_vals)
        args = (kind, self.u, slab.ub, slab.s, slab.mask)
        side = torch.cuda.Stream(slab.c_vals.device)
        side.wait_stream(torch.cuda.current_stream(slab.c_vals.device))
        with torch.cuda.stream(side):       # warm-up, outside the capture
            projections.project(*args, iters=iters)
        torch.cuda.current_stream(slab.c_vals.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.x = projections.project(*args, iters=iters)

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        self.u.copy_(u)
        self.graph.replay()
        return self.x


def _plain_sweep(slab: Slab, lam, gamma, proj_kind: str, proj_iters: int,
                 shift, out: Optional[torch.Tensor], project=None):
    """(x*, cᵀx, ‖x‖²) of one slab whose kind has no kernel (simplex_eq,
    boxcut_newton): gather λ, form u, `projections.project`, as the
    reference's jnp sweep does.  `out` (n, w) receives x when given.
    `project`, when given, is the slab's `ProjectionGraph`."""
    u = _plain_u(slab, lam, gamma, shift)
    if project is None:
        x = projections.project(proj_kind, u, slab.ub, slab.s, slab.mask,
                                iters=proj_iters)
    else:
        x = project(u)
    x = x.to(slab.c_vals.dtype)
    if out is not None:
        out.copy_(x)
        x = out
    elif project is not None:
        x = x.clone()
    return (x, (slab.c_vals * x).float().sum(), (x * x).float().sum())


def slab_xcarry(slab: Slab, lam, gamma, proj_kind: str, proj_iters: int = 40,
                out: Optional[torch.Tensor] = None, shift=None, project=None):
    """Gvals-free per-slab forward pass: (x*, cᵀx, ‖x‖²).  `out` (n, w)
    receives x when given.

    `shift` is the coupling rows' contribution to u: a scalar (the
    all-ones rows' μ) or an (n, w) tensor (weighted rows, 0 on padding).
    For the kernel it is folded into c, and the kernel's cᵀx, which then
    includes the shift term, is corrected back, as the reference's kernel
    path does.  A kind with no kernel runs the plain sweep instead
    (through `project`, the slab's `ProjectionGraph`, when given); the
    route follows the kind alone.
    """
    if proj_kind not in kops.KERNEL_KINDS:
        return _plain_sweep(slab, lam, gamma, proj_kind, proj_iters, shift,
                            out, project)
    if shift is None:
        return kops.dual_x_full(slab, lam, gamma, proj_kind, proj_iters,
                                out=out)
    x, c_x, x_sq = kops.dual_x_full(
        slab._replace(c_vals=slab.c_vals + shift), lam, gamma, proj_kind,
        proj_iters, out=out)
    return x, c_x - _shift_term(shift, x), x_sq


def slab_xgvals(slab: Slab, lam, gamma, proj_kind: str, proj_iters: int = 40,
                shift=None, out: Optional[torch.Tensor] = None,
                gvals_out: Optional[torch.Tensor] = None, project=None):
    """Fused per-slab forward pass: (x*, gvals, cᵀx, ‖x‖²), kernel
    `dual_grad`.  `out` (n, w) and `gvals_out` (n, w, m) receive x and
    gvals when given.  `shift` and the route as in `slab_xcarry`; x, cᵀx
    and ‖x‖² are the x-carry sweep's bit for bit."""
    if proj_kind not in kops.KERNEL_KINDS:
        x, c_x, x_sq = _plain_sweep(slab, lam, gamma, proj_kind, proj_iters,
                                    shift, out, project)
        gvals = slab.a_vals * x[..., None]
        if gvals_out is not None:
            gvals_out.copy_(gvals)
            gvals = gvals_out
        return x, gvals, c_x, x_sq
    kslab = slab if shift is None else slab._replace(
        c_vals=slab.c_vals + shift)
    x, gvals, c_x, x_sq = kops.dual_grad_full(
        kslab, lam, gamma, proj_kind, proj_iters, out=out,
        gvals_out=gvals_out)
    if shift is not None:
        c_x = c_x - _shift_term(shift, x)
    return x, gvals, c_x, x_sq


def slab_xstar(slab: Slab, lam, gamma, proj_kind: str,
               proj_iters: int = 40) -> torch.Tensor:
    """x*(λ) for one slab: gather λ, form u, project.  Returns (n, w)."""
    return slab_xcarry(slab, lam, gamma, proj_kind, proj_iters)[0]


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
                        proj_iters: int = 40, ax_reducer=None):
    """g(λ), ∇g(λ), and diagnostics (functional scatter-mode entry point).

    `ax_reducer` is the distribution hook: it sums the locally computed
    (Ax, cᵀx, ‖x‖²) over the ranks that hold the other source rows (one
    all-reduce, `core.distributed`) before b is subtracted, once.  None
    means one shard."""
    J = lp.num_destinations
    ax = torch.zeros((lp.m, J), dtype=lam.dtype, device=lam.device)
    c_x = torch.zeros((), dtype=lam.dtype, device=lam.device)
    x_sq = torch.zeros((), dtype=lam.dtype, device=lam.device)
    for slab in lp.slabs:
        ax_s, c_s, sq_s = slab_contribution(slab, lam, gamma, J, proj_kind,
                                            proj_iters)
        ax, c_x, x_sq = ax + ax_s, c_x + c_s, x_sq + sq_s
    if ax_reducer is not None:
        ax, c_x, x_sq = ax_reducer((ax, c_x, x_sq))
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

    Slab i projects with `projection_map`'s kind and iteration count for
    block i, or with `proj_kind` and `proj_iters` when no map is given.
    The sweep writes each slab's x (and, in the gvals modes, its gvals)
    into a slice of one flat buffer in slab-concatenation order, allocated
    once here.  Each slice starts on a 16-byte boundary, and the plan's
    edge indices are mapped to that layout where it leaves gaps.

    `ax_reducer`, when given, sums the sweep's local (Ax, cᵀx, ‖x‖²) — and
    Σx in `GlobalCountObjective` — over the ranks that hold the other
    source rows, before b is subtracted (`core.distributed`).
    """

    def __init__(self, lp: LPData, projection_map=None,
                 proj_kind: str = "boxcut", proj_iters: int = 40,
                 ax_mode: str = "aligned", ax_plan: Optional[AxPlan] = None,
                 ax_reducer=None):
        if ax_mode not in AX_MODES:
            raise ValueError(f"ax_mode must be one of {AX_MODES}, got {ax_mode!r}")
        self.lp = lp
        self.ax_reducer = ax_reducer
        # each slab's (kind, iters): a ProjectionMap's default and its
        # per-bucket overrides (block id == slab index), or one kind for all
        pmap = (projection_map if projection_map is not None
                else projections.ProjectionMap(proj_kind, iters=proj_iters))
        self.proj_kind = pmap.kind
        self.proj_iters = pmap.iters
        self._slab_proj = tuple((pmap.kind_for(i), pmap.iters_for(i))
                                for i in range(len(lp.slabs)))
        self.ax_mode = ax_mode
        device = lp.b.device
        # the Ax plan, its edge map and its work table: one `ax_plan` span
        # of the thread's active recorder
        with current().span("ax_plan"):
            if ax_mode in ("aligned", "aligned_gvals"):
                carry = ax_mode == "aligned"
                if ax_plan is None:
                    # convert imports core
                    from ..convert import lp_to_numpy, plan_to_torch
                    ax_plan = plan_to_torch(build_ax_plan(
                        lp_to_numpy(lp), carry_values=carry), device)
                if carry and any(b.a_dm is None for b in ax_plan.buckets):
                    raise ValueError(
                        "ax_mode='aligned' (x-carry) needs a value-carrying "
                        "plan; rebuild with build_ax_plan(lp, "
                        "carry_values=True) or use ax_mode='aligned_gvals'")
            dtype = lp.slabs[0].c_vals.dtype if lp.slabs else torch.float32
            # each slab's slice of the flat buffers starts on a 16-byte
            # boundary, as the sweep kernels' vector stores need: the
            # slabs' concatenated edge space with a gap of at most 15 bytes
            # before a slab, which the plan's edge indices and the sorted
            # order follow
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
            # the Ax kernels' work table, built once a plan (on the card
            # only: the CPU's plain versions sum bucket by bucket)
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
        # on the card, the sweep projects each slab whose kind has no
        # kernel through a CUDA graph of its plain projection
        self._graphs = {
            i: ProjectionGraph(s, kind, iters)
            for i, (s, (kind, iters)) in enumerate(zip(lp.slabs,
                                                       self._slab_proj))
            if device.type == "cuda" and kind not in kops.KERNEL_KINDS
            and s.n * s.width}

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

    def _sweep_slab(self, i: int, lam, gamma, shift):
        """One slab of the sweep, its x (and gvals) written into the flat
        buffers: x-carry in `aligned`, gvals in the other modes.  Returns
        (x, cᵀx, ‖x‖²)."""
        slab = self.lp.slabs[i]
        kind, iters = self._slab_proj[i]
        xv, gv = self._views(i, slab)
        project = self._graphs.get(i)
        if gv is None:
            return slab_xcarry(slab, lam, gamma, kind, iters, out=xv,
                               shift=shift, project=project)
        x, _, c_s, sq_s = slab_xgvals(slab, lam, gamma, kind, iters,
                                      shift=shift, out=xv, gvals_out=gv,
                                      project=project)
        return x, c_s, sq_s

    def _forward(self, lam, gamma, shift=None, with_xsum: bool = False):
        """The slab sweep and the Ax reduction: (Ax, cᵀx, ‖x‖², Σx); Σx is
        0 unless `with_xsum`."""
        c_x = torch.zeros((), dtype=lam.dtype, device=lam.device)
        x_sq = torch.zeros((), dtype=lam.dtype, device=lam.device)
        x_sum = torch.zeros((), dtype=lam.dtype, device=lam.device)
        for i in range(len(self.lp.slabs)):
            x, c_s, sq_s = self._sweep_slab(i, lam, gamma, shift)
            c_x = c_x + c_s
            x_sq = x_sq + sq_s
            if with_xsum:
                x_sum = x_sum + x.float().sum()
        return self._reduce_ax().to(lam.dtype), c_x, x_sq, x_sum

    def calculate(self, lam, gamma):
        ax, c_x, x_sq, _ = self._forward(lam, gamma)
        if self.ax_reducer is not None:
            ax, c_x, x_sq = self.ax_reducer((ax, c_x, x_sq))
        grad = ax - self.lp.b
        g = c_x + 0.5 * gamma * x_sq + torch.sum(lam * grad)
        infeas = torch.linalg.vector_norm(torch.clamp_min(grad, 0.0))
        return g, grad, ObjectiveAux(primal_obj=c_x, x_sq=x_sq, ax=ax,
                                     infeas=infeas)

    def _dual_parts(self, lam):
        """Split a dual vector into (destination block λ, per-slab shift
        function): the hook every primal-recovery surface goes through, so
        subclasses with extra dual rows recover x* unchanged.  The function
        maps a slab index to that slab's coupling shift (None, a scalar, or
        an (n, w) tensor)."""
        return lam, lambda si: None

    def primal(self, lam, gamma):
        """The (padded) primal solution x*(λ), slab by slab."""
        lam_block, shift_fn = self._dual_parts(lam)
        return [slab_xcarry(s, lam_block, gamma, kind, iters,
                            shift=shift_fn(si))[0]
                for si, (s, (kind, iters)) in enumerate(
                    zip(self.lp.slabs, self._slab_proj))]

    def primal_rows(self, lam, gamma, slab_index: int, rows) -> torch.Tensor:
        """x*(λ) for a subset of one slab's source rows — the serving path.
        Every operation is row-local, so the result equals the matching
        rows of `primal` bit for bit."""
        lam_block, shift_fn = self._dual_parts(lam)
        slab = self.lp.slabs[slab_index]
        kind, iters = self._slab_proj[slab_index]
        rows = torch.as_tensor(rows, device=slab.c_vals.device).long()
        sub = Slab(*(leaf.index_select(0, rows) for leaf in slab))
        shift = shift_fn(slab_index)
        if shift is not None and torch.as_tensor(shift).ndim:
            shift = shift.index_select(0, rows)
        return slab_xcarry(sub, lam_block, gamma, kind, iters,
                           shift=shift)[0]


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
        shift = lam_flat[-1] * self.row_scale
        return lam_flat[:-1].reshape(m, J), lambda si: shift

    def calculate(self, lam_flat, gamma):
        lam, shift_fn = self._dual_parts(lam_flat)
        shift = shift_fn(0)
        mu = lam_flat[-1]
        ax, c_x, x_sq, x_sum = self._forward(lam, gamma, shift=shift,
                                             with_xsum=True)
        if self.ax_reducer is not None:
            ax, c_x, x_sq, x_sum = self.ax_reducer((ax, c_x, x_sq, x_sum))
        grad_main = ax - self.lp.b
        grad_cnt = self.row_scale * (x_sum - self.count)
        g = (c_x + 0.5 * gamma * x_sq + torch.sum(lam * grad_main)
             + mu * grad_cnt)
        grad = torch.cat([grad_main.reshape(-1), grad_cnt.reshape(1)])
        infeas = torch.linalg.vector_norm(torch.clamp_min(grad, 0.0))
        return g, grad, ObjectiveAux(primal_obj=c_x, x_sq=x_sq, ax=ax,
                                     infeas=infeas)
