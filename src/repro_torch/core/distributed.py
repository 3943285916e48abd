"""Distributed dual ascent over `torch.distributed` ranks — the paper's §6
pattern; port of `repro.core.distributed`.

  paper (PyTorch/NCCL)       reference (JAX SPMD)          this port
  columns of 𝒯 per GPU       slab rows sharded on a mesh   each rank keeps its
                                                           row block of every slab
  λ, b replicated            λ, b replicated (or λ on      the same; λ's J columns
                             "model")                      split over the λ axis
  reduce(SUM) of ∇g          psum of (Ax, cᵀx, ‖x‖²)       ONE all_reduce of one
                                                           flat buffer, m·J + 2
                                                           floats
  rank-0 update, 2 bcasts    replicated update             replicated update

Every rank runs the same update on the same all-reduced bits (ring
all-reduce in NCCL and gloo gives every rank the same result), so no
broadcast exists.  The engine's host decisions are made common with one
small collective a chunk (`maximizer.SolveEngine`, `agree`).

λ-sharded mode (`lambda_axis`, for m·J too large to replicate): each rank
holds λ's columns of its coordinate on the λ axis, gathers λ before the
sweep, reduce-scatters (Ax, cᵀx, ‖x‖²) back over that axis and
all-reduces them over the other source axes; ⟨λ, ∇g⟩, ‖(∇g)₊‖² and the
update rule's reductions (`ShardedDualReduce`) sum over the λ axis.  A λ
axis of one rank holds all of λ, and runs as the replicated mode.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .instance import build_sharded_ax_plan
from .maximizer import maximize
from .objectives import MatchingObjective, ObjectiveAux
from .types import (HealthConfig, LPData, Slab, SolveConfig, SolveResult,
                    SolveState, StoppingCriteria)
from .update_rules import LOCAL, DualReduce

DISTRIBUTED_AX_MODES = ("scatter", "aligned", "aligned_gvals")


def _reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """Sum `inp` over the group and keep this rank's slice in `out`
    (`reduce_scatter_single` where the installed PyTorch has it)."""
    fn = getattr(dist, "reduce_scatter_single", None)
    (fn or dist.reduce_scatter_tensor)(out, inp, group=group)


def _all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """Concatenate every rank's flat `inp` in rank order into flat `out`
    (`all_gather_single` where the installed PyTorch has it)."""
    fn = getattr(dist, "all_gather_single", None)
    (fn or dist.all_gather_into_tensor)(out, inp, group=group)


def _row_block(t: torch.Tensor, k: int, n: int) -> torch.Tensor:
    rows = t.shape[0] // n
    return t[k * rows:(k + 1) * rows]


def _col_block(t: torch.Tensor, k: int, n: int) -> torch.Tensor:
    cols = t.shape[1] // n
    return t[:, k * cols:(k + 1) * cols].contiguous()


def pad_slab_rows(slab: Slab, multiple: int) -> Slab:
    """Pad a slab's row count to a multiple: padded rows are masked out
    (mask False, ub 0, s 1, source_ids −1) and add nothing."""
    n = slab.n
    extra = -(-n // multiple) * multiple - n
    if extra == 0:
        return slab

    def pad(a, fill=0):
        tail = torch.full((extra, *a.shape[1:]), fill, dtype=a.dtype,
                          device=a.device)
        return torch.cat([a, tail])

    return Slab(a_vals=pad(slab.a_vals), c_vals=pad(slab.c_vals),
                dest_idx=pad(slab.dest_idx), mask=pad(slab.mask),
                ub=pad(slab.ub), s=pad(slab.s, 1.0),
                source_ids=pad(slab.source_ids, -1))


def pad_for_sharding(lp: LPData, num_shards: int) -> LPData:
    return LPData(slabs=tuple(pad_slab_rows(s, num_shards)
                              for s in lp.slabs), b=lp.b)


def place_lp(lp: LPData, grid, source_axes: Sequence[str],
             lambda_axis: Optional[str] = None, device=None) -> LPData:
    """This rank's part of the LP on `device` (default: the LP's): every
    slab padded to a multiple of the source shards, then the rank's row
    block of it (the block index is its row-major coordinate over the
    source axes, the order of `PartitionSpec(source_axes)`), and b, of
    which λ-sharded mode keeps the rank's J columns on the λ axis."""
    n, k = grid.size(source_axes), grid.index(source_axes)
    lp = pad_for_sharding(lp, n)
    device = lp.b.device if device is None else torch.device(device)
    b = lp.b
    if lambda_axis is not None:
        b = _col_block(b, grid.index((lambda_axis,)),
                       grid.size((lambda_axis,)))
    return LPData(slabs=tuple(Slab(*(_row_block(leaf, k, n).to(device)
                                     for leaf in s)) for s in lp.slabs),
                  b=b.to(device))


class ShardedDualReduce(DualReduce):
    """The update rule's reductions over a dual whose J columns are split
    over the λ axis: each rank's partial sum, all-reduced over the axis,
    so that every rank takes the same step."""

    def __init__(self, group, shards: int):
        self.group = group
        self.shards = shards

    def _sum(self, partial: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(partial, group=self.group)
        return partial

    def norm(self, a):
        return torch.sqrt(self._sum(torch.sum(a * a)))

    def dot(self, a, b):
        return self._sum(torch.sum(a * b))

    def mean(self, a):
        return self._sum(torch.sum(a)) / (a.numel() * self.shards)


class DistributedMatchingObjective:
    """The matching objective over this rank's row block of the LP.

    `lp` is the whole LP on the host (every rank generates and
    preconditions it, as the reference does); the rank keeps its block on
    `device` (`place_lp`) and evaluates it with its own `MatchingObjective`
    (`local`) over its shard's plan (`build_sharded_ax_plan`, widths
    shared by every shard).  The only communication of an evaluation is
    one all_reduce of (Ax, cᵀx, ‖x‖²) in one flat buffer through the
    objective's `ax_reducer`, or in λ-sharded mode the gather of λ and the
    reduce-scatter of that buffer.  `ax_mode` is "scatter", "aligned" or
    "aligned_gvals" (a sorted permutation would cross shards).

    `calculate`, `dual_shape`, the solve's λ and state are the rank's own:
    λ whole, or its J columns in λ-sharded mode; `gather_lam` /
    `shard_lam` and `gather_state` / `shard_state` map them to and from
    the whole.
    """

    def __init__(self, lp: LPData, grid,
                 source_axes: Optional[Sequence[str]] = None,
                 proj_kind: str = "boxcut", proj_iters: int = 40,
                 lambda_axis: Optional[str] = None,
                 ax_mode: str = "scatter", device=None):
        if ax_mode not in DISTRIBUTED_AX_MODES:
            raise ValueError(f"distributed ax_mode is one of "
                             f"{DISTRIBUTED_AX_MODES}, got {ax_mode!r}")
        source_axes = (tuple(grid.axes) if source_axes is None
                       else tuple(source_axes))
        J = lp.num_destinations
        if lambda_axis is not None:
            if lambda_axis not in source_axes:
                raise ValueError(
                    "λ-sharded mode requires the λ axis to also partition "
                    "sources; pass source_axes containing lambda_axis")
            if J % grid.size((lambda_axis,)):
                raise ValueError(
                    f"J = {J} destinations do not split over the "
                    f"{grid.size((lambda_axis,))} ranks of the λ axis "
                    f"{lambda_axis!r}")
        self.grid = grid
        self.source_axes = source_axes
        self.lambda_axis = lambda_axis
        self.ax_mode = ax_mode
        shards, k = grid.size(source_axes), grid.index(source_axes)
        padded = pad_for_sharding(lp, shards)
        self.lp = place_lp(padded, grid, source_axes, lambda_axis, device)
        device = self.lp.b.device
        self._shards = grid.size((lambda_axis,)) if lambda_axis else 1
        sharded = self._shards > 1
        self._lam_group = grid.group((lambda_axis,)) if sharded else None
        other = tuple(a for a in source_axes if a != lambda_axis)
        self._other_group = (grid.group(other) if sharded
                             and grid.size(other) > 1 else None)
        self._group = group = grid.group(source_axes)
        self.world = dist.get_world_size() if grid.groups else 1
        plan = None
        if ax_mode != "scatter":
            from ..convert import lp_to_numpy, plan_to_torch  # convert imports core
            plan = plan_to_torch(build_sharded_ax_plan(
                lp_to_numpy(padded), shards,
                carry_values=ax_mode == "aligned", shard=k), device)
        # λ-sharded, the sweep still forms the whole (m, J) Ax before the
        # reduce-scatter: its objective sees J through a b of zero strides,
        # and `calculate` subtracts the rank's columns of b itself
        b = (self.lp.b.new_zeros(()).expand(lp.m, J) if sharded
             else self.lp.b)
        self.local = MatchingObjective(
            LPData(slabs=self.lp.slabs, b=b), proj_kind=proj_kind,
            proj_iters=proj_iters, ax_mode=ax_mode, ax_plan=plan,
            ax_reducer=(self._all_reduce if group is not None
                        and not sharded else None))
        self.dual_reduce: DualReduce = (
            ShardedDualReduce(self._lam_group, self._shards) if sharded
            else LOCAL)
        self._full_shape = (lp.m, J)
        # NCCL brings a group's communicator up at its first collective:
        # here, in set-up, rather than in the solve's first step (in one
        # order on every rank)
        for g in (group, self._lam_group, self._other_group):
            if g is not None:
                dist.all_reduce(torch.zeros(1, device=device), group=g)

    @property
    def dual_shape(self) -> Tuple[int, int]:
        m, J = self._full_shape
        return (m, J // self._shards)

    def _all_reduce(self, parts):
        """The `ax_reducer`: one all_reduce over the source axes of (Ax,
        cᵀx, ‖x‖²) packed in one flat buffer of m·J + 2 floats.  NCCL runs
        it after the work already on the current stream, so after the
        whole sweep; over one rank it is a copy, and the bits are the
        single-device objective's."""
        ax, *scalars = parts
        n = ax.numel()
        buf = torch.cat([ax.reshape(-1), torch.stack(scalars)])
        dist.all_reduce(buf, group=self._group)
        return (buf[:n].view_as(ax), *buf[n:].unbind())

    def _reduce_scatter_parts(self, ax, c_x, x_sq):
        """λ-sharded: sum (Ax, cᵀx, ‖x‖²) over the λ axis keeping the
        rank's J columns of Ax (one reduce-scatter of L chunks, each its
        columns of Ax and both scalars), then over the other source
        axes."""
        m, J = ax.shape
        L, cols = self._shards, J // self._shards
        chunks = ax.reshape(m, L, cols).transpose(0, 1).reshape(L, m * cols)
        scalars = torch.stack([c_x, x_sq]).expand(L, 2)
        buf = torch.cat([chunks, scalars], dim=1).reshape(-1)
        out = torch.empty(m * cols + 2, dtype=ax.dtype, device=ax.device)
        _reduce_scatter(out, buf, self._lam_group)
        if self._other_group is not None:
            dist.all_reduce(out, group=self._other_group)
        return out[:m * cols].view(m, cols), out[-2], out[-1]

    def gather_lam(self, lam: torch.Tensor) -> torch.Tensor:
        """The whole λ from every rank's columns (λ-sharded), else λ."""
        if self._lam_group is None:
            return lam
        m, cols = lam.shape
        out = torch.empty(self._shards * m * cols, dtype=lam.dtype,
                          device=lam.device)
        _all_gather(out, lam.contiguous().reshape(-1), self._lam_group)
        return (out.view(self._shards, m, cols).transpose(0, 1)
                .reshape(m, self._shards * cols))

    def shard_lam(self, lam: torch.Tensor) -> torch.Tensor:
        """This rank's columns of the whole λ (λ-sharded), else λ."""
        if self._lam_group is None:
            return lam
        return _col_block(lam, self.grid.index((self.lambda_axis,)),
                          self._shards)

    def _map_dual(self, state: SolveState, fn, shape) -> SolveState:
        def leaf(t):
            return fn(t) if tuple(t.shape) == tuple(shape) else t
        extra = state.extra
        if extra:
            extra = type(extra)(*(leaf(t) for t in extra))
        return SolveState(*(leaf(t) for t in state[:-1]), extra=extra)

    def gather_state(self, state: SolveState) -> SolveState:
        """The solver state with every λ-shaped leaf whole (λ-sharded: one
        all_gather each, a collective every rank must call)."""
        if self._lam_group is None:
            return state
        return self._map_dual(state, self.gather_lam, self.dual_shape)

    def shard_state(self, state: SolveState) -> SolveState:
        """This rank's part of a whole solver state (a restored
        checkpoint)."""
        if self._lam_group is None:
            return state
        return self._map_dual(state, self.shard_lam, self._full_shape)

    def calculate(self, lam, gamma):
        if self._lam_group is None:
            return self.local.calculate(lam, gamma)
        ax, c_x, x_sq, _ = self.local._forward(self.gather_lam(lam), gamma)
        ax, c_x, x_sq = self._reduce_scatter_parts(ax, c_x, x_sq)
        grad = ax - self.lp.b
        sums = torch.stack([torch.sum(lam * grad),
                            torch.sum(torch.clamp_min(grad, 0.0) ** 2)])
        dist.all_reduce(sums, group=self._lam_group)
        g = c_x + 0.5 * gamma * x_sq + sums[0]
        return g, grad, ObjectiveAux(primal_obj=c_x, x_sq=x_sq, ax=ax,
                                     infeas=torch.sqrt(sums[1]))

    def primal(self, lam, gamma):
        """x*(λ) of this rank's row block, slab by slab (rows that
        `pad_for_sharding` added come back masked out, source_ids −1).
        Row-local, so no collective, except that this rank's columns of λ
        in λ-sharded mode are gathered first; the whole λ is taken as
        it is."""
        if self._lam_group is not None and tuple(lam.shape) == self.dual_shape:
            lam = self.gather_lam(lam)
        return self.local.primal(lam, gamma)

    def agree(self, flags: Sequence[bool]):
        """The engine's chunk-boundary flags made common: a MAX over every
        rank, in one small all_reduce (None on one rank: nothing to
        agree)."""
        t = torch.tensor([float(bool(f)) for f in flags], device=self.lp.b.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return [bool(v) for v in t.tolist()]

    def infeas_scale(self, criteria: Optional[StoppingCriteria]) -> float:
        """1 + ‖b‖₂ of the whole b, for the relative infeasibility rule."""
        if criteria is None or criteria.tol_infeas_rel is None:
            return 1.0
        return 1.0 + float(self.dual_reduce.norm(self.lp.b))

    def solve(self, config: SolveConfig, algorithm: str = "agd",
              lam0: Optional[torch.Tensor] = None,
              criteria: Optional[StoppingCriteria] = None,
              diagnostics_fn: Optional[Callable] = None,
              health: Optional[HealthConfig] = None,
              checkpoint_fn: Optional[Callable] = None,
              preempt_fn: Optional[Callable] = None,
              initial_state: Optional[SolveState] = None,
              resume_meta: Optional[dict] = None,
              telemetry=None, profiler=None, sampler=None) -> SolveResult:
        """The port's `maximize` over this objective on every rank.
        `lam0` and `initial_state` are whole, `initial_state` on this
        rank's device (every rank keeps its part);
        `checkpoint_fn` gets the whole state, and the result's λ and final
        state are whole.  Rank 0 alone records: every other rank runs with
        the telemetry disabled, no sampler (it reads the host only and
        makes no collective) and, where a profiler is given, one that
        records nothing but chunks the loop as rank 0's does; give every
        rank the same `profiler` or none."""
        if dist.is_initialized() and dist.get_rank() != 0:
            telemetry = sampler = None
            profiler = None if profiler is None else _Unrecorded()
        device = self.lp.b.device
        lam0 = (torch.zeros(self._full_shape, dtype=torch.float32,
                            device=device) if lam0 is None
                else lam0.to(device))
        if initial_state is not None:
            initial_state = self.shard_state(initial_state)
        checkpoint = None
        if checkpoint_fn is not None:
            def checkpoint(it, state, meta):
                checkpoint_fn(it, self.gather_state(state), meta)
        res = maximize(self.calculate, self.shard_lam(lam0), config,
                       algorithm, criteria=criteria,
                       diagnostics_fn=diagnostics_fn,
                       infeas_scale=self.infeas_scale(criteria),
                       health=health, checkpoint_fn=checkpoint,
                       preempt_fn=preempt_fn, initial_state=initial_state,
                       resume_meta=resume_meta, reduce=self.dual_reduce,
                       agree=self.agree if self.world > 1 else None,
                       telemetry=telemetry, profiler=profiler,
                       sampler=sampler)
        final = res.final_state
        return res._replace(
            lam=self.gather_lam(res.lam),
            final_state=None if final is None else self.gather_state(final))


class _Unrecorded:
    """A profiler for the ranks other than 0: a profiler makes the engine
    run chunked, and every rank must chunk alike or their chunk-boundary
    collectives would not pair up; this one records nothing."""

    def chunk_start(self, *args, **kw):
        pass

    def chunk_end(self, *args, **kw):
        pass

    def stop(self, *args, **kw):
        pass


def solve_distributed(
    lp: LPData,
    config: SolveConfig,
    grid,
    source_axes: Optional[Sequence[str]] = None,
    lambda_axis: Optional[str] = None,
    algorithm: str = "agd",
    lam0: Optional[torch.Tensor] = None,
    ax_mode: str = "scatter",
    criteria: Optional[StoppingCriteria] = None,
    diagnostics_fn: Optional[Callable] = None,
    health: Optional[HealthConfig] = None,
    checkpoint_fn: Optional[Callable] = None,
    preempt_fn: Optional[Callable] = None,
    initial_state: Optional[SolveState] = None,
    resume_meta: Optional[dict] = None,
    device=None,
    telemetry=None,
    profiler=None,
    sampler=None,
) -> SolveResult:
    """End-to-end distributed solve on every rank of `grid`: place the
    data, build the objective, maximize (`DistributedMatchingObjective` and
    its `solve`; a caller that needs the objective afterwards, as the CLI
    does for the certificate, takes the two steps itself).  `lp` is the
    whole LP on the host (each rank's copy); `source_axes` defaults to
    every axis of the grid (the paper partitions sources over every GPU);
    `device` to the LP's.  The result's λ and final state are whole.
    `telemetry`, `profiler` and `sampler` record on rank 0 alone."""
    obj = DistributedMatchingObjective(
        lp, grid, source_axes=source_axes, proj_kind=config.projection,
        lambda_axis=lambda_axis, ax_mode=ax_mode, device=device)
    return obj.solve(config, algorithm, lam0=lam0, criteria=criteria,
                     diagnostics_fn=diagnostics_fn, health=health,
                     checkpoint_fn=checkpoint_fn, preempt_fn=preempt_fn,
                     initial_state=initial_state, resume_meta=resume_meta,
                     telemetry=telemetry, profiler=profiler, sampler=sampler)
