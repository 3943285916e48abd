"""Launch-shape byte census of the solver: the bytes, operations and
collective bytes of one dual evaluation (one `calculate`, what an agd
iteration runs once), reckoned from the objective's slab shapes, dtypes,
masks and Ax plan, kernel by kernel as the evaluation launches them.

The counterpart of `repro.launch.hlo_cost` (and of the reference CLI's
`attach_byte_census`) for the port.  No compiled program exists to read
here, so the count follows what the evaluation launches, and it counts
the same work whatever implements it: each input a function needs is
read once and each output written once.

  dual_x_slab     K1, a slab whose kind has a kernel, `aligned`:
                  real·(m·a + c + 4 dest + ub) + padded·(1 mask + x)
                  + rows·s, and 4·m·J for λ once a sweep
  dual_grad_slab  K3, the same in the gvals modes, + padded·m·a gvals
  plain_sweep     a simplex_eq / boxcut_newton slab (no kernel): the
                  plain sweep reads every padded entry,
                  padded·(m·a + c + 4 + 1 + ub + x) + rows·s, and λ once
  ax_reduce_plan_x  K2: real·(m·a + 4 idx + x) + entries·1 mask
                  + rows·4 dest + 4·m·J out
  ax_reduce_plan  K4: real·(m·g + 4 idx) + entries + rows·4 + 4·m·J
  scatter_ax      `scatter`'s `index_add_`: E·(m·g + 8 dest) + 4·m·J
  sorted_ax       `sorted`'s gather and segment sum: real·(m·g + 8
                  perm) + 8·J lengths + 4·m·J
  shift_fold      the coupling rows' shift folded into c before the
                  kernel (c + shift written, read back by it) and taken
                  back out of cᵀx: padded·(3·c + 2·shift), shift 0 bytes
                  when scalar; a weighted row's shift is formed first
                  (padded·(w + 4) a row)
  row_sums        the coupling rows' Σ w·x: padded·(w + x) a row
  dual_tail       grad = Ax − b, ⟨λ, grad⟩, ‖(grad)₊‖: 4·m·J·4

E is the flat buffer's length, entries the plan's padded entries, real
the masked-in ones; a, c, ub, s, x, g are their element sizes.  The
operations are float32 operations at the projection's fixed iteration
count (K1/K3: 4 a bisection step at every real entry, 4 + 7 + m an edge
outside the loop, + m for gvals; K2: 2·m a real entry; K4 and the sums:
m), so they bound what an early exit does from above.  Under ranks
`collective_bytes_per_iteration` counts each collective's input buffer
on this rank: the all-reduce of (Ax, cᵀx, ‖x‖²), m·J + 2 floats;
λ-sharded, the gather of λ, the reduce-scatter and the sums.

The count reads each mask's sum, one device reduction a slab and a
bucket: call it outside a timed loop.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from ..core.objectives import GlobalCountObjective
from ..kernels.ops import KERNEL_KINDS

__all__ = ["SlabCounts", "PlanCounts", "slab_counts", "plan_counts",
           "sweep_bytes", "ax_bytes", "evaluation_census", "runner_memory",
           "collective_kinds"]

# float32 operations of K1's function: 4 a bisection step at a real entry,
# 4 an entry outside the loop (f0 and max v), 7 a real edge (u, the clip,
# the c·x and x·x partials), + m multiply-adds forming u (+ m for gvals)
OPS_A_STEP, OPS_ENTRY, OPS_REAL = 4, 4, 7


class SlabCounts(NamedTuple):
    """What the sweep's byte count reads of a set of slabs: real (masked
    in) edges, padded entries, rows, and the element sizes of a, c, ub
    and s."""

    real: int
    padded: int
    rows: int
    ea: int
    ec: int
    eu: int
    es: int


class PlanCounts(NamedTuple):
    """What the Ax kernels read of a plan: real entries, padded entries,
    rows (one dest id each), and a_dm's element size (0 without)."""

    real: int
    entries: int
    rows: int
    ea: int


def slab_counts(slabs) -> SlabCounts:
    slabs = tuple(slabs)
    if not slabs:
        return SlabCounts(0, 0, 0, 4, 4, 4, 4)
    s0 = slabs[0]
    return SlabCounts(
        real=sum(int(s.mask.sum()) for s in slabs),
        padded=sum(s.n * s.width for s in slabs),
        rows=sum(s.n for s in slabs),
        ea=s0.a_vals.element_size(), ec=s0.c_vals.element_size(),
        eu=s0.ub.element_size(), es=s0.s.element_size())


def plan_counts(plan) -> PlanCounts:
    b0 = plan.buckets[0]
    return PlanCounts(
        real=sum(int(b.mask.sum()) for b in plan.buckets),
        entries=sum(b.mask.numel() for b in plan.buckets),
        rows=sum(b.dest_ids.numel() for b in plan.buckets),
        ea=0 if b0.a_dm is None else b0.a_dm.element_size())


def sweep_bytes(c: SlabCounts, m: int, J: int, gvals: bool = False) -> int:
    """K1's (K3's with `gvals`) bytes over slabs of counts `c` in one
    sweep: a, c, dest and ub at the real edges (the kernels read them only
    where the mask is set), the mask over every padded entry, s a row, λ
    once, x (and gvals) written over every padded entry."""
    nbytes = (c.real * (c.ea * m + c.ec + 4 + c.eu) + c.padded
              + c.rows * c.es + m * J * 4 + c.padded * c.ec)
    if gvals:
        nbytes += c.padded * c.ea * m
    return nbytes


def ax_bytes(p: PlanCounts, m: int, J: int, src_elem: int,
             carry: bool) -> int:
    """K2's (`carry`: a_dm and the x gather) or K4's (the m gvals) bytes
    over a plan of counts `p`: edge_idx and the source at the real entries
    (the kernels skip masked ones), the mask over every entry, one dest id
    a row, the (m, J) result written once.  `src_elem` is x's or gvals'
    element size."""
    per_real = (p.ea * m + 4 + src_elem) if carry else (src_elem * m + 4)
    return p.real * per_real + p.entries + p.rows * 4 + m * J * 4


def _sweep_ops(real: int, m: int, iters: int, gvals: bool) -> int:
    return real * (OPS_A_STEP * iters + OPS_ENTRY + OPS_REAL + m
                   + (m if gvals else 0))


def _add(out: Dict[str, Dict[str, int]], name: str, nbytes: int,
         flops: int) -> None:
    row = out.setdefault(name, {"bytes": 0, "flops": 0})
    row["bytes"] += int(nbytes)
    row["flops"] += int(flops)


def _shift_rows(obj):
    """The objective's coupling rows as (weights or None, scale) pairs:
    none for matching, one all-ones row for `GlobalCountObjective`, a
    composed objective's rows (each folds its shift into the sweep)."""
    if isinstance(obj, GlobalCountObjective):
        return ((None, obj.row_scale),)
    return tuple(zip(getattr(obj, "_global_weights", ()),
                     getattr(obj, "_scales", ())))


def _local_census(obj) -> Dict[str, Dict[str, int]]:
    """Per-kernel {bytes, flops} of one evaluation of a MatchingObjective
    (or a subclass with coupling rows) on this device."""
    lp = obj.lp
    m, J = lp.m, lp.num_destinations
    mode = obj.ax_mode
    gvals = mode != "aligned"
    out: Dict[str, Dict[str, int]] = {}
    kernel = [s for s, (kind, _) in zip(lp.slabs, obj._slab_proj)
              if kind in KERNEL_KINDS]
    plain = [(s, it) for s, (kind, it) in zip(lp.slabs, obj._slab_proj)
             if kind not in KERNEL_KINDS]
    if kernel:
        c = slab_counts(kernel)
        iters = [it for (kind, it) in obj._slab_proj if kind in KERNEL_KINDS]
        flops = sum(_sweep_ops(int(s.mask.sum()), m, it, gvals)
                    for s, it in zip(kernel, iters))
        _add(out, "dual_grad_slab" if gvals else "dual_x_slab",
             sweep_bytes(c, m, J, gvals), flops)
    if plain:
        c = slab_counts(s for s, _ in plain)
        nbytes = (c.padded * (c.ea * m + c.ec + 4 + 1 + c.eu + c.ec)
                  + c.rows * c.es + m * J * 4)
        if gvals:
            nbytes += c.padded * c.ea * m
        flops = sum(s.n * s.width * (OPS_A_STEP * it + 2 * m + OPS_REAL)
                    for s, it in plain)
        _add(out, "plain_sweep", nbytes, flops)
    rows = _shift_rows(obj)
    if rows:
        sl = slab_counts(lp.slabs)
        weighted = [w for w, _ in rows if w is not None]
        es = 4 if weighted else 0            # a tensor shift is float32
        fold = sl.padded * (3 * sl.ec + 2 * es)
        fold += sum(sum(t.numel() * t.element_size() for t in w)
                    + sl.padded * 4 for w in weighted)
        _add(out, "shift_fold", fold, sl.padded * (2 + 2 * len(weighted)))
        sums = sum(sl.padded * sl.ec + (0 if w is None else
                                        sum(t.numel() * t.element_size()
                                            for t in w))
                   for w, _ in rows)
        _add(out, "row_sums", sums, sl.padded * 2 * len(rows))
    E = obj._xbuf.numel()
    if mode == "aligned":
        p = plan_counts(obj._plan)
        _add(out, "ax_reduce_plan_x",
             ax_bytes(p, m, J, obj._xbuf.element_size(), carry=True),
             2 * m * p.real)
    elif mode == "aligned_gvals":
        p = plan_counts(obj._plan)
        _add(out, "ax_reduce_plan",
             ax_bytes(p, m, J, obj._gbuf.element_size(), carry=False),
             m * p.real)
    elif mode == "scatter":
        _add(out, "scatter_ax",
             E * (m * obj._gbuf.element_size() + 8) + m * J * 4, m * E)
    else:
        real = obj._perm.numel()
        _add(out, "sorted_ax",
             real * (m * obj._gbuf.element_size() + 8) + 8 * J + m * J * 4,
             m * real)
    _add(out, "dual_tail", 4 * m * J * 4, 5 * m * J)
    return out


def collective_kinds(obj, local=None) -> Dict[str, int]:
    """The input bytes of the collectives one evaluation makes on this
    rank, by kind ("all-reduce", "all-gather", "reduce-scatter"); all 0
    on one device with no process group."""
    if local is None:
        obj, local = _objectives(obj)
    m, J = local.lp.m, local.lp.num_destinations
    extra = len(_shift_rows(local))
    out = {"all-reduce": 0, "all-gather": 0, "reduce-scatter": 0}
    if local.ax_reducer is not None:
        out["all-reduce"] += (m * J + 2 + extra) * 4
    if obj is not local and getattr(obj, "_lam_group", None) is not None:
        L = obj._shards
        cols = J // L
        out["all-gather"] += m * cols * 4             # λ's columns
        out["reduce-scatter"] += L * (m * cols + 2) * 4
        if obj._other_group is not None:
            out["all-reduce"] += (m * cols + 2) * 4
        out["all-reduce"] += 2 * 4        # ⟨λ, grad⟩ and ‖(grad)₊‖²
    return out


def _collective_bytes(obj, local) -> int:
    """The input bytes of the collectives one evaluation makes on this
    rank (0 on one device with no process group)."""
    return sum(collective_kinds(obj, local).values())


def _objectives(obj):
    """(the objective `calculate` runs on, its local MatchingObjective),
    or None for an objective the census does not know."""
    local = getattr(obj, "local", obj)
    needed = ("lp", "ax_mode", "_slab_proj", "_xbuf", "ax_reducer")
    if not all(hasattr(local, k) for k in needed):
        return None
    return obj, local


def evaluation_census(obj) -> Optional[Dict[str, Any]]:
    """One evaluation's census (module doc): ``flops_per_iteration``,
    ``bytes_per_iteration``, ``collective_bytes_per_iteration``, and
    ``kernels``, {name: {"bytes", "flops"}} in launch order.  `obj` is a
    `MatchingObjective` (any ax mode, any subclass with coupling rows) or
    a `DistributedMatchingObjective` (this rank's part).  None for an
    objective it does not know."""
    pair = _objectives(obj)
    if pair is None:
        return None
    obj, local = pair
    kernels = _local_census(local)
    return {
        "flops_per_iteration": sum(k["flops"] for k in kernels.values()),
        "bytes_per_iteration": sum(k["bytes"] for k in kernels.values()),
        "collective_bytes_per_iteration": _collective_bytes(obj, local),
        "kernels": kernels,
        "ax_mode": local.ax_mode,
    }


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages behind `tensors` (a view or an
    expanded tensor counts its storage once)."""
    seen, total = set(), 0
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            continue
        st = t.untyped_storage()
        key = (st.data_ptr(), st.nbytes())
        if key not in seen:
            seen.add(key)
            total += st.nbytes()
    return total


def _leaves(x):
    """Every tensor inside nested tuples / NamedTuples."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _leaves(v)


def runner_memory(obj, state, length: int = 1) -> Optional[Dict[str, Any]]:
    """A chunk runner's memory from tensor shapes alone (no device read):
    ``argument_bytes`` the LP, the Ax plan and its work table and the
    solver state; ``output_bytes`` the new state and the (6, length)
    stats; ``temp_bytes`` the evaluation's flat x / gvals buffers and
    index tables and its (m, J) scratch (Ax, the gradient).
    ``source="launch_census"``.  None for an objective the census does
    not know (a bare function)."""
    pair = _objectives(obj)
    if pair is None:
        return None
    obj, local = pair
    lp = local.lp
    plan = local._plan
    work = getattr(local, "_work", None)
    args = list(_leaves(tuple(lp.slabs))) + [lp.b]
    if plan is not None:
        args += list(_leaves(tuple(plan.buckets)))
    if work is not None:
        args += [work.items, work.item_dest, work.multi]
    state_bytes = _storage_bytes(_leaves(tuple(state)))
    temps = [getattr(local, k, None)
             for k in ("_xbuf", "_gbuf", "_flat_dest", "_perm", "_lengths")]
    m, J = lp.m, lp.num_destinations
    return {"argument_bytes": _storage_bytes(args) + state_bytes,
            "output_bytes": state_bytes + 6 * int(length) * 4,
            "temp_bytes": _storage_bytes(temps) + 2 * m * J * 4,
            "source": "launch_census"}
