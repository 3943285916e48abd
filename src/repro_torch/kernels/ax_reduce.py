"""The Ax reduction of an AxPlan: the wrappers of the `ax_reduce_x` (K2)
and `ax_reduce` (K4) kernels, and the work table they run on.

Ports of `repro.kernels.ax_reduce.ax_reduce_bucket_x` (value-carrying)
and `ax_reduce_bucket` (gvals-consuming):

    K2  ax[k, dest_ids[r]] = Σ_q mask[r, q] · a_dm[r, q, k] · x[edge_idx[r, q]]
    K4  ax[k, dest_ids[r]] = Σ_q mask[r, q] · gvals[edge_idx[r, q], k]

Every destination owns exactly one plan row, so the result goes straight
into the columns `dest_ids` of the caller's (m, J) float32 buffer; the
reference's row concatenation and `inv_perm` gather are not needed.

On the card one Ax is one launch over every bucket of the plan (plus a
fixed-order second pass), driven by the plan's work table (`plan_work`):
each row's extent, its last set mask entry plus one, cut into items of
at most `ITEM_ENTRIES` entries and at the bands of `BAND_ENTRIES` edges,
run band by band so that the gathers in flight hit one band of x.  `ax_reduce_plan_x`
and `ax_reduce_plan` take a whole plan; `ax_reduce_bucket_x` and
`ax_reduce_bucket` run the same kernel over one bucket.  For tensors on
the card they launch `csrc/ax_reduce_x.cu` and `csrc/ax_reduce.cu` (one
body, `csrc/ax_rows.cuh`); for tensors on the CPU they run the plain
versions `ref.ax_reduce_x_ref` and `ref.ax_reduce_ref`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from ..core.types import AxBucket
from . import _build
from .ref import ax_reduce_ref, ax_reduce_x_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# C: the most entries one item (one warp's work) holds; a multiple of the
# kernel's 256-entry tile
ITEM_ENTRIES = 2048
# the edges of x (or rows of gvals) one band of the table holds: 16 MB of
# float32 x, a third of the H100's L2
BAND_ENTRIES = 1 << 22


class AxWork(NamedTuple):
    """The work table of one plan, on the plan's device.

    items (n, 4) int32: (bucket, row, q0, q1), the entries [q0, q1) of one
    row; item_dest (n,) int32: the destination column j the item stores to
    when it is its row's only item, else -1 - p for the p-th partial;
    multi (n_multi, 3) int32: (j, p0, p1) for each row of several items,
    whose partials p0..p1-1 the second pass sums in item order.  `buckets`
    is what the kernel reads of the plan's buckets, checked once.
    """

    items: torch.Tensor
    item_dest: torch.Tensor
    multi: torch.Tensor
    num_partials: int
    item_entries: int
    buckets: Optional["_Buckets"] = None


class _Buckets:
    """A plan's buckets as the kernel takes them, checked once a table:
    contiguous int32 edge_idx and bool mask (r, w), int32 dest_ids (r,),
    a_dm (r, w, m) of one type in every bucket or in none, all on one
    device, no negative index; the ctypes arrays of their pointers and
    widths, and the edges and destinations they reach."""

    def __init__(self, buckets: Sequence[AxBucket]):
        fn = "plan_work"
        self.device = buckets[0].edge_idx.device
        a0 = buckets[0].a_dm
        self.m = None if a0 is None else a0.shape[-1]
        self.vals_dtype = None if a0 is None else a0.dtype
        for b in buckets:
            r, w = b.edge_idx.shape
            for name, t, shape, dt in (
                    ("edge_idx", b.edge_idx, (r, w), torch.int32),
                    ("mask", b.mask, (r, w), torch.bool),
                    ("dest_ids", b.dest_ids, (r,), torch.int32)):
                _build.check_tensor(fn, name, t, shape, dt, self.device)
            if (b.a_dm is None) != (a0 is None):
                raise ValueError(f"{fn}: a_dm in some buckets only")
            if a0 is not None:
                _build.check_tensor(fn, "a_dm", b.a_dm, (r, w, self.m),
                                    self.vals_dtype, self.device)
        n = len(buckets)
        ptrs = ctypes.c_void_p * n
        self.idx = ptrs(*(b.edge_idx.data_ptr() for b in buckets))
        self.mask = ptrs(*(b.mask.data_ptr() for b in buckets))
        self.vals = (None if a0 is None else
                     ptrs(*(b.a_dm.data_ptr() for b in buckets)))
        self.widths = (ctypes.c_int * n)(*(b.edge_idx.shape[1]
                                           for b in buckets))
        self.key = _key(buckets)
        # the x (or gvals) rows and the out columns the kernel may touch
        self.num_edges = max((int(b.edge_idx.max()) + 1 for b in buckets
                              if b.edge_idx.numel()), default=0)
        self.num_dest = max((int(b.dest_ids.max()) + 1 for b in buckets
                             if b.dest_ids.numel()), default=0)
        if min((int(t.min()) for b in buckets for t in (b.edge_idx, b.dest_ids)
                if t.numel()), default=0) < 0:
            raise ValueError(f"{fn}: negative edge or destination index")


def _key(buckets) -> tuple:
    """The tensors a table was checked for, by address."""
    return tuple((b.edge_idx.data_ptr(), b.mask.data_ptr(),
                  None if b.a_dm is None else b.a_dm.data_ptr())
                 for b in buckets)


def row_extents(mask: torch.Tensor) -> torch.Tensor:
    """(r,) int64: each row's last set mask entry plus one (0 for none)."""
    r, w = mask.shape
    if w == 0:
        return torch.zeros(r, dtype=torch.int64, device=mask.device)
    last = w - torch.argmax(mask.flip(1).to(torch.uint8), dim=1)
    return torch.where(mask.any(dim=1), last, torch.zeros_like(last))


def _row_cuts(b: AxBucket, ext: torch.Tensor, band_entries: int,
              n_bands: int) -> torch.Tensor:
    """(r, n_bands + 1) int64 cut points of each row of bucket `b`: 0, the
    first entry whose edge index reaches each later band (a multiple of
    `band_entries`), rounded down to a multiple of 4 (the kernel's vector
    loads), and the extent.  Monotone for any row; on rows whose edge
    indices ascend (as `build_ax_plan` packs them) segment j holds band
    j's entries and at most 3 of band j - 1's."""
    r, w = b.edge_idx.shape
    zero = torch.zeros((r, 1), dtype=torch.int64, device=ext.device)
    if n_bands == 1 or r == 0 or w == 0:
        return torch.cat([zero, ext[:, None]], dim=1)
    live = torch.arange(w, device=ext.device)[None, :] < ext[:, None]
    seq = torch.where(live, b.edge_idx.long(),
                      torch.full_like(ext[:, None], 2 ** 62))
    bounds = (torch.arange(1, n_bands, device=ext.device) * band_entries)
    pos = torch.searchsorted(seq, bounds.expand(r, -1).contiguous())
    pos = torch.minimum(pos // 4 * 4, ext[:, None])
    pos = torch.cummax(pos, dim=1).values
    return torch.cat([zero, pos, ext[:, None]], dim=1)


def bucket_work(buckets: Sequence[AxBucket],
                item_entries: int = ITEM_ENTRIES,
                band_entries: Optional[int] = BAND_ENTRIES) -> AxWork:
    """The work table of `buckets` (see `plan_work`)."""
    if item_entries <= 0 or item_entries % 256:
        raise ValueError(f"item_entries must be a positive multiple of 256, "
                         f"got {item_entries}")
    if band_entries is not None and band_entries <= 0:
        raise ValueError(f"band_entries must be positive, got {band_entries}")
    checked = _Buckets(buckets) if buckets else None
    dev = checked.device if buckets else torch.device("cpu")
    i32 = dict(dtype=torch.int32, device=dev)
    if sum(b.rows for b in buckets) == 0:
        empty = torch.zeros((0, 4), **i32)
        return AxWork(empty, torch.zeros(0, **i32), torch.zeros((0, 3), **i32),
                      0, item_entries, checked)
    n_bands = (1 if band_entries is None else
               max(1, -(-checked.num_edges // band_entries)))
    ext, cuts, bucket, row, dest = [], [], [], [], []
    for bi, b in enumerate(buckets):
        r = b.rows
        e = row_extents(b.mask)
        ext.append(e)
        cuts.append(_row_cuts(b, e, band_entries, n_bands))
        bucket.append(torch.full((r,), bi, dtype=torch.int64, device=dev))
        row.append(torch.arange(r, dtype=torch.int64, device=dev))
        dest.append(b.dest_ids.long())
    ext, cuts, bucket, row, dest = (torch.cat(t) for t in
                                    (ext, cuts, bucket, row, dest))
    R = ext.numel()
    # segments (row, band): [cut_j, cut_j+1), each cut into items of at
    # most item_entries; a row with no entries gets one empty item
    start = cuts[:, :-1]
    seg_n = (cuts[:, 1:] - start + item_entries - 1) // item_entries
    seg_n[:, 0] += (seg_n.sum(dim=1) == 0).long()
    seg_n, start = seg_n.reshape(-1), start.reshape(-1)
    end = cuts[:, 1:].reshape(-1)
    seg = torch.repeat_interleave(torch.arange(seg_n.numel(), device=dev),
                                  seg_n)
    n_items = seg.numel()
    k = torch.arange(n_items, device=dev) - (torch.cumsum(seg_n, 0)
                                             - seg_n)[seg]
    q0 = start[seg] + k * item_entries
    q1 = torch.minimum(q0 + item_entries, end[seg])
    item_row = seg // n_bands
    item_band = seg % n_bands
    # items are enumerated row by row in entry order: a row's partials are
    # numbered in that order, whatever order the table runs them in
    row_n = seg_n.reshape(R, n_bands).sum(dim=1)
    in_row = torch.arange(n_items, device=dev) - (torch.cumsum(row_n, 0)
                                                  - row_n)[item_row]
    several = row_n > 1
    p_n = torch.where(several, row_n, torch.zeros_like(row_n))
    p_base = torch.cumsum(p_n, 0) - p_n
    part = several[item_row]
    item_dest = torch.where(part, -1 - (p_base[item_row] + in_row),
                            dest[item_row])
    multi = torch.stack([dest[several], p_base[several],
                         p_base[several] + row_n[several]], dim=1)
    # run order: band by band, and in a band the longest rows first (a
    # stable sort keeps the plan's order among equals)
    rank = torch.empty_like(ext)
    rank[torch.sort(ext, descending=True, stable=True).indices] = \
        torch.arange(R, device=dev)
    order = torch.sort(item_band * R + rank[item_row], stable=True).indices
    items = torch.stack([bucket[item_row], row[item_row], q0, q1],
                        dim=1)[order]
    if items.numel() and int(items.abs().max()) >= 2 ** 31:
        raise ValueError("AxPlan too large for the kernel's int32 work table")
    return AxWork(items.to(torch.int32).contiguous(),
                  item_dest[order].to(torch.int32).contiguous(),
                  multi.to(torch.int32).contiguous(), int(p_n.sum()),
                  item_entries, checked)


def plan_work(plan, item_entries: int = ITEM_ENTRIES,
              band_entries: Optional[int] = BAND_ENTRIES) -> AxWork:
    """The work table of an AxPlan, built once a plan (plain torch, on the
    plan's device; a few host syncs).

    Each row's extent (its last set mask entry plus one, so trailing
    padding is skipped for any mask) is cut into items of at most
    `item_entries` entries.  With `band_entries`, a row is cut further
    where its edge indices enter the next band of that many edges, and
    the items run band by band: the items in flight together then gather
    from one band of x (or gvals), which the L2 cache holds.  Within a
    band (or without bands) the longest rows run first, so the rows of
    many items start early and short items fill the tail.  A row of
    extent 0 gets one empty item, which writes its 0.  The index-only and
    the value-carrying plan of one instance have one table, so K2 and K4
    sum in one order.
    """
    return bucket_work(plan.buckets, item_entries, band_entries)


def _launch(wrapper, lib_name, src, buckets, out, work):
    """Check the card's tensors and launch one Ax of `buckets` with `src`
    (x for K2, gvals for K4) into `out`, counting the launch on
    `wrapper`.  The buckets' own tensors were checked when their table was
    built (`work`, built here when not given)."""
    fn_name = wrapper.__name__
    carry = lib_name == "ax_reduce_x"
    dtype, dev = src.dtype, src.device
    if dev.type != "cuda":
        raise ValueError(f"{fn_name}: unsupported device {dev}")
    if dtype not in _DTYPES:
        raise TypeError(f"{fn_name}: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    m, J = out.shape
    E = src.shape[0]
    _build.check_tensor(fn_name, "x" if carry else "gvals", src,
                        (E,) if carry else (E, m), dtype, dev)
    _build.check_tensor(fn_name, "out", out, (m, J), torch.float32, dev)
    if work is None:
        work = bucket_work(buckets)
    n_items, n_multi = work.items.shape[0], work.multi.shape[0]
    if n_items == 0:
        return out
    for name, t, shape in (("items", work.items, (n_items, 4)),
                           ("item_dest", work.item_dest, (n_items,)),
                           ("multi", work.multi, (n_multi, 3))):
        _build.check_tensor(fn_name, f"work.{name}", t, shape, torch.int32,
                            dev)
    bk = work.buckets
    if bk.key != _key(buckets):
        raise ValueError(f"{fn_name}: the work table is another plan's")
    if bk.device != dev:
        raise ValueError(f"{fn_name}: the plan is on {bk.device}, "
                         f"expected {dev}")
    if bk.num_edges > E or bk.num_dest > J:
        raise ValueError(f"{fn_name}: the plan indexes {bk.num_edges} edges "
                         f"and {bk.num_dest} destinations, past ({E}, {J})")
    if carry and (bk.vals is None or bk.vals_dtype != dtype or bk.m != m):
        raise ValueError(f"{fn_name}: the plan's a_dm is not ({m} families "
                         f"of {dtype})")
    lib = _build.build()[lib_name]
    max_m = getattr(lib, f"{lib_name}_max_families")()
    max_b = getattr(lib, f"{lib_name}_max_buckets")()
    if not 1 <= m <= max_m:
        raise ValueError(f"{fn_name}: m={m} outside the kernel's 1..{max_m} "
                         f"families")
    if len(buckets) > max_b:
        raise ValueError(f"{fn_name}: {len(buckets)} buckets exceed the "
                         f"kernel's {max_b}")
    partials = torch.empty(max(work.num_partials * m, 1),
                           dtype=torch.float32, device=dev)
    table = (work.items.data_ptr(), work.item_dest.data_ptr(), n_items,
             work.multi.data_ptr(), n_multi, out.data_ptr(),
             partials.data_ptr(), J,
             torch.cuda.current_stream(dev).cuda_stream)
    if carry:
        rc = lib.ax_reduce_x_launch(_DTYPES[dtype], m, src.data_ptr(),
                                    len(buckets), bk.idx, bk.mask, bk.vals,
                                    bk.widths, *table)
    else:
        rc = lib.ax_reduce_launch(_DTYPES[dtype], m, src.data_ptr(),
                                  len(buckets), bk.idx, bk.mask, bk.widths,
                                  *table)
    _build.check(rc, f"{lib_name} kernel launch")
    # unlocked: counts are read around single-threaded windows only
    wrapper.launches += 1
    return out


def ax_reduce_plan_x(x, plan, out, work: Optional[AxWork] = None):
    """One Ax of a value-carrying plan into `out` (K2): every column of
    the plan's destinations is written.

    x (E,) float32 or bfloat16, the buckets' a_dm of the same type;
    out (m, J) float32; `work` the plan's `plan_work` table (built here
    when not given).  Returns `out`.
    """
    if x.device.type == "cpu":
        for b in plan.buckets:
            out[:, b.dest_ids.long()] = ax_reduce_x_ref(
                x, b.a_dm, b.edge_idx, b.mask).T
        return out
    return _launch(ax_reduce_plan_x, "ax_reduce_x", x, plan.buckets, out,
                   work)


def ax_reduce_plan(gvals, plan, out, work: Optional[AxWork] = None):
    """One Ax of an index-only plan into `out` (K4): every column of the
    plan's destinations is written.

    gvals (E, m) float32 or bfloat16; out (m, J) float32; `work` as in
    `ax_reduce_plan_x`.  Returns `out`.
    """
    if gvals.device.type == "cpu":
        for b in plan.buckets:
            out[:, b.dest_ids.long()] = ax_reduce_ref(
                gvals, b.edge_idx, b.mask).T
        return out
    return _launch(ax_reduce_plan, "ax_reduce", gvals, plan.buckets, out,
                   work)


def ax_reduce_bucket_x(x, a_dm, edge_idx, mask, dest_ids, out):
    """Reduce one value-carrying bucket into `out[:, dest_ids]` (K2, over
    the bucket's own work table).

    x (E,) and a_dm (r, w, m) float32 or bfloat16 (the same); edge_idx
    (r, w) and dest_ids (r,) int32; mask (r, w) bool; out (m, J) float32.
    Returns `out`.
    """
    if x.device.type == "cpu":
        out[:, dest_ids.long()] = ax_reduce_x_ref(x, a_dm, edge_idx, mask).T
        return out
    return _launch(ax_reduce_bucket_x, "ax_reduce_x", x,
                   (AxBucket(edge_idx, mask, dest_ids, a_dm),), out, None)


def ax_reduce_bucket(gvals, edge_idx, mask, dest_ids, out):
    """Reduce one index-only bucket into `out[:, dest_ids]` (K4, over the
    bucket's own work table).

    gvals (E, m) float32 or bfloat16; edge_idx (r, w) and dest_ids (r,)
    int32; mask (r, w) bool; out (m, J) float32.  Returns `out`.
    """
    if gvals.device.type == "cpu":
        out[:, dest_ids.long()] = ax_reduce_ref(gvals, edge_idx, mask).T
        return out
    return _launch(ax_reduce_bucket, "ax_reduce", gvals,
                   (AxBucket(edge_idx, mask, dest_ids),), out, None)


ax_reduce_plan_x.launches = 0
ax_reduce_plan.launches = 0
ax_reduce_bucket_x.launches = 0
ax_reduce_bucket.launches = 0
