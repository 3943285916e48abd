"""Plain PyTorch versions of the hand-written kernels (port of
`repro.kernels.ref`).

Each function repeats its kernel's arithmetic with ordinary tensor ops.
The wrappers in `dual_grad.py`, `ax_reduce.py` and `proj.py` run them for
tensors on the CPU; `chip_smoke.py` and the tests hold each kernel against them on
the card.  Only the order of the floating-point sums differs, except in
the kernel-order versions (`dual_x_lanes_ref`, `dual_grad_lanes_ref`,
`proj_lanes_ref` on rows up to 1,024 wide; `dual_x_block_ref`,
`dual_grad_block_ref`, `proj_block_ref` on wider rows; `ax_items_ref`),
which repeat the kernels' order too and equal them bit for bit in
float32.
"""
from __future__ import annotations

import torch


def boxcut_bisect_ref(v, ub, s, mask, iters: int = 40):
    """Row-wise projection onto {0 <= x <= ub, Σx <= s} by τ-bisection.
    v, ub, mask: (n, w); s: (n,)."""
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    v = torch.where(mask, v, torch.full_like(v, -1e30))

    def clip(t):
        return torch.minimum(torch.clamp_min(t, 0.0), ub)

    f0 = torch.where(mask, clip(v), zero).sum(dim=-1)
    need = f0 > s
    hi = v.amax(dim=-1)
    lo = torch.minimum(torch.zeros_like(hi), hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        f = torch.where(mask, clip(v - mid[:, None]), zero).sum(dim=-1)
        big = f > s
        lo, hi = torch.where(big, mid, lo), torch.where(big, hi, mid)
    tau = torch.where(need, 0.5 * (lo + hi), torch.zeros_like(lo))
    return torch.where(mask, clip(v - tau[:, None]), zero)


def proj_boxcut_ref(v, ub, s, mask, iters: int = 40):
    """The `proj` kernel's function: the batched box-cut projection of an
    (n, w) slab, in v's dtype, 0 on padding."""
    return boxcut_bisect_ref(v, ub, s, mask, iters)


def dual_x_ref(a_vals, c_vals, dest_idx, mask, ub, s, lam, gamma,
               iters: int = 40):
    """x*(λ) and its scalars for one slab (the `dual_x` kernel's function):

      u    = −(Σ_k a_k ⊙ λ_k[dest] + c) / γ
      x    = Π_boxcut(u)
      c_x  = <c, x>,  x_sq = ‖x‖²          (float32 sums)

    a_vals: (n, w, m); lam: (m, J) float32; gamma: 0-d tensor in the slab's
    dtype.  Returns (x in the slab's dtype, c_x, x_sq).
    """
    d = dest_idx.long()
    atl = torch.zeros(c_vals.shape, dtype=a_vals.dtype, device=a_vals.device)
    for k in range(a_vals.shape[2]):
        atl = atl + a_vals[:, :, k] * lam[k][d]
    u = -(atl + c_vals) / gamma
    x = boxcut_bisect_ref(u, ub, s, mask, iters)
    c_x = (c_vals * x).float().sum()
    x_sq = (x * x).float().sum()
    return x.to(c_vals.dtype), c_x, x_sq


def dual_grad_ref(a_vals, c_vals, dest_idx, mask, ub, s, lam, gamma,
                  iters: int = 40):
    """The `dual_grad` kernel's function: `dual_x_ref` plus the per-edge
    gradient values gvals = a ⊙ x (n, w, m) in a's dtype, 0 on padding.
    Returns (x, gvals, c_x, x_sq)."""
    x, c_x, x_sq = dual_x_ref(a_vals, c_vals, dest_idx, mask, ub, s, lam,
                              gamma, iters)
    prod = a_vals * x.to(a_vals.dtype)[..., None]
    gvals = torch.where(mask[..., None], prod, torch.zeros_like(prod))
    return x, gvals, c_x, x_sq


KNEG = -1e30          # the kernels' fill for entries a row does not own
WARP, BLOCK_WARPS, PARTIAL_THREADS = 32, 8, 1024   # dual_x.cu's launch shape
WIDE_THREADS = BLOCK_WARPS * WARP   # threads of a row's block past 1,024
NARROW_MAX_WIDTH = 1024   # the widest row a group of lanes holds


def block_layout(w: int):
    """(WIDE_THREADS, C) of a row of width w > 1,024, the kernels' wide
    path: one block a row, thread t holding columns [t·C, (t+1)·C), C the
    next power of two of w over 256 (8, 16, 32 at 2,048, 4,096, 8,192)."""
    if w <= NARROW_MAX_WIDTH:
        raise ValueError(f"rows of width {w} <= {NARROW_MAX_WIDTH} run on "
                         f"a group of lanes, not a block")
    return WIDE_THREADS, (1 << (w - 1).bit_length()) // WIDE_THREADS


def _clip(t, ub):
    """clip(t, 0, ub) as K1 and K3 compute it, fminf(fmaxf(t, 0), ub): a
    NaN operand is dropped, so a NaN t gives 0 and a NaN ub no bound."""
    return torch.fmin(torch.fmax(t, torch.zeros_like(t)), ub)


def _chunk_sums(t, layout):
    """(rows, L) sums of t (rows, L·VPT): lane l's chunk of VPT, in order
    from 0, as each lane of K1 and K3 sums."""
    L, V = layout
    t = t.reshape(t.shape[0], L, V)
    acc = torch.zeros(t.shape[:2], dtype=torch.float32, device=t.device)
    for i in range(V):
        acc = acc + t[:, :, i]
    return acc


def _butterfly(acc):
    """The xor butterfly of `group_sum` over the lanes (columns) of acc;
    every lane ends with the same sum, returned."""
    lane = torch.arange(acc.shape[1], device=acc.device)
    off = acc.shape[1] // 2
    while off:
        acc = acc + acc[:, lane ^ off]
        off //= 2
    return acc[:, 0]


def _lane_sums(t, layout):
    """Row sums of t (rows, L·VPT) in the order of K1's and K3's lanes:
    each lane sums its chunk, then the butterfly over the row's L lanes."""
    return _butterfly(_chunk_sums(t, layout))


def lanes_u(a_vals, c_vals, dest_idx, mask, ub, lam, gamma, layout):
    """(v, ub) of a slab as K1 and K3 hold them at `layout` (L, VPT), or
    (256, C) on the wide path:
    float32 (n, L·VPT), v = u = −(Σ_k a_k λ_k[dest] + c)/γ in the kernels'
    order at real entries, KNEG (and ub 0) on padding and past the
    width."""
    n, w, m = a_vals.shape
    d = torch.where(mask, dest_idx, torch.zeros_like(dest_idx)).long()
    atl = torch.zeros((n, w), dtype=torch.float32, device=a_vals.device)
    for k in range(m):
        atl = atl + a_vals[:, :, k].float() * lam[k][d]
    u = -(atl + c_vals.float()) / gamma.float()
    return pad_rows(u, ub, mask, layout[0] * layout[1])


def _block_sums(t):
    """Row sums of t (rows, 256·C) in the order of the kernels' wide path
    (`common.cuh::boxcut_tau_block`): each thread sums its chunk of C in
    order, each warp runs the xor butterfly over its 32 threads, then the
    8 warp sums are added in warp order."""
    n = t.shape[0]
    chunks = _chunk_sums(t, (WIDE_THREADS, t.shape[1] // WIDE_THREADS))
    warps = _butterfly(chunks.reshape(-1, WARP)).reshape(n, BLOCK_WARPS)
    acc = torch.zeros(n, dtype=torch.float32, device=t.device)
    for i in range(BLOCK_WARPS):
        acc = acc + warps[:, i]
    return acc


def _bisect(v, ub, s, iters, row_sums, early_exit):
    """τ and steps of each row of (v, ub), its sums in `row_sums`' order;
    see `bisect_lanes_ref`."""
    s = s.float()
    f0 = row_sums(_clip(v, ub))
    need = f0 > s
    hi = torch.where(v.isnan(), torch.full_like(v, KNEG), v).amax(
        dim=1).clamp_min(KNEG)
    lo = torch.minimum(torch.zeros_like(hi), hi)
    done = ~need if early_exit else torch.zeros_like(need)
    steps = torch.zeros(v.shape[0], dtype=torch.int64, device=v.device)
    for _ in range(iters):
        live = ~done
        if early_exit and not bool(live.any()):
            break
        mid = 0.5 * (lo + hi)
        big = row_sums(_clip(v - mid[:, None], ub)) > s
        if early_exit:
            done = done | (mid == lo) | (mid == hi)
        lo = torch.where(live & big, mid, lo)
        hi = torch.where(live & ~big, mid, hi)
        steps += live
    tau = torch.where(need, 0.5 * (lo + hi), torch.zeros_like(lo))
    return tau, steps


def bisect_lanes_ref(v, ub, s, iters: int, layout, early_exit: bool = True):
    """τ of each row of (v, ub) (n, L·VPT) and the steps each row ran, in
    the order of the register path's sums (`common.cuh::boxcut_tau_chunk`,
    K1, K3 and K5 on rows up to 1,024 wide).

    With `early_exit`, a row with f0 <= s runs no step, and a row stops
    after the step in which mid == lo or mid == hi, once its update is
    applied; otherwise every row runs all `iters` steps.  Both give the
    same τ bit for bit.  Maxima and clips drop NaN, as the kernels'
    fmaxf and fminf do.  Returns (τ (n,) float32, steps (n,) int64)."""
    return _bisect(v, ub, s, iters, lambda t: _lane_sums(t, layout),
                   early_exit)


def bisect_block_ref(v, ub, s, iters: int, early_exit: bool = True):
    """`bisect_lanes_ref` for rows of (v, ub) (n, 256·C) held by a block,
    in the order of the wide path's sums (`common.cuh::boxcut_tau_block`,
    K1, K3 and K5 on rows wider than 1,024).  Returns (τ, steps)."""
    return _bisect(v, ub, s, iters, _block_sums, early_exit)


def pad_rows(v, ub, mask, width):
    """(v, ub) of an (n, w) slab as the kernels hold them in float32, (n,
    `width`): v and ub at real entries; KNEG and 0 on padding and past w."""
    n, w = v.shape
    vp = torch.full((n, width), KNEG, dtype=torch.float32, device=v.device)
    ubp = torch.zeros((n, width), dtype=torch.float32, device=v.device)
    vp[:, :w] = torch.where(mask, v.float(), torch.full_like(vp[:, :w], KNEG))
    ubp[:, :w] = torch.where(mask, ub.float(), torch.zeros_like(ubp[:, :w]))
    return vp, ubp


def _proj_order(v, ub, s, mask, iters, width, bisect):
    n, w = v.shape
    vp, ubp = pad_rows(v, ub, mask, width)
    tau, _ = bisect(vp, ubp, s, iters)
    x = torch.where(mask, _clip(vp[:, :w] - tau[:, None], ubp[:, :w]),
                    torch.zeros_like(tau)[:, None])
    return x.to(v.dtype)


def proj_lanes_ref(v, ub, s, mask, iters: int, layout,
                   early_exit: bool = True):
    """`proj_boxcut_ref` in the order of K5's sums at `layout` (L, VPT) =
    `dual_grad.row_layout(w)` (rows up to 1,024 wide), early exit or the
    fixed count (the same bits): equal to K5 bit for bit in float32, and,
    fed a slab's u, to `dual_x_lanes_ref`'s x."""
    if layout is None:
        raise ValueError("proj_lanes_ref: rows wider than 1,024 have no "
                         "lane layout (proj_block_ref)")
    return _proj_order(v, ub, s, mask, iters, layout[0] * layout[1],
                       lambda *a: bisect_lanes_ref(*a, layout, early_exit))


def proj_block_ref(v, ub, s, mask, iters: int, early_exit: bool = True):
    """`proj_lanes_ref` for rows wider than 1,024, in the order of K5's
    wide path: equal to it bit for bit in float32."""
    L, C = block_layout(v.shape[1])
    return _proj_order(v, ub, s, mask, iters, L * C,
                       lambda *a: bisect_block_ref(*a, early_exit))


def _block_order_sum(t, mask, layout):
    """Σ of t (n, w) over the real entries in dual_x.cu's order: each lane
    over its chunk, the warp's xor butterfly over its 32 lanes (32/L rows,
    or a 32nd of a wide row's block), the block's 8 warp sums in order,
    then the one-block pass over the block partials (1,024 threads, each
    striding over the partials, then a halving tree)."""
    n, w = t.shape
    L, V = layout
    rows = WIDE_THREADS // L                       # rows a block
    nb = -(-n // rows)
    dev = t.device
    full = torch.zeros((nb * rows, L * V), dtype=torch.float32, device=dev)
    full[:n, :w] = torch.where(mask, t, torch.zeros_like(t))
    lanes = _chunk_sums(full, layout).reshape(-1, WARP)   # a warp a row
    warps = _butterfly(lanes).reshape(nb, BLOCK_WARPS)
    part = torch.zeros(nb, dtype=torch.float32, device=dev)
    for i in range(BLOCK_WARPS):
        part = part + warps[:, i]
    T = PARTIAL_THREADS
    q = torch.zeros(-(-nb // T) * T, dtype=torch.float32, device=dev)
    q[:nb] = part
    q = q.reshape(-1, T)
    tot = torch.zeros(T, dtype=torch.float32, device=dev)
    for r in range(q.shape[0]):
        tot = tot + q[r]
    half = T // 2
    while half:
        tot = tot[:half] + tot[half:2 * half]
        half //= 2
    return tot[0]


def _dual_x_order(a_vals, c_vals, dest_idx, mask, ub, s, lam, gamma, iters,
                  layout, bisect):
    """x, c_x, x_sq of K1 in its order of the sums at `layout`, τ from
    `bisect` at the fixed count."""
    w = c_vals.shape[1]
    v, ubp = lanes_u(a_vals, c_vals, dest_idx, mask, ub, lam, gamma, layout)
    tau, _ = bisect(v, ubp, s, iters)
    x = torch.where(mask, _clip(v[:, :w] - tau[:, None], ubp[:, :w]),
                    torch.zeros_like(tau)[:, None])
    c_x = _block_order_sum(c_vals.float() * x, mask, layout)
    x_sq = _block_order_sum(x * x, mask, layout)
    return x.to(c_vals.dtype), c_x, x_sq


def _with_gvals(a_vals, mask, x, c_x, x_sq):
    prod = a_vals * x.to(a_vals.dtype)[..., None]
    gvals = torch.where(mask[..., None], prod, torch.zeros_like(prod))
    return x, gvals, c_x, x_sq


def dual_x_lanes_ref(a_vals, c_vals, dest_idx, mask, ub, s, lam, gamma,
                     iters: int, layout):
    """`dual_x_ref` in the order of K1's sums at `layout` (L, VPT) =
    `dual_grad.row_layout(w)` (rows up to 1,024 wide), with the fixed
    count of bisection steps: equal to K1 bit for bit in float32.
    Returns (x in the slab's dtype, c_x, x_sq)."""
    if layout is None:
        raise ValueError("dual_x_lanes_ref: rows wider than 1,024 have no "
                         "lane layout")
    return _dual_x_order(
        a_vals, c_vals, dest_idx, mask, ub, s, lam, gamma, iters, layout,
        lambda *a: bisect_lanes_ref(*a, layout, early_exit=False))


def dual_grad_lanes_ref(a_vals, c_vals, dest_idx, mask, ub, s, lam, gamma,
                        iters: int, layout):
    """`dual_x_lanes_ref` plus gvals = a ⊙ x in a's dtype, 0 on padding:
    equal to K3 bit for bit in float32.  Returns (x, gvals, c_x, x_sq)."""
    return _with_gvals(a_vals, mask, *dual_x_lanes_ref(
        a_vals, c_vals, dest_idx, mask, ub, s, lam, gamma, iters, layout))


def dual_x_block_ref(a_vals, c_vals, dest_idx, mask, ub, s, lam, gamma,
                     iters: int):
    """`dual_x_ref` in the order of K1's wide path (rows wider than 1,024:
    a block a row, `block_layout`), with the fixed count of bisection
    steps: equal to K1 bit for bit in float32.  Returns (x, c_x, x_sq)."""
    return _dual_x_order(
        a_vals, c_vals, dest_idx, mask, ub, s, lam, gamma, iters,
        block_layout(c_vals.shape[1]),
        lambda *a: bisect_block_ref(*a, early_exit=False))


def dual_grad_block_ref(a_vals, c_vals, dest_idx, mask, ub, s, lam, gamma,
                        iters: int):
    """`dual_x_block_ref` plus gvals = a ⊙ x: equal to K3 bit for bit in
    float32.  Returns (x, gvals, c_x, x_sq)."""
    return _with_gvals(a_vals, mask, *dual_x_block_ref(
        a_vals, c_vals, dest_idx, mask, ub, s, lam, gamma, iters))


def ax_reduce_x_ref(x, a_dm, edge_idx, mask):
    """out[r, k] = Σ_q mask[r, q] · a_dm[r, q, k] · x[edge_idx[r, q]].

    The product is formed in the input dtype and summed in float32.
    Returns (r, m) float32.
    """
    r, w = edge_idx.shape
    xe = x[edge_idx.reshape(-1).long()].reshape(r, w)
    prod = (a_dm * xe[..., None]).float()
    return torch.where(mask[..., None], prod, torch.zeros_like(prod)).sum(dim=1)


def ax_plan_x_ref(plan, x):
    """(m, J) Ax from a value-carrying plan and the (E,) x vector, assembled
    through the plan's `inv_perm` gather."""
    rows = torch.cat([ax_reduce_x_ref(x, b.a_dm, b.edge_idx, b.mask)
                      for b in plan.buckets], dim=0)
    return rows[plan.inv_perm.long()].T


def ax_reduce_ref(gvals, edge_idx, mask):
    """out[r, k] = Σ_q mask[r, q] · gvals[edge_idx[r, q], k], summed in
    float32.  gvals: (E, m).  Returns (r, m) float32."""
    r, w = edge_idx.shape
    g = gvals[edge_idx.reshape(-1).long()].reshape(r, w, -1).float()
    return torch.where(mask[..., None], g, torch.zeros_like(g)).sum(dim=1)


def ax_plan_ref(plan, gvals):
    """(m, J) Ax from an index-only plan and the (E, m) gvals, assembled
    through the plan's `inv_perm` gather."""
    rows = torch.cat([ax_reduce_ref(gvals, b.edge_idx, b.mask)
                      for b in plan.buckets], dim=0)
    return rows[plan.inv_perm.long()].T


def ax_items_ref(plan, work, x=None, gvals=None):
    """(m, J) Ax of `plan` in the Ax kernels' own order of the sums, from x
    (K2, value-carrying plan) or gvals (K4): equal to the kernels bit for
    bit.

    `work` is the plan's `ax_reduce.plan_work` table.  Each item's entries
    [q0, q1) are summed as the kernel's warp sums them: in tiles of 256,
    lane l takes entries q + s·128 + 4l + j (s = 0, 1; j = 0..3) in that
    order, tile after tile, in float32; then the xor butterfly over the 32
    lanes.  A row of several items sums its partials in item order.
    """
    items = work.items.long()
    n, C = items.shape[0], work.item_entries
    src = x if gvals is None else gvals
    dev = src.device
    m = plan.buckets[0].a_dm.shape[-1] if gvals is None else gvals.shape[1]
    vals = torch.zeros((n, C, m), dtype=torch.float32, device=dev)
    for bi, b in enumerate(plan.buckets):
        sel = torch.nonzero(items[:, 0] == bi)[:, 0]
        if sel.numel() == 0:
            continue
        rows, q0, q1 = items[sel, 1, None], items[sel, 2, None], items[sel, 3, None]
        q = q0 + torch.arange(C, device=dev)[None, :]
        inside = q < q1
        q = torch.where(inside, q, torch.zeros_like(q))
        idx = b.edge_idx[rows, q].long()
        if gvals is None:
            t = (b.a_dm[rows, q] * x[idx][..., None]).float()
        else:
            t = gvals[idx].float()
        vals[sel] = torch.where((b.mask[rows, q] & inside)[..., None], t,
                                torch.zeros_like(t))
    # lane l's entries in its order: (tile, s, j)
    lanes = vals.reshape(n, C // 256, 2, 32, 4, m).permute(0, 3, 1, 2, 4, 5)
    lanes = lanes.reshape(n, 32, -1, m)
    acc = torch.zeros((n, 32, m), dtype=torch.float32, device=dev)
    for i in range(lanes.shape[2]):
        acc = acc + lanes[:, :, i]
    lane = torch.arange(32, device=dev)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ off]
    sums = acc[:, 0]
    out = torch.empty((m, plan.num_destinations), dtype=torch.float32,
                      device=dev)
    dest = work.item_dest.long()
    direct = dest >= 0
    out[:, dest[direct]] = sums[direct].T
    partials = torch.empty((work.num_partials, m), dtype=torch.float32,
                           device=dev)
    partials[-1 - dest[~direct]] = sums[~direct]
    multi = work.multi.long()
    if multi.shape[0]:
        j, p0, p1 = multi[:, 0], multi[:, 1], multi[:, 2]
        tot = torch.zeros((multi.shape[0], m), dtype=torch.float32,
                          device=dev)
        for i in range(int((p1 - p0).max())):
            p = p0 + i
            live = (p < p1)[:, None]
            tot = tot + torch.where(live, partials[torch.minimum(p, p1 - 1)],
                                    torch.zeros_like(tot))
        out[:, j] = tot.T
    return out
