"""Plain PyTorch versions of the hand-written kernels (port of
`repro.kernels.ref`).

Each function repeats its kernel's arithmetic with ordinary tensor ops.
The wrappers in `dual_grad.py`, `ax_reduce.py` and `proj.py` run them for
tensors on the CPU; `chip_smoke.py` and the tests hold each kernel against them on
the card.  Only the order of the floating-point sums differs.
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
