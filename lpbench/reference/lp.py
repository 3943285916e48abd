"""The dual of the generated LP, evaluated in plain torch.

For duals lam >= 0 on the destination rows (k, j) and mu >= 0 on the
coupling rows r, and a fixed gamma > 0,

    g(lam, mu) = min_{x in C} c'x + (gamma/2)|x|^2 + lam'(A x - b)
                              + sum_r mu_r (w_r'x - limit_r),

    grad g = (A x* - b, w_r'x* - limit_r),

with C the per-source box-cut sets {0 <= x_e <= ub_e, sum_e x_e <= s_i},
so that x* = clip(u - tau_i, 0, ub) with u = -(A'lam + sum_r mu_r w_r +
c)/gamma and tau_i >= 0 the least value that meets the budget.

Everything the program derives from the arrays is worked out again here:
the row normalization of the destination rows (A' = D A, b' = D b with D
the inverse row norms, when the configuration normalizes), the coupling
rows' weights, limits and scales (sigma_r = 1/|w_r|), and the projection,
found by bisection on tau to the precision of the arithmetic.  Sources
are padded to power-of-two widths here, by this file's own layout.

`dtype` is the arithmetic of the elementwise work and `acc` that of the
sums: float64 for the reference; bfloat16 with float32 sums for the
control, which rounds its inputs to bfloat16 first.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch


class _Bucket(NamedTuple):
    mask: torch.Tensor        # (n, w) bool
    dst: torch.Tensor         # (n, w) int64, 0 on padding
    a: torch.Tensor           # (m, n, w) scaled coefficients, 0 on padding
    c: torch.Tensor           # (n, w) objective, 0 on padding
    ub: torch.Tensor          # (n, w) upper bounds, 0 on padding
    s: torch.Tensor           # (n,) budgets
    w: List[torch.Tensor]     # per coupling row: (n, w) scaled weights


def _pow2(deg: torch.Tensor) -> torch.Tensor:
    w = torch.ones_like(deg)
    while bool((w < deg).any()):
        w = torch.where(w < deg, w * 2, w)
    return w


class ReferenceLP:
    """The LP of one configuration on one generated instance (`raw`:
    `lpbench.instance.Raw`, or any object with its fields)."""

    def __init__(self, raw, config: dict, dtype=torch.float64,
                 acc=torch.float64, bisect_steps: int = 64):
        self.dtype, self.acc = dtype, acc
        self.bisect_steps = bisect_steps
        dev = raw.src.device
        m, J = raw.b.shape
        self.m, self.J = m, J
        value = raw.value.to(dtype).to(acc)
        a = raw.a.to(dtype).to(acc)
        # coupling rows, from the unscaled coefficients
        rows = config.get("coupling_rows", [])
        s_all = raw.s.to(dtype).to(acc)
        E = raw.src.numel()
        weights, limits = [], []
        for row in rows:
            if row["weight"] == "count":
                wt = None
                norm = float(E) ** 0.5
            elif row["weight"] == "value":
                wt = value
                norm = float(torch.linalg.vector_norm(value.double()))
            else:
                raise ValueError(f"unknown coupling weight {row['weight']!r}")
            if row["of"] == "sum_s":
                base = float(s_all.double().sum())
            elif row["of"] == "sum_s_max_value":
                vmax = torch.zeros(raw.sources.numel(), dtype=torch.float64,
                                   device=dev)
                src_row = torch.repeat_interleave(
                    torch.arange(raw.sources.numel(), device=dev), raw.deg)
                vmax = vmax.scatter_reduce(0, src_row, value.double(),
                                           "amax", include_self=True)
                base = float((s_all.double() * vmax).sum())
            else:
                raise ValueError(f"unknown limit base {row['of']!r}")
            sigma = 1.0 / norm if config["row_norm"] and norm > 0 else 1.0
            weights.append((wt, sigma))
            limits.append(row["limit_frac"] * base * sigma)
        self.limits = torch.tensor(limits, dtype=acc, device=dev)
        # row normalization of the destination rows
        b = raw.b.to(dtype).to(acc)
        if config["row_norm"]:
            sq = torch.zeros((m, J), dtype=acc, device=dev)
            for k in range(m):
                sq[k].index_add_(0, raw.dst, a[k] * a[k])
            norms = torch.sqrt(sq)
            d = torch.where(norms > 0, 1.0 / torch.clamp_min(norms, 1e-300),
                            torch.ones_like(norms))
            a = a * d[:, raw.dst]
            b = b * d
        self.b = b
        # sources padded to power-of-two widths, this file's own layout
        width = _pow2(raw.deg)
        self.buckets = []
        for wd in torch.unique(width).tolist():
            rows_i = torch.nonzero(width == wd).reshape(-1)
            lane = torch.arange(wd, device=dev)
            mask = lane[None, :] < raw.deg[rows_i][:, None]
            idx = torch.where(mask, raw.start[rows_i][:, None] + lane[None, :],
                              0)

            def pad(v, mask=mask, idx=idx):
                return torch.where(mask, v[idx], torch.zeros((), dtype=v.dtype,
                                                             device=dev))
            self.buckets.append(_Bucket(
                mask=mask, dst=torch.where(mask, raw.dst[idx], 0),
                a=torch.stack([pad(a[k]).to(dtype) for k in range(m)]),
                c=pad(-value).to(dtype), ub=pad(raw.ub.to(dtype)),
                s=raw.s[rows_i].to(dtype),
                w=[(torch.where(mask, torch.full((), sg, dtype=acc,
                                                 device=dev), 0.0)
                    if wt is None else pad(wt) * sg).to(dtype)
                   for wt, sg in weights]))

    @property
    def num_rows(self) -> int:
        return self.m * self.J + self.limits.numel()

    def _boxcut(self, u, ub, s):
        """x = clip(u - tau, 0, ub), tau >= 0 the least with sum x <= s,
        by bisection on tau in the arithmetic of `u`."""
        x = torch.minimum(torch.clamp_min(u, 0.0), ub)
        need = x.sum(1, dtype=self.acc) > s.to(self.acc)
        if not bool(need.any()):
            return x
        lo = torch.zeros_like(s)
        hi = torch.clamp_min(u.amax(1), 0.0)
        for _ in range(self.bisect_steps):
            mid = (lo + hi) * 0.5
            f = torch.minimum(torch.clamp_min(u - mid[:, None], 0.0),
                              ub).sum(1, dtype=self.acc)
            over = f > s.to(self.acc)
            lo = torch.where(over, mid, lo)
            hi = torch.where(over, hi, mid)
        tau = torch.where(need, hi, torch.zeros_like(hi))
        return torch.minimum(torch.clamp_min(u - tau[:, None], 0.0), ub)

    def evaluate(self, lam: torch.Tensor, gamma: float):
        """(g, grad) at the dual `lam` (the destination block, (m, J) or
        flat, then one entry a coupling row) and `gamma`; g a float and
        grad a flat tensor of `acc`."""
        m, J = self.m, self.J
        lam = lam.reshape(-1).to(self.acc)
        lam_d = lam[:m * J].reshape(m, J)
        mus = lam[m * J:]
        lam_e = lam_d.to(self.dtype)
        gam = torch.tensor(gamma, dtype=self.dtype, device=lam.device)
        ax = torch.zeros((m, J), dtype=self.acc, device=lam.device)
        wx = torch.zeros(mus.numel(), dtype=self.acc, device=lam.device)
        c_x = torch.zeros((), dtype=self.acc, device=lam.device)
        x_sq = torch.zeros((), dtype=self.acc, device=lam.device)
        for bk in self.buckets:
            t = bk.c.clone()
            for k in range(m):
                t = t + bk.a[k] * lam_e[k][bk.dst]
            for r in range(mus.numel()):
                t = t + mus[r].to(self.dtype) * bk.w[r]
            u = torch.where(bk.mask, -t / gam, torch.zeros((), dtype=t.dtype,
                                                          device=t.device))
            x = self._boxcut(u, bk.ub, bk.s)
            c_x = c_x + (bk.c * x).sum(dtype=self.acc)
            x_sq = x_sq + (x * x).sum(dtype=self.acc)
            for r in range(mus.numel()):
                wx[r] = wx[r] + (bk.w[r] * x).sum(dtype=self.acc)
            dst = bk.dst[bk.mask]
            for k in range(m):
                ax[k].index_add_(0, dst, (bk.a[k] * x)[bk.mask].to(self.acc))
        grad = torch.cat([(ax - self.b).reshape(-1), wx - self.limits])
        g = c_x + 0.5 * float(gamma) * x_sq + (lam * grad).sum()
        return float(g), grad

    def rhs(self) -> torch.Tensor:
        """The right-hand sides in the evaluated units: b', then the
        limits."""
        return torch.cat([self.b.reshape(-1), self.limits])


def kkt_residual(lam: torch.Tensor, grad: torch.Tensor) -> float:
    """|lam - max(lam + grad, 0)|_2: zero exactly at a maximizer of g
    over lam >= 0."""
    lam = lam.reshape(-1).to(grad.dtype)
    return float(torch.linalg.vector_norm(
        lam - torch.clamp_min(lam + grad, 0.0)))


class ControlObjective:
    """The reference's evaluation as an objective the program's engine can
    drive (`calculate(lam, gamma) -> (g, grad, aux)`): the control, put in
    the program's place."""

    def __init__(self, ref: ReferenceLP, dual_shape):
        self.ref = ref
        self.dual_shape = tuple(dual_shape)

    def calculate(self, lam, gamma):
        from types import SimpleNamespace
        g, grad = self.ref.evaluate(lam, float(gamma))
        grad = grad.to(torch.float32).reshape(self.dual_shape)
        gt = torch.tensor(g, dtype=torch.float32, device=grad.device)
        infeas = torch.linalg.vector_norm(torch.clamp_min(grad, 0.0))
        zero = torch.zeros((), dtype=torch.float32, device=grad.device)
        return gt, grad, SimpleNamespace(primal_obj=zero, x_sq=zero, ax=grad,
                                         infeas=infeas)


def relative(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def grad_gap(grad_prog: torch.Tensor, grad_ref: torch.Tensor,
             ref: ReferenceLP) -> float:
    """The worst of |grad gap| over the destination block, relative to
    |b'|, and of each coupling row's gap, relative to its limit."""
    mJ = ref.m * ref.J
    gp = grad_prog.reshape(-1).to(grad_ref.dtype)
    worst = float(torch.linalg.vector_norm(gp[:mJ] - grad_ref[:mJ])
                  / torch.linalg.vector_norm(ref.b))
    for r in range(ref.limits.numel()):
        worst = max(worst, float(abs(gp[mJ + r] - grad_ref[mJ + r])
                                 / abs(ref.limits[r])))
    return worst
