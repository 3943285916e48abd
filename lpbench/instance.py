"""The benchmark's instance generator: the matching LP law of the
DuaLip-GPU report's Appendix B, vectorized in torch, from one seed.

    1. a lognormal breadth per destination j, normalized to p_j;
    2. K_j ~ Poisson(p_j · I · nu), truncated at I;
    3. K_j distinct sources for destination j;
    4. value_ij = min(v_j · u_i · eps_ij, c_max), v_j and u_i lognormal and
       eps_ij lognormal noise from a counter-based hash of (seed, i, j);
    5. a_kij = s_kj · value_ij with a lognormal scale s_kj per family;
    6. b_kj = rho_kj · (l_kj + rhs_eps), rho ~ U[rho_low, rho_high] and l_kj
       the greedy load: each source sends its largest-a_k edge, at its
       budget, to that destination;
    7. c = -value (the solver minimizes).

The instance is drawn once from the configuration's `instance_seed`;
`--seed` then relabels its sources and destinations by two random
permutations (`instance`).  So every seed gives the same LP, the same
sizes and the same work, in another order: the order of every array, of
the slabs' rows and of the Ax plan, and with them the order of every
float32 sum.  Every draw comes from a `torch.Generator` on the device the
run uses, so the same seed gives the same arrays bit for bit.
The law is a copy of the one the program's own generator follows; the
benchmark never calls that generator, so a change to the program cannot
change the inputs.  `generate` returns the raw arrays (`Raw`) that the
plain reference reads; `to_port_lp` packs them into the program's slab
layout, which only the program reads.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# splitmix64's constants as signed 64-bit integers (torch has no uint64
# arithmetic; int64 multiplication wraps as uint64 does)
_MASK64 = (1 << 64) - 1


def _s64(v: int) -> int:
    v &= _MASK64
    return v - (1 << 64) if v >= 1 << 63 else v


_GOLDEN = _s64(0x9E3779B97F4A7C15)
_MIX1 = _s64(0xBF58476D1CE4E5B9)
_MIX2 = _s64(0x94D049BB133111EB)
_EDGE_MUL = _s64(0x100000001B3)
_SEED_MUL = 0x9E3779B1
_ALT = _s64(0xDEADBEEF)


class Raw(NamedTuple):
    """One generated instance as flat arrays.  Edges are sorted by
    (source, destination); `sources` lists each source that has an edge,
    ascending, with its first edge `start`, its degree `deg` and its
    budget `s`."""

    num_sources: int          # I
    src: torch.Tensor         # (E,) int64
    dst: torch.Tensor         # (E,) int64
    value: torch.Tensor       # (E,) float32, the objective's value (c = -value)
    a: torch.Tensor           # (m, E) float32
    ub: torch.Tensor          # (E,) float32
    sources: torch.Tensor     # (S,) int64
    start: torch.Tensor       # (S,) int64
    deg: torch.Tensor         # (S,) int64
    s: torch.Tensor           # (S,) float32
    b: torch.Tensor           # (m, J) float32

    @property
    def m(self) -> int:
        return self.b.shape[0]

    @property
    def num_destinations(self) -> int:
        return self.b.shape[1]

    @property
    def num_edges(self) -> int:
        return self.src.numel()


def _lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    x = x + _GOLDEN
    x = (x ^ _lsr(x, 30)) * _MIX1
    x = (x ^ _lsr(x, 27)) * _MIX2
    return x ^ _lsr(x, 31)


def _unit(h: torch.Tensor) -> torch.Tensor:
    """The top 53 bits of a hash as a float64 in (0, 1]."""
    return (_lsr(h, 11).to(torch.float64) + 1.0) / float(1 << 53)


def hash_lognormal(seed: int, src: torch.Tensor, dst: torch.Tensor,
                   sigma: float) -> torch.Tensor:
    """Per-edge lognormal(0, sigma) noise from a hash of (seed, i, j)."""
    key = src * _EDGE_MUL + dst + _s64(seed * _SEED_MUL)
    u1 = _unit(splitmix64(key))
    u2 = _unit(splitmix64(key ^ _ALT))
    normal = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * torch.pi * u2)
    return torch.exp(sigma * normal)


def _lognormal(g: torch.Generator, sigma: float, size, device):
    return torch.exp(sigma * torch.randn(size, generator=g, device=device,
                                         dtype=torch.float64))


def distinct_sources(K: torch.Tensor, I: int, g: torch.Generator):
    """(src, dst) with K[j] distinct sources in [0, I) for each
    destination j, sorted by (dst, src).  Draws with replacement, drops
    repeats, keeps a random K[j] of each destination's draws, and draws
    again for the destinations still short."""
    device = K.device
    J = K.numel()
    keys = torch.zeros(0, dtype=torch.int64, device=device)
    have = torch.zeros(J, dtype=torch.int64, device=device)
    while True:
        need = K - have
        if int(need.max()) <= 0:
            break
        draws = torch.where(need > 0, need + need // 8 + 8,
                            torch.zeros_like(need))
        dst = torch.repeat_interleave(torch.arange(J, device=device), draws)
        src = torch.randint(0, I, (dst.numel(),), generator=g, device=device)
        keys = torch.unique(torch.cat([keys, dst * I + src]))
        d = keys // I
        # a random order within each destination, then its first K[j]
        prio = torch.rand(keys.numel(), generator=g, device=device,
                          dtype=torch.float64)
        order = torch.sort(d.to(torch.float64) + prio, stable=True).indices
        keys, d = keys[order], d[order]
        first = torch.searchsorted(d, torch.arange(J, device=device))
        rank = torch.arange(keys.numel(), device=device) - first[d]
        keys = torch.sort(keys[rank < K[d]]).values
        have = torch.bincount(keys // I, minlength=J)
    return keys % I, keys // I


def generate(spec: dict, seed: int, device) -> Raw:
    """The instance of `spec` (a configuration's "instance" block) for
    `seed`, on `device`."""
    device = torch.device(device)
    I, J = int(spec["num_sources"]), int(spec["num_destinations"])
    m = int(spec["num_families"])
    nu = float(spec["avg_nnz_per_row"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & _MASK64)
    breadth = _lognormal(g, spec["breadth_sigma"], J, device)
    p = breadth / breadth.sum()
    K = torch.clamp_max(torch.poisson(p * (I * nu), generator=g),
                        I).to(torch.int64)
    src, dst = distinct_sources(K, I, g)
    # edges in (source, destination) order
    order = torch.sort(src * J + dst).indices
    src, dst = src[order], dst[order]
    v = _lognormal(g, spec["value_sigma"], J, device)
    scale = _lognormal(g, spec["scale_sigma"], (m, J), device)
    u = _lognormal(g, spec["value_sigma"], I, device)
    rho = (spec["rho_low"] + (spec["rho_high"] - spec["rho_low"])
           * torch.rand((m, J), generator=g, device=device,
                        dtype=torch.float64))
    eps = hash_lognormal(int(seed), src, dst, spec["noise_sigma"])
    value = torch.clamp_max(v[dst] * u[src] * eps, spec["c_max"])
    a = scale[:, dst] * value[None, :]                      # (m, E) float64
    sources, deg = torch.unique_consecutive(src, return_counts=True)
    start = torch.cumsum(deg, 0) - deg
    budget = float(spec["budget_s"])
    b = torch.empty((m, J), dtype=torch.float64, device=device)
    last = start + deg - 1
    for k in range(m):
        # each source's largest-a_k edge: sort by a within the source
        key = torch.sort(a[k], stable=True).indices
        by_src = key[torch.sort(src[key], stable=True).indices]
        top = by_src[last]
        # summed on the host in index order, the same bits every run
        load = torch.bincount(dst[top].cpu(), weights=(a[k, top] * budget)
                              .cpu(), minlength=J)
        b[k] = rho[k] * (load.to(device) + spec["rhs_eps"])
    E = src.numel()
    return Raw(num_sources=I, src=src, dst=dst,
               value=value.to(torch.float32), a=a.to(torch.float32),
               ub=torch.full((E,), float(spec["box_ub"]),
                             dtype=torch.float32, device=device),
               sources=sources, start=start, deg=deg,
               s=torch.full((sources.numel(),), budget, dtype=torch.float32,
                            device=device),
               b=b.to(torch.float32))


def relabel(raw: Raw, seed: int) -> Raw:
    """The same LP with source i renamed p(i) and destination j renamed
    q(j), p and q random permutations drawn from `seed`; edges sorted by
    (source, destination) again."""
    dev = raw.src.device
    I, J = raw.num_sources, raw.num_destinations
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) & _MASK64)
    p = torch.randperm(I, generator=g, device=dev)
    q = torch.randperm(J, generator=g, device=dev)
    src, dst = p[raw.src], q[raw.dst]
    order = torch.sort(src * J + dst).indices
    src, dst = src[order], dst[order]
    s_of = torch.zeros(I, dtype=raw.s.dtype, device=dev)
    s_of[p[raw.sources]] = raw.s
    sources, deg = torch.unique_consecutive(src, return_counts=True)
    b = torch.empty_like(raw.b)
    b[:, q] = raw.b
    return Raw(num_sources=I, src=src, dst=dst, value=raw.value[order],
               a=raw.a[:, order], ub=raw.ub[order], sources=sources,
               start=torch.cumsum(deg, 0) - deg, deg=deg, s=s_of[sources],
               b=b)


def instance(spec: dict, seed: int, device) -> Raw:
    """The configuration's instance (`spec["instance_seed"]`) relabelled
    by `seed`."""
    return relabel(generate(spec, spec["instance_seed"], device), seed)


def widths(deg: torch.Tensor, min_width: int) -> torch.Tensor:
    """Each source's padded width: the next power of two of its degree,
    at least `min_width`."""
    w = torch.ones_like(deg)
    while bool((w < deg).any()):
        w = torch.where(w < deg, w * 2, w)
    return torch.clamp_min(w, min_width)


def to_port_lp(raw: Raw, min_width: int):
    """The program's input: sources bucketed by padded width into
    (n, w) slabs, rows in ascending source id, each row's edges in
    ascending destination."""
    from repro_torch.core.types import LPData, Slab
    w_all = widths(raw.deg, min_width)
    slabs = []
    for w in torch.unique(w_all).tolist():
        rows = torch.nonzero(w_all == w).reshape(-1)
        n = rows.numel()
        lane = torch.arange(w, device=rows.device)
        mask = lane[None, :] < raw.deg[rows][:, None]
        idx = torch.where(mask, raw.start[rows][:, None] + lane[None, :], 0)
        zero = torch.zeros((), dtype=torch.float32, device=rows.device)
        slabs.append(Slab(
            a_vals=torch.where(mask[..., None], raw.a[:, idx].permute(1, 2, 0),
                               zero).contiguous(),
            c_vals=torch.where(mask, -raw.value[idx], zero),
            dest_idx=torch.where(mask, raw.dst[idx], 0).to(torch.int32),
            mask=mask,
            ub=torch.where(mask, raw.ub[idx], zero),
            s=raw.s[rows].clone(),
            source_ids=raw.sources[rows].to(torch.int32)))
    return LPData(slabs=tuple(slabs), b=raw.b.clone())
