"""Synthetic matching-LP generator — paper Appendix B (port of `repro.core.instance`).

Host numpy, copied from the reference so that the port imports nothing of
it: the splitmix64 hash and the lognormal draws are bit-identical, and so
is every packed array (tests/test_torch_instance.py).  Leaves stay numpy;
`repro_torch.convert` moves an instance onto a device.

Construction (host-side numpy; deterministic given a seed):
  1. lognormal "breadth" per resource j, normalized to probabilities p_j;
  2. K_j ~ Poisson(p_j · I · ν) truncated at I  (ν = target avg nnz per row);
  3. K_j distinct requests selected per resource -> edges (i, j);
  4. value c_ij = min(v_j · u_i · ε_ij, c_max) with lognormal v_j (resource
     scale), u_i (request responsiveness), ε_ij (noise);
  5. constraint a_ij = s_j · c_ij, lognormal per-resource scale s_j;
  6. rhs b_j = ρ_j (ℓ_j + ε), ρ_j ~ U[0.5, 1], ℓ_j the greedy load: each
     request sends its single largest-a_ij edge to that resource;
  7. objective sign flipped to match the minimization convention (we maximize
     value, so c := −value).

The result is packed into the bucketed-slab `LPData` layout (DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .types import AxBucket, AxPlan, LPData, Slab


class LPValidationError(ValueError):
    """An LP instance failed `validate_lp`.  `problems` lists every
    violation found (not just the first), so a bad ingestion run reports
    all of its defects in one failure."""

    def __init__(self, name: str, problems):
        self.problems = tuple(problems)
        lines = "\n".join(f"  - {p}" for p in self.problems)
        super().__init__(
            f"invalid LP instance {name!r} "
            f"({len(self.problems)} problem(s)):\n{lines}")


def validate_lp(lp: LPData, name: str = "lp") -> LPData:
    """Fail fast on a malformed instance instead of producing NaN duals
    mid-solve (DESIGN.md §9).

    Checks (host-side, one pass over the instance):
      * b: 2-D (m, J), finite, no negative capacities;
      * every slab: field shapes consistent ((n, w[, m]) with the slab's
        own n/w/m), m matching b, dest_idx of real edges within [0, J);
      * real (mask=True) entries of a_vals / c_vals / ub and the per-source
        budget s finite; s and real ub non-negative (negative capacity);
      * padded (mask=False) entries are not checked — they are inert by
        construction.

    Raises LPValidationError listing every problem; returns `lp` unchanged
    so call sites can write `lp = validate_lp(lp)`.
    """
    problems = []
    b = np.asarray(lp.b)
    if b.ndim != 2:
        problems.append(f"b must be 2-D (m, J), got shape {b.shape}")
        raise LPValidationError(name, problems)   # m/J unusable below
    m, J = b.shape
    if not np.isfinite(b).all():
        bad = int(np.size(b) - np.isfinite(b).sum())
        problems.append(f"b has {bad} non-finite entr(ies) (NaN/Inf rhs)")
    if (b < 0).any():
        problems.append(
            f"b has {int((b < 0).sum())} negative capacit(ies); "
            f"min b = {float(np.nanmin(b)):g}")
    for si, slab in enumerate(lp.slabs):
        tag = f"slab[{si}]"
        c = np.asarray(slab.c_vals)
        if c.ndim != 2:
            problems.append(f"{tag}: c_vals must be (n, w), got {c.shape}")
            continue
        n, w = c.shape
        shapes = {"a_vals": ((n, w, m), slab.a_vals),
                  "dest_idx": ((n, w), slab.dest_idx),
                  "mask": ((n, w), slab.mask),
                  "ub": ((n, w), slab.ub),
                  "s": ((n,), slab.s),
                  "source_ids": ((n,), slab.source_ids)}
        mismatched = False
        for field, (want, arr) in shapes.items():
            got = tuple(np.shape(arr))
            if got != want:
                problems.append(
                    f"{tag}: {field} shape {got} != expected {want} "
                    f"(n={n}, w={w}, m={m})")
                mismatched = True
        if mismatched:
            continue
        mask = np.asarray(slab.mask).astype(bool)
        for field, arr in (("a_vals", slab.a_vals), ("c_vals", c),
                           ("ub", slab.ub)):
            vals = np.asarray(arr)
            fin = np.isfinite(vals) if field != "ub" else (
                ~np.isnan(vals))          # ub=inf means "no bound" — legal
            ok = fin if field != "a_vals" else fin.all(axis=-1)
            bad = int((~ok & mask).sum())
            if bad:
                problems.append(
                    f"{tag}: {field} has {bad} non-finite value(s) on "
                    f"real edges")
        s = np.asarray(slab.s)
        if np.isnan(s).any():
            problems.append(f"{tag}: s has {int(np.isnan(s).sum())} NaN "
                            f"budget(s)")
        elif (s < 0).any():
            problems.append(
                f"{tag}: s has {int((s < 0).sum())} negative budget(s); "
                f"min s = {float(s.min()):g}")
        ub = np.asarray(slab.ub)
        neg_ub = int(((ub < 0) & mask).sum())
        if neg_ub:
            problems.append(f"{tag}: ub has {neg_ub} negative upper "
                            f"bound(s) on real edges")
        di = np.asarray(slab.dest_idx)
        oob = int((((di < 0) | (di >= J)) & mask).sum())
        if oob:
            problems.append(
                f"{tag}: dest_idx has {oob} real edge(s) outside [0, {J})")
    if problems:
        raise LPValidationError(name, problems)
    return lp


@dataclasses.dataclass(frozen=True)
class InstanceSpec:
    num_sources: int = 1000          # I (paper: "requests")
    num_destinations: int = 50       # J (paper: "resources")
    avg_nnz_per_row: float = 20.0    # ν
    num_families: int = 1            # m constraint families (paper allows >1)
    c_max: float = 10.0
    breadth_sigma: float = 1.0       # lognormal σ for resource breadth
    value_sigma: float = 0.5         # lognormal σ for v_j, u_i
    noise_sigma: float = 0.25        # lognormal σ for ε_ij
    scale_sigma: float = 1.0         # lognormal σ for s_j  (drives row-norm spread)
    rho_low: float = 0.5
    rho_high: float = 1.0
    rhs_eps: float = 1e-3
    budget_s: float = 1.0            # per-source simplex budget (Σ_j x_ij <= s)
    box_ub: float = 1.0              # per-edge upper bound for boxcut
    min_width: int = 4               # smallest slab width (power of two)
    seed: int = 0


def _edges(spec: InstanceSpec) -> Tuple[np.ndarray, np.ndarray]:
    """Edge list (src, dst) per Appendix B steps 1-3."""
    rng = np.random.default_rng(spec.seed)
    I, J = spec.num_sources, spec.num_destinations
    breadth = rng.lognormal(mean=0.0, sigma=spec.breadth_sigma, size=J)
    p = breadth / breadth.sum()
    # Paper: K_j ~ Poisson(p_j I ν), truncated at I.
    K = np.minimum(rng.poisson(p * I * spec.avg_nnz_per_row), I)
    src_list, dst_list = [], []
    for j in range(J):
        if K[j] == 0:
            continue
        # K_j distinct requests for resource j (deterministic per (seed, j))
        sub = np.random.default_rng((spec.seed, 1, j))
        picks = sub.choice(I, size=int(K[j]), replace=False)
        src_list.append(picks)
        dst_list.append(np.full(int(K[j]), j, dtype=np.int64))
    if not src_list:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(src_list), np.concatenate(dst_list)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 — cheap, high-quality 64-bit mixing."""
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)).astype(np.uint64)
        x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)).astype(np.uint64)
        return x ^ (x >> np.uint64(31))


def _hash_lognormal(seed: int, src: np.ndarray, dst: np.ndarray, sigma: float) -> np.ndarray:
    """Per-edge lognormal(0, σ) noise from a counter-based hash (no RNG state)."""
    if len(src) == 0:
        return np.zeros(0)
    with np.errstate(over="ignore"):
        key = (src.astype(np.uint64) * np.uint64(0x100000001B3)
               + dst.astype(np.uint64) + np.uint64(seed) * np.uint64(0x9E3779B1))
    u1 = (_splitmix64(key).astype(np.float64) + 1.0) / 2.0**64          # (0, 1]
    u2 = (_splitmix64(key ^ np.uint64(0xDEADBEEF)).astype(np.float64) + 1.0) / 2.0**64
    normal = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)      # Box–Muller
    return np.exp(sigma * normal)


def _coefficients(spec: InstanceSpec, src: np.ndarray, dst: np.ndarray):
    """Values/coefficients per Appendix B steps 4-5 (deterministic per edge)."""
    I, J = spec.num_sources, spec.num_destinations
    rj = np.random.default_rng((spec.seed, 2))
    v = rj.lognormal(0.0, spec.value_sigma, size=J)       # resource value scale
    s_scale = rj.lognormal(0.0, spec.scale_sigma, size=(spec.num_families, J))
    ri = np.random.default_rng((spec.seed, 3))
    u = ri.lognormal(0.0, spec.value_sigma, size=I)       # request responsiveness
    # Edge noise keyed by a hash of (seed, src, dst): independent of how the
    # sources are partitioned.
    eps = _hash_lognormal(spec.seed, src, dst, spec.noise_sigma)
    value = np.minimum(v[dst] * u[src] * eps, spec.c_max)
    a = s_scale[:, dst] * value[None, :]                  # (m, nnz)
    return value, a


def _rhs(spec: InstanceSpec, src, dst, a) -> np.ndarray:
    """b_j = ρ_j(ℓ_j + ε) with greedy load ℓ_j (Appendix B)."""
    J, m = spec.num_destinations, spec.num_families
    b = np.zeros((m, J))
    rng = np.random.default_rng((spec.seed, 6))
    rho = rng.uniform(spec.rho_low, spec.rho_high, size=(m, J))
    for k in range(m):
        load = np.zeros(J)
        if len(src):
            # per request, its largest-a edge goes fully to that resource
            order = np.lexsort((a[k], src))  # sorted by src then a ascending
            # last entry per src is the max-a edge
            last = np.ones(len(src), dtype=bool)
            last[:-1] = src[order][1:] != src[order][:-1]
            idx = order[last]
            np.add.at(load, dst[idx], a[k][idx] * spec.budget_s)
        b[k] = rho[k] * (load + spec.rhs_eps)
    return b


def pack_slabs(src, dst, value, a, spec: InstanceSpec) -> LPData:
    """Bucket sources by ⌈log2 degree⌉ and pack padded slabs (DESIGN.md §2)."""
    I, J, m = spec.num_sources, spec.num_destinations, spec.num_families
    order = np.argsort(src, kind="stable")
    src, dst, value, a = src[order], dst[order], value[order], a[:, order]
    # group edges per source (vectorized bucketed gather — no per-row loop)
    uniq, start = np.unique(src, return_index=True)
    degs = np.diff(np.append(start, len(src)))
    widths = np.maximum(spec.min_width,
                        1 << np.ceil(np.log2(np.maximum(degs, 1))).astype(np.int64))
    slabs = []
    for w in sorted(set(widths.tolist())):
        rows = np.nonzero(widths == w)[0]
        n = len(rows)
        st, dg = start[rows], degs[rows]
        idx = st[:, None] + np.arange(w)[None, :]            # (n, w) edge gather
        msk = np.arange(w)[None, :] < dg[:, None]
        idx = np.where(msk, idx, 0).astype(np.int64)
        a_v = np.where(msk[..., None], a[:, idx].transpose(1, 2, 0), 0.0)
        c_v = np.where(msk, -value[idx], 0.0)                # minimization convention
        d_i = np.where(msk, dst[idx], 0)
        slabs.append(Slab(
            a_vals=a_v.astype(np.float32), c_vals=c_v.astype(np.float32),
            dest_idx=d_i.astype(np.int32), mask=msk,
            ub=np.where(msk, np.float32(spec.box_ub), 0.0).astype(np.float32),
            s=np.full(n, spec.budget_s, np.float32),
            source_ids=uniq[rows].astype(np.int32),
        ))
    b = _rhs(spec, src, dst, a)
    return LPData(slabs=tuple(slabs), b=b.astype(np.float32))


def _flat_edges(slabs):
    """(dest, flat_idx) of every real edge in the concatenated slab-edge
    space."""
    dests, idxs, off = [], [], 0
    for s in slabs:
        d = np.asarray(s.dest_idx).reshape(-1)
        mk = np.asarray(s.mask).astype(bool).reshape(-1)
        keep = np.nonzero(mk)[0]
        dests.append(d[keep])
        idxs.append(off + keep)
        off += d.size
    if not dests:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), off
    return (np.concatenate(dests).astype(np.int64),
            np.concatenate(idxs).astype(np.int64), off)


def _pow2_widths(indeg: np.ndarray, min_width: int) -> np.ndarray:
    return np.maximum(min_width,
                      1 << np.ceil(np.log2(np.maximum(indeg, 1)))
                      .astype(np.int64))


def _flat_a(slabs) -> np.ndarray:
    """(E, m) constraint weights in the concatenated slab-edge space (the
    same flattening order as `_flat_edges`; 0 on padded positions)."""
    parts = [np.asarray(s.a_vals).reshape(-1, np.asarray(s.a_vals).shape[-1])
             for s in slabs]
    if not parts:
        return np.zeros((0, 1), np.float32)
    return np.concatenate(parts, axis=0)


def _pack_ax_rows(dest, idx, J: int, widths: np.ndarray,
                  a_flat: Optional[np.ndarray] = None):
    """Pack per-destination gather rows under a fixed width assignment.

    Returns ([(edge_idx, mask, dest_ids, a_dm)] per distinct width, row_pos)
    with row_pos[j] = position of destination j in the bucket-concatenated
    rows; a_dm is None when `a_flat` is not supplied (index-only plan).
    """
    order = np.argsort(dest, kind="stable")
    dest_s, idx_s = dest[order], idx[order]
    indeg = np.bincount(dest_s, minlength=J)[:J]
    start = np.zeros(J, np.int64)
    start[1:] = np.cumsum(indeg)[:-1]
    buckets, row_pos, pos = [], np.zeros(J, np.int64), 0
    for w in sorted(set(widths.tolist())):
        rows = np.nonzero(widths == w)[0]
        r = len(rows)
        gather = start[rows][:, None] + np.arange(w)[None, :]
        msk = np.arange(w)[None, :] < indeg[rows][:, None]
        safe = np.where(msk, gather, 0)
        eidx = (np.where(msk, idx_s[safe], 0) if idx_s.size
                else np.zeros((r, w), np.int64))
        a_dm = None
        if a_flat is not None:
            # value-carrying layout: destination-major static weight copy
            # a_dm[r, q] = a_flat[edge_idx[r, q]], zero on padding
            a_dm = (np.where(msk[..., None], a_flat[eidx], 0.0)
                    .astype(a_flat.dtype) if a_flat.size
                    else np.zeros((r, w, a_flat.shape[-1]), a_flat.dtype))
        buckets.append((eidx.astype(np.int32), msk,
                        rows.astype(np.int32), a_dm))
        row_pos[rows] = pos + np.arange(r)
        pos += r
    return buckets, row_pos


def build_ax_plan(lp: LPData, min_width: int = 4,
                  carry_values: bool = True) -> AxPlan:
    """Pack the destination-major companion layout (DESIGN.md §3),
    host-side, once per instance.

    Destinations are bucketed by ⌈log2 in-degree⌉ into padded power-of-two
    rows, mirroring `pack_slabs`' source-side bucketing; every destination
    (including in-degree 0) occupies exactly one row.  `carry_values=True`
    (default) packs each bucket's static weight copy `a_dm`, so the Ax
    reduction consumes the (E,) x vector directly
    (`kernels.ops.ax_aligned_x`); `carry_values=False` packs the
    index-only plan (a_dm None) the gvals-based `kernels.ops.ax_aligned`
    consumes.
    """
    J = lp.num_destinations
    dest, idx, _ = _flat_edges(lp.slabs)
    widths = _pow2_widths(np.bincount(dest, minlength=J)[:J], min_width)
    buckets, row_pos = _pack_ax_rows(
        dest, idx, J, widths, _flat_a(lp.slabs) if carry_values else None)
    return AxPlan(
        buckets=tuple(AxBucket(edge_idx=e, mask=m, dest_ids=d, a_dm=a)
                      for e, m, d, a in buckets),
        inv_perm=row_pos.astype(np.int32))


def generate(spec: InstanceSpec) -> LPData:
    """Generate an instance (host numpy leaves)."""
    src, dst = _edges(spec)
    value, a = _coefficients(spec, src, dst)
    return pack_slabs(src, dst, value, a, spec)
