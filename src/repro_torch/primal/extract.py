"""Streaming primal extraction: duals → decisions in source-block chunks;
port of `repro.primal.extract` (the batch half of DESIGN.md §8).

Every slab is walked in fixed-size windows of `chunk_rows` source rows;
each window's x*(λ) comes from the objective's row-subset op
(`primal_rows`, the same per-row sweep and kernel as the solve) and is
copied to the host, where it lands in per-slab arrays or in `.npz` shards.
Nothing larger than one (chunk_rows, w) block of one slab is materialized
on the device beyond λ and the LP.

Windows are shape-stable: the tail window of a slab is clamped at the
slab's last row (its duplicate rows compute real row n−1 values, which
are dropped on the host), so every window of a slab has the same shape,
and shard names, `start`s and `source_ids` are the reference's.  Per-row
results do not depend on the split (K1's layout depends on the width
alone), so the result equals `obj.primal(λ)` bit for bit.

The reference's per-(objective, slab) jit cache (`primal_rows_fn`) has
no counterpart: the port calls `obj.primal_rows` eagerly.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch


def rows_to_host(x: torch.Tensor) -> np.ndarray:
    """A (rows, w) decision block as a float32 host array (one copy)."""
    return x.float().cpu().numpy()


@dataclasses.dataclass(frozen=True)
class PrimalChunk:
    """One extracted source-block: the decisions of `rows` of one slab.

    Arrays are host numpy, already trimmed to the real rows of the chunk
    (the clamped tail overhang is gone).  `x` is (n_chunk, w) with zeros
    on padded edge positions; `dest_idx`/`mask` are the matching slab
    rows, so `(source_ids[r], dest_idx[r, q], x[r, q])` for mask[r, q]
    enumerates the chunk's real allocations.
    """

    slab_index: int
    start: int
    source_ids: np.ndarray     # (n_chunk,)
    dest_idx: np.ndarray       # (n_chunk, w)
    mask: np.ndarray           # (n_chunk, w)
    x: np.ndarray              # (n_chunk, w)


def iter_primal_chunks(obj, lam, gamma, chunk_rows: int = 4096,
                       slab_indices: Optional[Sequence[int]] = None,
                       sampler=None) -> Iterator[PrimalChunk]:
    """Yield x*(λ) chunk by chunk over source-row blocks (module doc).
    `sampler` (a `repro_torch.obs.MemorySampler`) is read once a chunk,
    after the chunk's host copy; None reads nothing."""
    dev = obj.lp.b.device
    lam = torch.as_tensor(lam, device=dev)
    gamma = torch.as_tensor(gamma, dtype=torch.float32, device=dev)
    sel = range(len(obj.lp.slabs)) if slab_indices is None else slab_indices
    for si in sel:
        slab = obj.lp.slabs[si]
        n = slab.n
        c = max(1, min(int(chunk_rows), n))
        ids = slab.source_ids.cpu().numpy()
        dest = slab.dest_idx.cpu().numpy()
        mask = slab.mask.cpu().numpy()
        for start in range(0, n, c):
            take = min(c, n - start)
            # fixed-shape window, clamped at the slab end; the duplicate
            # tail rows compute real (row n−1) values and are dropped here
            idx = np.minimum(np.arange(start, start + c), n - 1)
            x = rows_to_host(obj.primal_rows(
                lam, gamma, si, torch.from_numpy(idx).to(dev)))[:take]
            real = idx[:take]
            if sampler is not None:
                sampler.sample(where="extract", it=start)
            yield PrimalChunk(slab_index=si, start=start,
                              source_ids=ids[real], dest_idx=dest[real],
                              mask=mask[real], x=x)


def extract_primal(obj, lam, gamma, chunk_rows: int = 4096,
                   sampler=None) -> List[np.ndarray]:
    """Assembled per-slab (n, w) float32 host decision arrays from the
    chunked recovery, equal to `obj.primal(λ)` bit for bit, sampled or
    not (`sampler` as in `iter_primal_chunks`)."""
    out = [np.zeros(tuple(s.c_vals.shape), np.float32)
           for s in obj.lp.slabs]
    for ch in iter_primal_chunks(obj, lam, gamma, chunk_rows,
                                 sampler=sampler):
        out[ch.slab_index][ch.start:ch.start + len(ch.x)] = ch.x
    return out


def _shard_name(slab_index: int, start: int) -> str:
    return f"primal_s{slab_index:03d}_r{start:09d}.npz"


def write_shards(obj, lam, gamma, out_dir: str, chunk_rows: int = 4096,
                 rounder=None, sampler=None) -> List[str]:
    """Stream-extract to `.npz` shards, one per chunk (the export path).

    Each shard holds `slab_index`, `start`, `source_ids`, `dest_idx`,
    `mask`, `x` — and `x_round` when a `rounder(chunk) -> (n, w) array`
    is supplied (chunk-local rounding only; capacity-respecting repair is
    a global pass and lives in `primal.rounding`/`primal.certify`).
    Returns the shard paths in write order.  `sampler` as in
    `iter_primal_chunks`.
    """
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for ch in iter_primal_chunks(obj, lam, gamma, chunk_rows,
                                 sampler=sampler):
        payload = dict(slab_index=np.int64(ch.slab_index),
                       start=np.int64(ch.start),
                       source_ids=ch.source_ids, dest_idx=ch.dest_idx,
                       mask=ch.mask, x=ch.x)
        if rounder is not None:
            payload["x_round"] = np.asarray(rounder(ch))
        path = os.path.join(out_dir, _shard_name(ch.slab_index, ch.start))
        np.savez(path, **payload)
        paths.append(path)
    return paths


def read_shards(paths: Sequence[str], num_slabs: int,
                key: str = "x") -> List[Optional[np.ndarray]]:
    """Reassemble per-slab decision arrays from `write_shards` output.

    `key` selects which decision array to read ("x" or "x_round").
    Slabs with no shards come back as None (partial exports are legal).

    Defensive against a damaged export (DESIGN.md §12 hardening): a
    missing file, an unreadable/truncated `.npz`, a shard without the
    requested key or the `slab_index`/`start` metadata, an out-of-range
    slab index, a decision array that is not 2-D, or a width mismatch
    between shards of the same slab all raise ValueError NAMING THE
    OFFENDING SHARD PATH — never a bare KeyError/zipfile error from deep
    inside numpy, and never a silently mis-assembled result.
    """
    parts: dict = {}
    for path in paths:
        if not os.path.exists(path):
            raise ValueError(f"shard missing: {path}")
        try:
            z = np.load(path)
        except Exception as e:
            raise ValueError(
                f"shard unreadable (corrupt or truncated): {path} "
                f"({type(e).__name__}: {e})") from e
        with z:
            for field in ("slab_index", "start", key):
                if field not in z.files:
                    raise ValueError(
                        f"shard missing array {field!r}: {path} "
                        f"(has {sorted(z.files)})")
            try:
                si, start = int(z["slab_index"]), int(z["start"])
                arr = z[key]
            except Exception as e:   # a torn member inside a valid zip
                raise ValueError(
                    f"shard unreadable (corrupt or truncated): {path} "
                    f"({type(e).__name__}: {e})") from e
            if not 0 <= si < num_slabs:
                raise ValueError(
                    f"shard slab_index {si} out of range "
                    f"[0, {num_slabs}): {path}")
            if arr.ndim != 2:
                raise ValueError(
                    f"shard {key!r} has shape {arr.shape}, expected "
                    f"(rows, w): {path}")
            parts.setdefault(si, []).append((start, arr, path))
    out: List[Optional[np.ndarray]] = [None] * num_slabs
    for si, chunks in parts.items():
        chunks.sort(key=lambda t: t[0])
        w = chunks[0][1].shape[1]
        for start, arr, path in chunks[1:]:
            if arr.shape[1] != w:
                raise ValueError(
                    f"shard width mismatch in slab {si}: {path} has "
                    f"w={arr.shape[1]}, expected w={w} (from "
                    f"{chunks[0][2]})")
        out[si] = np.concatenate([c for _, c, _ in chunks], axis=0)
    return out
