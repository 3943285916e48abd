"""Chunked primal extraction: duals → decisions in source-row blocks; port
of `repro.primal.extract` (the batch half of DESIGN.md §8).

Every slab is walked in blocks of `chunk_rows` source rows; each block's
x*(λ) comes from the objective's row-subset op (`primal_rows`, the same
per-row sweep and kernel as the solve), is copied to the host, and lands in
per-slab numpy arrays.  Nothing larger than one block of one slab is
materialized on the device beyond λ and the LP.  Per-row results do not
depend on the split, so the result equals `obj.primal(λ)` bit for bit.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch


def extract_primal(obj, lam, gamma, chunk_rows: int = 4096) -> List[np.ndarray]:
    """Per-slab (n, w) host decision arrays, computed chunk by chunk."""
    dev = obj.lp.b.device
    lam = torch.as_tensor(lam, device=dev)
    gamma = torch.as_tensor(gamma, dtype=torch.float32, device=dev)
    out = []
    for si, slab in enumerate(obj.lp.slabs):
        n = slab.n
        xs = np.zeros(tuple(slab.c_vals.shape), np.float32)
        c = max(1, min(int(chunk_rows), n))
        for start in range(0, n, c):
            rows = torch.arange(start, min(start + c, n), device=dev)
            xs[start:start + len(rows)] = (
                obj.primal_rows(lam, gamma, si, rows).float().cpu().numpy())
        out.append(xs)
    return out
