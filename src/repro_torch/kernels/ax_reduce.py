"""The Ax reduction of one plan bucket: the wrappers of the `ax_reduce_x`
(K2) and `ax_reduce` (K4) kernels.

Ports of `repro.kernels.ax_reduce.ax_reduce_bucket_x` (value-carrying)
and `ax_reduce_bucket` (gvals-consuming):

    K2  ax[k, dest_ids[r]] = Σ_q mask[r, q] · a_dm[r, q, k] · x[edge_idx[r, q]]
    K4  ax[k, dest_ids[r]] = Σ_q mask[r, q] · gvals[edge_idx[r, q], k]

Every destination owns exactly one plan row, so the result goes straight
into the columns `dest_ids` of the caller's (m, J) float32 buffer; the
reference's row concatenation and `inv_perm` gather are not needed.  For
tensors on the card the wrappers launch `csrc/ax_reduce_x.cu` and
`csrc/ax_reduce.cu` (one row-sum body, `csrc/ax_rows.cuh`); for tensors
on the CPU they run the plain versions `ref.ax_reduce_x_ref` and
`ref.ax_reduce_ref`.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import ax_reduce_ref, ax_reduce_x_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(fn_name, dtype, dev, tensors):
    if dev.type != "cuda":
        raise ValueError(f"{fn_name}: unsupported device {dev}")
    if dtype not in _DTYPES:
        raise TypeError(f"{fn_name}: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    for name, t, shape, dt in tensors:
        _build.check_tensor(fn_name, name, t, shape, dt, dev)


def ax_reduce_bucket_x(x, a_dm, edge_idx, mask, dest_ids, out):
    """Reduce one value-carrying bucket into `out[:, dest_ids]` (K2).

    x (E,) and a_dm (r, w, m) float32 or bfloat16 (the same); edge_idx
    (r, w) and dest_ids (r,) int32; mask (r, w) bool; out (m, J) float32.
    Returns `out`.
    """
    r, w, m = a_dm.shape
    dev = x.device
    if dev.type == "cpu":
        out[:, dest_ids.long()] = ax_reduce_x_ref(x, a_dm, edge_idx, mask).T
        return out
    dtype, J = x.dtype, out.shape[1]
    _check("ax_reduce_bucket_x", dtype, dev, (
        ("x", x, (x.shape[0],), dtype), ("a_dm", a_dm, (r, w, m), dtype),
        ("edge_idx", edge_idx, (r, w), torch.int32),
        ("mask", mask, (r, w), torch.bool),
        ("dest_ids", dest_ids, (r,), torch.int32),
        ("out", out, (m, J), torch.float32)))
    if r == 0 or w == 0:
        return out
    lib = _build.build()["ax_reduce_x"]
    if m > lib.ax_reduce_x_max_families():
        raise ValueError(f"ax_reduce_bucket_x: m={m} exceeds the kernel's "
                         f"{lib.ax_reduce_x_max_families()} families")
    scratch = torch.empty(max(int(lib.ax_reduce_x_scratch(r, w, m)), 1),
                          dtype=torch.float32, device=dev)
    rc = lib.ax_reduce_x_launch(
        _DTYPES[dtype], x.data_ptr(), a_dm.data_ptr(), edge_idx.data_ptr(),
        mask.data_ptr(), dest_ids.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), r, w, m, J,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "ax_reduce_x kernel launch")
    ax_reduce_bucket_x.launches += 1
    return out


def ax_reduce_bucket(gvals, edge_idx, mask, dest_ids, out):
    """Reduce one index-only bucket into `out[:, dest_ids]` (K4).

    gvals (E, m) float32 or bfloat16; edge_idx (r, w) and dest_ids (r,)
    int32; mask (r, w) bool; out (m, J) float32.  Returns `out`.
    """
    r, w = edge_idx.shape
    m = gvals.shape[1]
    dev = gvals.device
    if dev.type == "cpu":
        out[:, dest_ids.long()] = ax_reduce_ref(gvals, edge_idx, mask).T
        return out
    dtype, J = gvals.dtype, out.shape[1]
    _check("ax_reduce_bucket", dtype, dev, (
        ("gvals", gvals, (gvals.shape[0], m), dtype),
        ("edge_idx", edge_idx, (r, w), torch.int32),
        ("mask", mask, (r, w), torch.bool),
        ("dest_ids", dest_ids, (r,), torch.int32),
        ("out", out, (m, J), torch.float32)))
    if r == 0 or w == 0:
        return out
    lib = _build.build()["ax_reduce"]
    if m > lib.ax_reduce_max_families():
        raise ValueError(f"ax_reduce_bucket: m={m} exceeds the kernel's "
                         f"{lib.ax_reduce_max_families()} families")
    scratch = torch.empty(max(int(lib.ax_reduce_scratch(r, w, m)), 1),
                          dtype=torch.float32, device=dev)
    rc = lib.ax_reduce_launch(
        _DTYPES[dtype], gvals.data_ptr(), edge_idx.data_ptr(),
        mask.data_ptr(), dest_ids.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), r, w, m, J,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "ax_reduce kernel launch")
    ax_reduce_bucket.launches += 1
    return out


ax_reduce_bucket_x.launches = 0
ax_reduce_bucket.launches = 0
