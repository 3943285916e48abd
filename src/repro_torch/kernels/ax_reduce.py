"""The value-carrying Ax reduction of one plan bucket: the `ax_reduce_x`
kernel's wrapper.

Port of `repro.kernels.ax_reduce.ax_reduce_bucket_x`:

    ax[k, dest_ids[r]] = Σ_q mask[r, q] · a_dm[r, q, k] · x[edge_idx[r, q]]

Every destination owns exactly one plan row, so the result goes straight
into the columns `dest_ids` of the caller's (m, J) float32 buffer; the
reference's row concatenation and `inv_perm` gather are not needed.  For
tensors on the card the wrapper launches `csrc/ax_reduce_x.cu`; for
tensors on the CPU it runs the plain version `ref.ax_reduce_x_ref`.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import ax_reduce_x_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ax_reduce_bucket_x(x, a_dm, edge_idx, mask, dest_ids, out):
    """Reduce one bucket into `out[:, dest_ids]`.

    x (E,) and a_dm (r, w, m) float32 or bfloat16 (the same); edge_idx
    (r, w) and dest_ids (r,) int32; mask (r, w) bool; out (m, J) float32.
    Returns `out`.
    """
    r, w, m = a_dm.shape
    dev = x.device
    if dev.type == "cpu":
        out[:, dest_ids.long()] = ax_reduce_x_ref(x, a_dm, edge_idx, mask).T
        return out
    if dev.type != "cuda":
        raise ValueError(f"ax_reduce_bucket_x: unsupported device {dev}")
    dtype = x.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"ax_reduce_bucket_x: x dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    J = out.shape[1]
    for name, t, shape, dt in (
            ("x", x, (x.shape[0],), dtype), ("a_dm", a_dm, (r, w, m), dtype),
            ("edge_idx", edge_idx, (r, w), torch.int32),
            ("mask", mask, (r, w), torch.bool),
            ("dest_ids", dest_ids, (r,), torch.int32),
            ("out", out, (m, J), torch.float32)):
        _build.check_tensor("ax_reduce_bucket_x", name, t, shape, dt, dev)
    if r == 0 or w == 0:
        return out
    lib = _build.build()["ax_reduce_x"]
    if m > lib.ax_reduce_x_max_families():
        raise ValueError(f"ax_reduce_bucket_x: m={m} exceeds the kernel's "
                         f"{lib.ax_reduce_x_max_families()} families")
    scratch = torch.empty(max(int(lib.ax_reduce_x_scratch(r, w, m)), 1),
                          dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ax_reduce_x_launch(
        _DTYPES[dtype], x.data_ptr(), a_dm.data_ptr(), edge_idx.data_ptr(),
        mask.data_ptr(), dest_ids.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), r, w, m, J, stream)
    _build.check(rc, "ax_reduce_x kernel launch")
    ax_reduce_bucket_x.launches += 1
    return out


ax_reduce_bucket_x.launches = 0
