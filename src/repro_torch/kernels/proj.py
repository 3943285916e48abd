"""The batched box-cut projection of an (n, w) slab: the `proj` kernel's
(K5) wrapper.

Port of `repro.kernels.proj.proj_boxcut`: row by row, x = the projection
of v onto {0 <= x <= ub, Σx <= s} by τ-bisection, 0 on padding.  For
tensors on the card it launches the hand-written CUDA kernel
`csrc/proj.cu` (the bisection K1 runs, with K1's lane layout); for
tensors on the CPU it runs the plain version `ref.proj_boxcut_ref`.  A
build or launch failure raises.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import proj_boxcut_ref

DEFAULT_ITERS = 40
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def proj_boxcut(v, ub, s, mask, iters: int = DEFAULT_ITERS):
    """x (n, w) in v's dtype.  v, ub (n, w) and s (n,) float32 or bfloat16
    (the same); mask (n, w) bool."""
    n, w = v.shape
    dtype, dev = v.dtype, v.device
    if dev.type == "cpu":
        return proj_boxcut_ref(v, ub, s, mask, iters)
    if dev.type != "cuda":
        raise ValueError(f"proj_boxcut: unsupported device {dev}")
    if dtype not in _DTYPES:
        raise TypeError(f"proj_boxcut: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    for name, t, shape, dt in (("v", v, (n, w), dtype),
                               ("ub", ub, (n, w), dtype),
                               ("s", s, (n,), dtype),
                               ("mask", mask, (n, w), torch.bool)):
        _build.check_tensor("proj_boxcut", name, t, shape, dt, dev)
    x = torch.empty((n, w), dtype=dtype, device=dev)
    if n == 0 or w == 0:
        return x
    lib = _build.build()["proj"]
    scratch = torch.empty(max(int(lib.proj_scratch(n, w)), 1),
                          dtype=torch.float32, device=dev)
    rc = lib.proj_launch(_DTYPES[dtype], v.data_ptr(), ub.data_ptr(),
                         s.data_ptr(), mask.data_ptr(), x.data_ptr(),
                         scratch.data_ptr(), n, w, int(iters),
                         torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "proj kernel launch")
    proj_boxcut.launches += 1
    return x


proj_boxcut.launches = 0
