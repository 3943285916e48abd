"""The batched box-cut projection of an (n, w) slab: the `proj` kernel's
(K5) wrapper.

Port of `repro.kernels.proj.proj_boxcut`: row by row, x = the projection
of v onto {0 <= x <= ub, Σx <= s} by τ-bisection, 0 on padding.  For
tensors on the card it launches the hand-written CUDA kernel
`csrc/proj.cu`, the bisection K1 runs on K1's layout
(`dual_grad.kernel_layout`: `row_layout` up to 1,024 wide, a block a row
past it), so that fed a float32 slab's u it gives K1's x bit for bit; for
tensors on the CPU it runs the plain version `ref.proj_boxcut_ref`.  A build or launch failure raises.
`ref.proj_lanes_ref` and `ref.proj_block_ref` repeat the kernel's order
of the sums.
"""
from __future__ import annotations

import torch

from ..obs.telemetry import spanned
from . import _build
from .dual_grad import kernel_layout, layout_store, vector_values
from .ref import proj_boxcut_ref

DEFAULT_ITERS = 40
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@spanned("launch", kernel="proj_boxcut")
def proj_boxcut(v, ub, s, mask, iters: int = DEFAULT_ITERS):
    """x (n, w) in v's dtype.  v, ub (n, w) and s (n,) float32 or bfloat16
    (the same); mask (n, w) bool.  On the card v, ub and mask must be
    aligned for the kernel's 16-byte vector loads (a ValueError says
    which is not)."""
    if v.device.type == "cpu":
        return proj_boxcut_ref(v, ub, s, mask, iters)
    return _launch(v, ub, s, mask, iters)


def _launch(v, ub, s, mask, iters, layout=None, store=None):
    """Check the card's tensors and launch K5 at `layout` (default
    `kernel_layout(w)`) and `store` (default `layout_store`), counting the
    launch on `proj_boxcut`.  Returns x."""
    n, w = v.shape
    dtype, dev = v.dtype, v.device
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
    lanes, vpt = layout = layout or kernel_layout(w)
    store = layout_store(layout) if store is None else store
    _build.check_aligned("proj_boxcut", {"v": v, "ub": ub, "mask": mask,
                                         "x": x}, w, 1, vector_values(layout))
    lib = _build.build()["proj"]
    scratch = torch.empty(max(int(lib.proj_scratch(n, lanes, vpt, store)), 1),
                          dtype=torch.float32, device=dev)
    rc = lib.proj_launch(_DTYPES[dtype], v.data_ptr(), ub.data_ptr(),
                         s.data_ptr(), mask.data_ptr(), x.data_ptr(),
                         scratch.data_ptr(), n, w, int(iters), lanes, vpt,
                         store, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "proj kernel launch")
    # unlocked: counts are read around single-threaded windows only
    proj_boxcut.launches += 1
    return x


proj_boxcut.launches = 0
