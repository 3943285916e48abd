"""x*(λ) of one slab with its scalars, with or without the per-edge
gradient values: the wrappers of the `dual_x` (K1) and `dual_grad` (K3)
kernels.

Ports of `repro.kernels.dual_grad.dual_x_slab` (the gvals-free fused step
of the x-carry aligned path) and `dual_grad_slab` (the same step plus
gvals = a ⊙ x, for the gvals modes).  For tensors on the card each
launches its hand-written CUDA kernel in `csrc/dual_x.cu` (K3 is K1's body
with the gvals write switched on); for tensors on the CPU each runs its
plain version (`ref.dual_x_ref`, `ref.dual_grad_ref`).  Nothing else: a
build or launch failure raises.  Rows of any width run.

Rows up to 1,024 wide run at the layout `row_layout(w)`: L lanes a row,
each holding VPT contiguous columns.  Wider rows run one block of 256
threads a row, thread t holding C contiguous columns (`ref.block_layout`),
in registers or staged in memory (`wide_store`).  This module decides the
layout; the kernels take it as given and refuse one they have no
instance for.  `ref.dual_x_lanes_ref` and `ref.dual_x_block_ref` repeat
the kernels' order of the sums in those layouts, bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..obs.telemetry import spanned
from . import _build
from .ref import (NARROW_MAX_WIDTH, WIDE_THREADS, block_layout,
                  dual_grad_ref, dual_x_ref)

DEFAULT_ITERS = 40
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# values a lane: the fastest of 4, 8 and 16 on the main path's slabs
# (chip_smoke.py times all three)
VPT = 8
# values a thread of a wide row moves by one vector load or store
# (common.cuh kWidePiece)
WIDE_PIECE = 8
# where a wide row's chunks live (common.cuh kStoreRegs, kStoreShared,
# kStoreGlobal), the chunks C with a register instance of every wide
# kernel (REPRO_WIDE_REG_CHUNKS), and the dynamic shared memory a block
# may take on an H100 (kMaxSharedBytes)
STORE_REGS, STORE_SHARED, STORE_GLOBAL = 0, 1, 2
WIDE_REG_CHUNKS = (8, 16, 32)
MAX_SHARED_BYTES = 227 * 1024


def row_layout(w: int, vpt: int = VPT) -> Optional[Tuple[int, int]]:
    """(L, VPT) of a row of width w <= 1,024 on K1's and K3's register
    path: L lanes a row, lane l holding columns [l·VPT, (l+1)·VPT), with
    L·VPT the next power of two of w.  VPT is min(that, `vpt`), and
    rises past 256 so that L stays at most 32 (one warp a row).  None for
    wider rows."""
    if w > NARROW_MAX_WIDTH:
        return None
    p = 1
    while p < w:
        p <<= 1
    v = max(min(p, vpt), p // 32)
    return p // v, v


def kernel_layout(w: int, vpt: int = VPT) -> Tuple[int, int]:
    """The kernels' layout of a row of width w: `row_layout` up to 1,024,
    (256, C) of `ref.block_layout` past it."""
    return row_layout(w, vpt) or block_layout(w)


def wide_store(chunk: int) -> int:
    """Where a wide row's chunks of `chunk` values live: registers where
    the kernels have an instance for it (C = 8, 16, 32: up to 8,192
    wide), else staged in shared memory while v and ub fit there (up to
    16,384), else in global scratch."""
    if chunk in WIDE_REG_CHUNKS:
        return STORE_REGS
    if 2 * 4 * chunk * WIDE_THREADS <= MAX_SHARED_BYTES:
        return STORE_SHARED
    return STORE_GLOBAL


def layout_store(layout) -> int:
    """The storage of a layout: registers for a group of lanes,
    `wide_store` for a block."""
    return STORE_REGS if layout[0] <= 32 else wide_store(layout[1])


def vector_values(layout) -> int:
    """The values of a row that one of the kernels' vector loads moves at
    `layout`: VPT for a group of lanes, WIDE_PIECE for a block."""
    return layout[1] if layout[0] <= 32 else WIDE_PIECE


def _launch(wrapper, a_vals, c_vals, dest_idx, mask, ub, s, lam, gamma,
            iters, out, gvals, layout=None, store=None):
    """Check the card's tensors, allocate x when the caller gave no `out`,
    and launch K1 (`gvals` None) or K3 (writing `gvals`) at `layout`
    (default `kernel_layout(w)`) and `store` (default `layout_store`),
    counting the launch on `wrapper`.  Returns (x, c_x, x_sq)."""
    fn_name = wrapper.__name__
    n, w, m = a_vals.shape
    dtype, dev = c_vals.dtype, c_vals.device
    if dev.type != "cuda":
        raise ValueError(f"{fn_name}: unsupported device {dev}")
    if dtype not in _DTYPES:
        raise TypeError(f"{fn_name}: slab dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    J = lam.shape[1]
    for name, t, shape, dt in (
            ("a_vals", a_vals, (n, w, m), dtype), ("c_vals", c_vals, (n, w), dtype),
            ("dest_idx", dest_idx, (n, w), torch.int32),
            ("mask", mask, (n, w), torch.bool), ("ub", ub, (n, w), dtype),
            ("s", s, (n,), dtype), ("lam", lam, (m, J), torch.float32)):
        _build.check_tensor(fn_name, name, t, shape, dt, dev)
    if out is None:
        out = torch.empty((n, w), dtype=dtype, device=dev)
    else:
        _build.check_tensor(fn_name, "out", out, (n, w), dtype, dev)
    if gvals is not None:
        _build.check_tensor(fn_name, "gvals", gvals, (n, w, m), dtype, dev)
    if n == 0 or w == 0:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return out, zero, zero.clone()
    lanes, vpt = layout = layout or kernel_layout(w)
    store = layout_store(layout) if store is None else store
    _build.check_aligned(fn_name, {"a_vals": a_vals, "c_vals": c_vals,
                                   "dest_idx": dest_idx, "mask": mask,
                                   "ub": ub, "out": out, "gvals": gvals},
                         w, m, vector_values(layout))
    c_x = torch.empty((), dtype=torch.float32, device=dev)
    x_sq = torch.empty((), dtype=torch.float32, device=dev)
    lib = _build.build()["dual_x"]
    scratch = torch.empty(int(lib.dual_x_scratch(n, lanes, vpt, store)),
                          dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [a_vals.data_ptr(), c_vals.data_ptr(), dest_idx.data_ptr(),
            mask.data_ptr(), ub.data_ptr(), s.data_ptr(), lam.data_ptr(),
            gamma.data_ptr(), out.data_ptr()]
    if gvals is None:
        rc = lib.dual_x_launch(_DTYPES[dtype], *ptrs, scratch.data_ptr(),
                               c_x.data_ptr(), x_sq.data_ptr(), n, w, m, J,
                               int(iters), lanes, vpt, store, stream)
    else:
        rc = lib.dual_grad_launch(_DTYPES[dtype], *ptrs, gvals.data_ptr(),
                                  scratch.data_ptr(), c_x.data_ptr(),
                                  x_sq.data_ptr(), n, w, m, J, int(iters),
                                  lanes, vpt, store, stream)
    _build.check(rc, f"{fn_name} kernel launch")
    # unlocked: counts are read around single-threaded windows only
    wrapper.launches += 1
    return out, c_x, x_sq


@spanned("launch", kernel="dual_x_slab")
def dual_x_slab(a_vals, c_vals, dest_idx, mask, ub, s, lam, gamma,
                iters: int = DEFAULT_ITERS,
                out: Optional[torch.Tensor] = None):
    """Fused x*(λ) + scalars for one slab (K1).

    a_vals (n, w, m), c_vals/ub (n, w), s (n,), all float32 or all
    bfloat16; dest_idx (n, w) int32; mask (n, w) bool; lam (m, J) float32;
    gamma a 0-d tensor (cast to the slab's dtype, as the reference casts
    it).  `out`, when given, is an (n, w) tensor of the slab's dtype that
    receives x (the solver passes a slice of its flat edge buffer).
    Returns (x (n, w), c_x, x_sq) with float32 0-d scalars.
    """
    gamma = torch.as_tensor(gamma, device=c_vals.device).to(
        c_vals.dtype).reshape(())
    if c_vals.device.type == "cpu":
        x, c_x, x_sq = dual_x_ref(a_vals, c_vals, dest_idx, mask, ub, s, lam,
                                  gamma, iters)
        if out is not None:
            out.copy_(x)
            x = out
        return x, c_x, x_sq
    return _launch(dual_x_slab, a_vals, c_vals, dest_idx, mask, ub, s, lam,
                   gamma, iters, out, None)


@spanned("launch", kernel="dual_grad_slab")
def dual_grad_slab(a_vals, c_vals, dest_idx, mask, ub, s, lam, gamma,
                   iters: int = DEFAULT_ITERS,
                   out: Optional[torch.Tensor] = None,
                   gvals_out: Optional[torch.Tensor] = None):
    """Fused x*(λ) + per-edge gvals + scalars for one slab (K3).

    Inputs as `dual_x_slab`.  `gvals_out`, when given, is an (n, w, m)
    tensor of the slab's dtype that receives gvals = a ⊙ x (0 on padding;
    the solver passes a slice of its flat (E, m) buffer).  Returns (x,
    gvals, c_x, x_sq); x, c_x and x_sq equal `dual_x_slab`'s bit for bit.
    """
    gamma = torch.as_tensor(gamma, device=c_vals.device).to(
        c_vals.dtype).reshape(())
    if c_vals.device.type == "cpu":
        x, gvals, c_x, x_sq = dual_grad_ref(a_vals, c_vals, dest_idx, mask,
                                            ub, s, lam, gamma, iters)
        if out is not None:
            out.copy_(x)
            x = out
        if gvals_out is not None:
            gvals_out.copy_(gvals)
            gvals = gvals_out
        return x, gvals, c_x, x_sq
    if gvals_out is None:
        gvals_out = torch.empty(a_vals.shape, dtype=c_vals.dtype,
                                device=c_vals.device)
    x, c_x, x_sq = _launch(dual_grad_slab, a_vals, c_vals, dest_idx, mask,
                           ub, s, lam, gamma, iters, out, gvals_out)
    return x, gvals_out, c_x, x_sq


dual_x_slab.launches = 0
dual_grad_slab.launches = 0
