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
each holding VPT contiguous columns.  `ref.dual_x_lanes_ref` repeats the
kernels' order of the sums in that layout, bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .ref import dual_grad_ref, dual_x_ref

DEFAULT_ITERS = 40
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NARROW_MAX_WIDTH = 1024   # wider rows run one block a row, with no layout
# values a lane: the fastest of 4, 8 and 16 on the main path's slabs
# (chip_smoke.py times all three)
VPT = 8


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


def _vec_bytes(nbytes: int) -> int:
    """The width of the kernels' vector loads of a chunk of `nbytes`
    bytes (common.cuh `vec_bytes`)."""
    return next(b for b in (16, 8, 4, 2, 1) if nbytes % b == 0)


def _check_aligned(fn_name, tensors, w, m, layout):
    """Raise unless every pointer the kernel's vector loads and stores
    touch is aligned to their width.  They run when w is a multiple of
    VPT, as every power-of-two width is; a and gvals take them for m <= 2
    only."""
    if layout is None or w % layout[1]:
        return
    for name, t in tensors.items():
        per_entry = m if name in ("a_vals", "gvals") else 1
        if t is None or per_entry > 2:
            continue
        nb = _vec_bytes(layout[1] * per_entry * t.element_size())
        if t.data_ptr() % nb:
            raise ValueError(
                f"{fn_name}: {name} must be {nb}-byte aligned for the "
                f"kernel's vector loads (address {t.data_ptr():#x})")


def _launch(wrapper, a_vals, c_vals, dest_idx, mask, ub, s, lam, gamma,
            iters, out, gvals, layout=None):
    """Check the card's tensors, allocate x when the caller gave no `out`,
    and launch K1 (`gvals` None) or K3 (writing `gvals`) at `layout`
    (default `row_layout(w)`), counting the launch on `wrapper`.  Returns
    (x, c_x, x_sq)."""
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
    layout = layout or row_layout(w)
    _check_aligned(fn_name, {"a_vals": a_vals, "c_vals": c_vals,
                             "dest_idx": dest_idx, "mask": mask, "ub": ub,
                             "out": out, "gvals": gvals}, w, m, layout)
    lanes, vpt = layout or (1, 1)         # unused past 1,024: a block a row
    c_x = torch.empty((), dtype=torch.float32, device=dev)
    x_sq = torch.empty((), dtype=torch.float32, device=dev)
    lib = _build.build()["dual_x"]
    scratch = torch.empty(int(lib.dual_x_scratch(n, w, lanes)),
                          dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [a_vals.data_ptr(), c_vals.data_ptr(), dest_idx.data_ptr(),
            mask.data_ptr(), ub.data_ptr(), s.data_ptr(), lam.data_ptr(),
            gamma.data_ptr(), out.data_ptr()]
    if gvals is None:
        rc = lib.dual_x_launch(_DTYPES[dtype], *ptrs, scratch.data_ptr(),
                               c_x.data_ptr(), x_sq.data_ptr(), n, w, m, J,
                               int(iters), lanes, vpt, stream)
    else:
        rc = lib.dual_grad_launch(_DTYPES[dtype], *ptrs, gvals.data_ptr(),
                                  scratch.data_ptr(), c_x.data_ptr(),
                                  x_sq.data_ptr(), n, w, m, J, int(iters),
                                  lanes, vpt, stream)
    _build.check(rc, f"{fn_name} kernel launch")
    wrapper.launches += 1
    return out, c_x, x_sq


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
