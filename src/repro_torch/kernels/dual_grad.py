"""x*(λ) of one slab with its scalars: the `dual_x` kernel's wrapper.

Port of `repro.kernels.dual_grad.dual_x_slab` (the gvals-free fused step
of the x-carry aligned path).  For tensors on the card it launches the
hand-written CUDA kernel `csrc/dual_x.cu`; for tensors on the CPU it runs
the plain version `ref.dual_x_ref`.  Nothing else: a build or launch
failure raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .ref import dual_x_ref

DEFAULT_ITERS = 40
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def dual_x_slab(a_vals, c_vals, dest_idx, mask, ub, s, lam, gamma,
                iters: int = DEFAULT_ITERS,
                out: Optional[torch.Tensor] = None):
    """Fused x*(λ) + scalars for one slab.

    a_vals (n, w, m), c_vals/ub (n, w), s (n,), all float32 or all
    bfloat16; dest_idx (n, w) int32; mask (n, w) bool; lam (m, J) float32;
    gamma a 0-d tensor (cast to the slab's dtype, as the reference casts
    it).  `out`, when given, is an (n, w) tensor of the slab's dtype that
    receives x (the solver passes a slice of its flat edge buffer).
    Returns (x (n, w), c_x, x_sq) with float32 0-d scalars.
    """
    n, w, m = a_vals.shape
    dtype, dev = c_vals.dtype, c_vals.device
    gamma = torch.as_tensor(gamma, device=dev).to(dtype).reshape(())
    if dev.type == "cpu":
        x, c_x, x_sq = dual_x_ref(a_vals, c_vals, dest_idx, mask, ub, s, lam,
                                  gamma, iters)
        if out is not None:
            out.copy_(x)
            x = out
        return x, c_x, x_sq
    if dev.type != "cuda":
        raise ValueError(f"dual_x_slab: unsupported device {dev}")
    if dtype not in _DTYPES:
        raise TypeError(f"dual_x_slab: slab dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    J = lam.shape[1]
    for name, t, shape, dt in (
            ("a_vals", a_vals, (n, w, m), dtype), ("c_vals", c_vals, (n, w), dtype),
            ("dest_idx", dest_idx, (n, w), torch.int32),
            ("mask", mask, (n, w), torch.bool), ("ub", ub, (n, w), dtype),
            ("s", s, (n,), dtype), ("lam", lam, (m, J), torch.float32)):
        _build.check_tensor("dual_x_slab", name, t, shape, dt, dev)
    if out is None:
        out = torch.empty((n, w), dtype=dtype, device=dev)
    else:
        _build.check_tensor("dual_x_slab", "out", out, (n, w), dtype, dev)
    if n == 0 or w == 0:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return out, zero, zero.clone()
    c_x = torch.empty((), dtype=torch.float32, device=dev)
    x_sq = torch.empty((), dtype=torch.float32, device=dev)
    lib = _build.build()["dual_x"]
    if w > lib.dual_x_max_width():
        raise ValueError(f"dual_x_slab: width {w} exceeds the kernel's "
                         f"{lib.dual_x_max_width()}")
    scratch = torch.empty(int(lib.dual_x_scratch(n, w)), dtype=torch.float32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.dual_x_launch(
        _DTYPES[dtype], a_vals.data_ptr(), c_vals.data_ptr(),
        dest_idx.data_ptr(), mask.data_ptr(), ub.data_ptr(), s.data_ptr(),
        lam.data_ptr(), gamma.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        c_x.data_ptr(), x_sq.data_ptr(), n, w, m, J, int(iters), stream)
    _build.check(rc, "dual_x kernel launch")
    dual_x_slab.launches += 1
    return out, c_x, x_sq


dual_x_slab.launches = 0
