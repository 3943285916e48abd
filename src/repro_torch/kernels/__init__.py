"""Hand-written CUDA kernels of the port, for Hopper (sm_90a).

  csrc/dual_x.cu       K1 x*(λ) of a slab + scalars, and K3 the same plus
                       gvals = a ⊙ x  (replace dual_grad.py's
                       `_dual_x_kernel` and `_dual_grad_kernel`)
  csrc/ax_reduce_x.cu  K2 value-carrying Ax of a whole plan, one call
                       (replaces ax_reduce.py's `_ax_reduce_x_kernel`)
  csrc/ax_reduce.cu    K4 gvals-consuming Ax of a whole plan, one call
                       (replaces ax_reduce.py's `_ax_reduce_kernel`)
  csrc/proj.cu         K5 batched box-cut projection  (replaces proj.py's
                       `_proj_kernel`)
  csrc/ax_rows.cuh     the row sums K2 and K4 share, over the plan's work
                       table (ax_reduce.py `plan_work`)
  csrc/common.cuh      shared device helpers (box-cut bisection over a
                       warp's registers or a block's row, shuffles)
  _build.py            nvcc -> shared library -> ctypes, at first use
  dual_grad.py, ax_reduce.py, proj.py   the wrappers (kernel on the card,
                       plain version on the CPU) with their launch counters
  ops.py               the entry points the solver calls
  ref.py               the plain PyTorch versions

Importing this package builds nothing; the first launch on the card does.
"""
from . import ops, ref  # noqa: F401
