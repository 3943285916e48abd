"""Hand-written CUDA kernels of the port, for Hopper (sm_90a).

  csrc/dual_x.cu       x*(λ) of a slab + scalars  (replaces dual_grad.py's
                       `_dual_x_kernel`)
  csrc/ax_reduce_x.cu  value-carrying Ax of a plan bucket  (replaces
                       ax_reduce.py's `_ax_reduce_x_kernel`)
  csrc/common.cuh      shared device helpers (box-cut bisection, shuffles)
  _build.py            nvcc -> shared library -> ctypes, at first use
  dual_grad.py, ax_reduce.py   the wrappers (kernel on the card, plain
                       version on the CPU) with their launch counters
  ops.py               the entry points the solver calls
  ref.py               the plain PyTorch versions

Importing this package builds nothing; the first launch on the card does.
"""
from . import ops, ref  # noqa: F401
