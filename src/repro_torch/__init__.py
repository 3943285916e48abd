"""PyTorch/CUDA port of the DuaLip matching solver.

Mirrors the JAX reference package `repro` module for module (`core/`,
`kernels/`, `formulations/`, `primal/`, `obs/`, `checkpoint/`,
`testing/`, `launch/`) and imports nothing of it, nor JAX.
The hot path runs through hand-written CUDA kernels for Hopper
(`kernels/csrc/`); for tensors on the CPU the same entry points run plain
PyTorch versions.  Entry points default to the card and raise when there
is none; the CPU runs only when asked for (`device="cpu"`).
"""
