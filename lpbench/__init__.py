"""The benchmark of the PyTorch and CUDA port (`src/repro_torch`): one
cell a run, `python3 -m lpbench.run` (see `run.py`).  Nothing here
imports JAX or the JAX package."""
