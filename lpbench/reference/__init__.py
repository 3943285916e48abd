"""The plain reference of the benchmark: the dual of the matching LP and
its formulations, worked out from the generated arrays in plain torch.

It imports nothing of the program (`repro_torch`) or of the JAX package,
and reads the program's outputs only to judge them (`check.py`).
"""
