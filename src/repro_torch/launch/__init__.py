"""Command-line entry points of the port (`python -m repro_torch.launch.solve`)
and the process grid its distributed solve runs on (`mesh`)."""
from .mesh import Grid, Ranks, init_ranks, make_grid, source_axes

__all__ = ["Grid", "Ranks", "init_ranks", "make_grid", "source_axes"]
