"""The process grid of the port: ranks of `torch.distributed` laid out on
named axes, the counterpart of the reference's JAX mesh
(`repro.launch.mesh`).

`init_ranks` brings up the default process group once per process from
torchrun's environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`), with NCCL on
`cuda:LOCAL_RANK` or gloo on the CPU; without torchrun and without a group
already up it is one rank with no group.  `make_grid` lays the ranks out
row-major on a shape, as `jax.make_mesh` lays out devices, and creates one
process group for every set of axes that a collective may run over (the
source axes, the λ axis, the source axes but the λ axis).

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.solve --device cpu ...
"""
from __future__ import annotations

import itertools
import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..convert import resolve_device


class Ranks(NamedTuple):
    """This process's place among the ranks: its rank, the world size, the
    device it computes on, and whether a default process group is up
    (False: one rank with no group, every collective skipped)."""

    rank: int
    world: int
    device: torch.device
    grouped: bool


def init_ranks(device: str = "cuda", backend: Optional[str] = None) -> Ranks:
    """The default process group, initialised at the first call of a
    process from torchrun's environment and returned as it is at later
    calls (or when the caller has brought one up itself).

    `device` "cuda" means `cuda:LOCAL_RANK`, which must exist: two ranks
    never share a card by default (NCCL refuses that).  `backend`
    defaults to NCCL on the card and gloo on the CPU.  With no group up
    and no torchrun environment this is one rank with no group."""
    dev = resolve_device(device)
    launched = "WORLD_SIZE" in os.environ
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK",
                                   torch.cuda.current_device()))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"local rank {local} has no card of its own: "
                f"{torch.cuda.device_count()} visible; start at most one "
                f"rank a card")
        dev = torch.device("cuda", local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized() and launched:
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method="env://", rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]))
    if not dist.is_initialized():
        return Ranks(rank=0, world=1, device=dev, grouped=False)
    return Ranks(rank=dist.get_rank(), world=dist.get_world_size(),
                 device=dev, grouped=True)


class Grid(NamedTuple):
    """Ranks laid out row-major on `shape` over named `axes`: this rank's
    `coords`, and per set of axes (a tuple in grid order) the process
    group of the ranks that differ from this one only on those axes (None
    with no process group)."""

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    coords: Tuple[int, ...]
    groups: Dict[Tuple[str, ...], Optional[object]]

    def _ordered(self, axes: Sequence[str]) -> Tuple[str, ...]:
        unknown = set(axes) - set(self.axes)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} are not grid axes "
                             f"{self.axes}")
        return tuple(a for a in self.axes if a in axes)

    def size(self, axes: Sequence[str]) -> int:
        """Ranks along `axes` (their sizes' product)."""
        return int(np.prod([self.shape[self.axes.index(a)]
                            for a in self._ordered(axes)], dtype=np.int64))

    def index(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over `axes`: the block order of a
        `PartitionSpec(axes)` over the reference's mesh."""
        idx = 0
        for a in self._ordered(axes):
            i = self.axes.index(a)
            idx = idx * self.shape[i] + self.coords[i]
        return idx

    def group(self, axes: Sequence[str]):
        """The process group over `axes` (None: no process group, or no
        axes)."""
        axes = self._ordered(axes)
        return self.groups.get(axes) if axes else None


def make_grid(shape: Sequence[int], axes: Sequence[str]) -> Grid:
    """Lay the default group's ranks out on `shape` (row-major, rank r at
    `np.unravel_index(r, shape)`) and create a process group for every
    non-empty set of axes.  Every rank creates every group, in the same
    order, as `dist.new_group` requires; the set of all axes is the world
    group.  With no process group up the grid must have one rank."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"grid shape {shape} and axes {axes} differ in "
                         f"length")
    n = int(np.prod(shape, dtype=np.int64))
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a {shape} grid needs {n} ranks, but no process group is "
                f"up (start the ranks with torch.distributed.run)")
        return Grid(shape, axes, (0,) * len(shape), {})
    world, rank = dist.get_world_size(), dist.get_rank()
    if n != world:
        raise ValueError(f"a {shape} grid needs {n} ranks; the process "
                         f"group has {world}")
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    every = np.arange(world).reshape(shape)
    groups = {}
    for k in range(1, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), k):
            key = tuple(axes[i] for i in sub)
            if k == len(axes):
                groups[key] = dist.group.WORLD
                continue
            # one group per setting of the other axes' coordinates; a
            # group of one rank is none (nothing to reduce)
            size = int(np.prod([shape[i] for i in sub]))
            if size == 1:
                groups[key] = None
                continue
            rest = [i for i in range(len(axes)) if i not in sub]
            blocks = np.moveaxis(every, rest, list(range(len(rest))))
            for members in blocks.reshape(-1, size):
                g = dist.new_group([int(r) for r in members])
                if rank in members:
                    groups[key] = g
    return Grid(shape, axes, coords, groups)


def source_axes(grid: Grid) -> Tuple[str, ...]:
    """LP source-partition axes of a grid: every axis except 'model'."""
    return tuple(a for a in grid.axes if a != "model")
