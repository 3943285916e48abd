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

For the model zoo's sharding (`repro_torch.sharding`) a mesh is named
axes and their sizes: `MeshSpec` says so with no ranks behind it (the
reference's `AbstractMesh`), `make_production_mesh` gives the two
production shapes, and `device_mesh` lays a `MeshSpec` onto the current
process group as a `DeviceMesh` for DTensor.  `fake_ranks` brings up a
process group of any size in one process that communicates nothing, for
the dry run (`launch.dryrun`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
from typing import Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

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


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named mesh axes and their sizes, with no ranks behind them: the
    counterpart of `jax.sharding.AbstractMesh`.  `shape` maps axis names
    to sizes."""

    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.dims) != len(self.axis_names):
            raise ValueError(f"mesh dims {self.dims} and axes "
                             f"{self.axis_names} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return int(np.prod(self.dims, dtype=np.int64))


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The production meshes: (16, 16) ("data", "model"), 256 devices, or
    (2, 16, 16) ("pod", "data", "model"), 512."""
    if multi_pod:
        return MeshSpec((2, 16, 16), ("pod", "data", "model"))
    return MeshSpec((16, 16), ("data", "model"))


def device_mesh(spec: MeshSpec, device_type: str = "cpu"):
    """`spec` laid onto the default process group, whose size must be
    `spec.size`, as a `DeviceMesh` with the same axis names (ranks
    row-major, as `make_grid` lays them out)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(f"a {spec.dims} mesh needs a process group of "
                           f"{spec.size} ranks; none is up")
    if dist.get_world_size() != spec.size:
        raise ValueError(f"a {spec.dims} mesh needs {spec.size} ranks; "
                         f"the process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(spec.dims),
                            mesh_dim_names=tuple(spec.axis_names))


@contextlib.contextmanager
def fake_ranks(world: int, rank: int = 0) -> Iterator[None]:
    """A default process group of `world` ranks in this one process, this
    one rank `rank`, that communicates nothing (torch's "fake" backend):
    every collective returns at once, its output left as it was.  Enough
    to run DTensor's sharding on `meta` tensors.  The group is destroyed
    on exit; no group may be up on entry."""
    # registers the "fake" backend with torch.distributed
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()
