"""Per-device op cost of one eager run: the port's counterpart of
`repro.launch.hlo_cost`.

The reference walks a compiled HLO module and multiplies `while` bodies by
their trip counts.  Here nothing is compiled: `analyze(fn, *args)` runs fn
once under a `TorchDispatchMode` and counts every aten op it dispatches.
Eager runs every layer and every chunk, so there is no trip-count logic.

Conventions (the reference's, where they carry over):
  * FLOPs = dot FLOPs, 2 · |out| · contracted extent, of `mm`, `bmm`,
    `addmm`, `baddbmm`, `mv` and `dot` (what `matmul`, `einsum` and
    `linear` decompose to).  Elementwise flops are excluded.
  * bytes = Σ over aten ops of (operand + result) bytes.  Eager runs
    unfused, so this is the eager program's real traffic, op by op — not
    XLA's fused count, which keeps a fusion's intermediates on chip and
    reads less.  View ops (a result aliasing an operand) move nothing and
    count nothing.
  * collective bytes = result sizes of the `_c10d_functional` (and `c10d`)
    collectives and of DTensor's `shard_dim_alltoall`, keyed by the
    reference's names ("all-reduce", "all-gather", "reduce-scatter",
    "all-to-all", "collective-permute"); `wait_tensor` and
    `_wrap_tensor_autograd` are bookkeeping, counted nowhere.

Per device.  Over DTensors a dispatch mode sees each op at its *global*
shapes, once, before DTensor runs it on the local shards.  The walker
turns that into one device's cost by the op's output placements: a dot's
local FLOPs are the global count over Π (mesh sizes of the dims where the
output is `Shard` or `Partial`), since each device computes its block (or
its partial sum) of the output and nothing else; its bytes are its
operands' and results' local shards.  The collectives DTensor issues
while it runs the op (redistributing an operand) are seen at their local
shapes, as they run, and counted as they are.  A plain tensor's op is one
device's op, counted as it is.

An op DTensor cannot shard (no sharding strategy, or a view that would
split a sharded dim unevenly) runs on operands redistributed to
`Replicate` on every mesh dim, as GSPMD falls back to gathering: the
all-gathers are counted, and the op's cost is a whole replica's.
`fallbacks` in the result names those ops.

`analyze(...)["memory"]` is this device's memory from the same record:
the arguments' local bytes, the outputs', and the peak of the bytes that
ops created and that were still referenced (autograd's saved tensors
included), which is what an eager run holds.
"""
from __future__ import annotations

import weakref
from collections import Counter
from typing import (Any, Callable, Dict, List, NamedTuple, Sequence,
                    Tuple)

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

__all__ = ["COLLECTIVES", "analyze", "OpRecord", "Walker",
           "edge_space_result_bytes", "count_result_shape"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# collective op name (without namespace or overload) -> the reference's
# kind: functional collectives (DTensor's), the c10d ops `dist.*` runs
_KIND = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLL_NS = ("_c10d_functional", "c10d", "_dtensor")
# bookkeeping ops around a collective's result: no traffic of their own
_SKIP = {"wait_tensor", "_wrap_tensor_autograd"}

_DOTS = {"mm", "bmm", "addmm", "baddbmm", "mv", "dot", "addmv"}


def _dtensor_cls():
    from torch.distributed.tensor import DTensor
    return DTensor


def _is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    return isinstance(x, _dtensor_cls())


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if _is_dtensor(t) else t


def _nbytes(t: torch.Tensor) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _name(func) -> Tuple[str, str]:
    """(namespace, op name) of an OpOverload."""
    packet = func.overloadpacket
    return packet._qualified_op_name.split("::")[0], packet.__name__


def _dot_flops(name: str, args) -> float:
    """2 · |out| · contracted extent at the operands' (global) shapes."""
    if name in ("addmm", "baddbmm", "addmv"):
        args = args[1:]
    a, b = args[0], args[1]
    if name == "mm":
        return 2.0 * a.shape[0] * b.shape[1] * a.shape[1]
    if name in ("bmm", "baddbmm"):
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[2] * a.shape[2]
    if name in ("mv", "addmv"):
        return 2.0 * a.shape[0] * a.shape[1]
    return 2.0 * a.shape[0]                                  # dot


def _shard_factor(out) -> float:
    """How many devices share a DTensor result's work: Π mesh sizes of the
    dims where it is Partial, times its global over its local element
    count (Π mesh sizes of the dims where it is Shard, strided shards of a
    merged dim included; on an uneven split, this rank's block)."""
    mesh = out.device_mesh
    n = 1.0
    for i, p in enumerate(out.placements):
        if p.is_partial():
            n *= mesh.size(i)
    local = out._local_tensor.numel()
    return n * (out.numel() / local if local else 1.0)


def _alias(func, i: int):
    """The alias info of result i of an op: None for a new tensor."""
    rets = func._schema.returns
    return rets[i].alias_info if i < len(rets) else None


class OpRecord(NamedTuple):
    """One counted op at local (per-device) shapes: the results it wrote
    (new tensors and in-place or out= writes), the operands it read that
    are not the analyzed function's arguments, its FLOPs and bytes."""

    op: str
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    flops: float
    bytes: float
    operands: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...] = ()


class Walker(TorchDispatchMode):
    """The dispatch mode behind `analyze`: counts each op once, per device
    (see the module docstring).  `static` holds tensors whose reads
    `dynamic_only` leaves out (the step's arguments)."""

    def __init__(self, dynamic_only: bool = False,
                 static: Sequence[torch.Tensor] = ()):
        super().__init__()
        self.dynamic_only = dynamic_only
        self._static = {id(_local(t)) for t in static}
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = {k: 0.0 for k in COLLECTIVES}
        self.coll_count = 0
        self.records: List[OpRecord] = []
        self.fallbacks: Counter = Counter()
        self.live = 0
        self.peak = 0
        self._inside = 0          # > 0 while DTensor runs a counted op
        self._pass = None         # the DTensor op to hand back to DTensor

    # -- memory ------------------------------------------------------------
    def _track(self, t: torch.Tensor):
        n = _nbytes(t)
        if n == 0:
            return
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int):
        self.live -= n

    # -- counting ----------------------------------------------------------
    def _operand_bytes(self, tensors) -> int:
        return sum(_nbytes(t) for t in tensors
                   if not (self.dynamic_only
                           and id(_local(t)) in self._static))

    def _count(self, func, args, kwargs, out, flops: float):
        outs = _tensors(out)
        alias = [_alias(func, i) for i in range(len(outs))]
        written = [t for t, a in zip(outs, alias) if a is None or a.is_write]
        if outs and not written:
            return                  # a view: moves nothing
        ins = _tensors((args, kwargs))
        nbytes = (self._operand_bytes(ins)
                  + sum(_nbytes(t) for t in written))
        self.flops += flops
        self.bytes += nbytes
        self.records.append(OpRecord(
            str(func.overloadpacket.__name__),
            tuple(tuple(_local(t).shape) for t in written),
            tuple(t.dtype for t in written), flops, nbytes,
            tuple((tuple(_local(t).shape), t.dtype) for t in ins
                  if id(_local(t)) not in self._static)))
        for t, a in zip(outs, alias):
            if a is None:
                self._track(t)

    def _collective(self, kind: str, out):
        b = sum(_nbytes(t) for t in _tensors(out)[:1])
        self.coll[kind] += b
        self.coll_count += 1
        self.bytes += b

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._pass is func:
            # the op this mode re-entered DTensor with: let DTensor run it
            # with the mode still on, so its collectives come back here
            self._pass = None
            return NotImplemented
        ns, name = _name(func)
        if name in _SKIP:
            return func(*args, **kwargs)
        if ns in _COLL_NS and name in _KIND:
            out = func(*args, **kwargs)
            self._collective(_KIND[name], out)
            return out
        if self._inside:
            return func(*args, **kwargs)    # DTensor's local work
        if torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
            # a composite op reaches the mode whole under inference_mode
            # (matmul, softmax): count what it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        if any(_is_dtensor(t) for t in _tensors((args, kwargs))):
            return self._dtensor_op(func, name, args, kwargs)
        out = func(*args, **kwargs)
        flops = _dot_flops(name, args) if name in _DOTS else 0.0
        self._count(func, args, kwargs, out, flops)
        return out

    def _run_dtensor(self, func, args, kwargs):
        self._inside += 1
        self._pass = func
        try:
            with self:
                return func(*args, **kwargs)
        finally:
            self._pass = None
            self._inside -= 1

    def _dtensor_op(self, func, name, args, kwargs):
        try:
            out = self._run_dtensor(func, args, kwargs)
        except (RuntimeError, NotImplementedError, AssertionError):
            out = self._replicated(func, args, kwargs)
        flops = 0.0
        if name in _DOTS:
            res = _tensors(out)[0]
            flops = _dot_flops(name, args) / (
                _shard_factor(res) if _is_dtensor(res) else 1)
        self._count(func, args, kwargs, out, flops)
        return out

    def _replicated(self, func, args, kwargs):
        """func on operands gathered to Replicate on every mesh dim (the
        gathers counted), its results Replicate DTensors."""
        from torch.distributed.tensor import DTensor, Replicate

        self.fallbacks[str(func)] += 1
        mesh = next(t for t in _tensors((args, kwargs))
                    if _is_dtensor(t)).device_mesh
        rep = [Replicate()] * mesh.ndim

        def full(x):
            if not _is_dtensor(x):
                return x
            self._inside += 1
            try:
                with self:
                    return x.redistribute(mesh, rep).to_local()
            except RuntimeError:
                # a layout DTensor cannot gather back (seen on a greedy
                # 3-D plan): with no data behind it (meta), the whole
                # tensor is counted as one all-gather of its bytes
                if not x._local_tensor.is_meta:
                    raise
                whole = torch.empty(x.shape, dtype=x.dtype, device="meta")
                self._collective("all-gather", whole)
                return whole
            finally:
                self._inside -= 1

        out = func(*tree_map(full, args), **tree_map(full, kwargs))
        return tree_map(lambda t: DTensor.from_local(t, mesh, rep,
                                                     run_check=False)
                        if isinstance(t, torch.Tensor) else t, out)

    # -- result ------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes,
            "collective_bytes_per_device": sum(self.coll.values()),
            "collectives": dict(self.coll),
            "collective_count": self.coll_count,
        }


def analyze(fn: Callable, *args, dynamic_only: bool = False,
            **kwargs) -> Dict[str, Any]:
    """Per-device totals of one run of fn(*args, **kwargs): the
    reference's keys (`flops_per_device`, `bytes_per_device`,
    `collective_bytes_per_device`, `collectives`, `collective_count`),
    plus `memory` (argument, output and peak temp bytes), `fallbacks`
    (ops run replicated), `records` (every counted op) and `out` (fn's
    result).

    `dynamic_only=True` leaves out operand reads of fn's arguments (the
    static problem data, re-read identically every iteration), as the
    reference leaves out its entry parameters' reads."""
    static = _tensors((args, kwargs))
    walker = Walker(dynamic_only=dynamic_only, static=static)
    with walker:
        out = fn(*args, **kwargs)
    res = walker.summary()
    out_bytes = sum(_nbytes(t) for t in _tensors(out))
    arg_bytes = sum(_nbytes(t) for t in
                    {id(t): t for t in static}.values())
    res["memory"] = {
        "argument_size_in_bytes": float(arg_bytes),
        "output_size_in_bytes": float(out_bytes),
        "temp_size_in_bytes": float(max(walker.peak - out_bytes, 0)),
        "peak_bytes_estimate": float(arg_bytes + walker.peak),
    }
    res["fallbacks"] = dict(walker.fallbacks)
    res["records"] = walker.records
    res["out"] = out
    return res


_FLOAT = (torch.float32, torch.bfloat16, torch.float16)


def edge_space_result_bytes(records: Sequence[OpRecord], leading_dim: int,
                            dtypes=_FLOAT) -> float:
    """Bytes of op results whose leading dimension equals `leading_dim`
    (for the LP iteration: the flat edge count E — the (E, m) gvals
    tensor and/or the (E,) x vector).  Arguments and views are not
    results, so this is the dynamic per-edge traffic."""
    total = 0.0
    for r in records:
        for shape, dt in zip(r.shapes, r.dtypes):
            if dt in dtypes and shape and shape[0] == leading_dim:
                n = 1
                for d in shape:
                    n *= d
                total += float(n) * torch.empty((), dtype=dt).element_size()
    return total


def count_result_shape(records: Sequence[OpRecord], dims: Sequence[int],
                       dtypes=_FLOAT) -> int:
    """Number of ops that write, or read as an intermediate (not an
    argument of the analyzed function), a tensor of exactly `dims`.  Eager
    has no fusion to hide a tensor in, so this counts where such a tensor
    exists at all: the x-carry check — an evaluation that never
    materializes the (E, m) per-edge gradient tensor counts 0 for
    dims=(E, m), one that writes the gvals buffer and reads it back in
    the Ax reduction counts those ops."""
    want = tuple(int(d) for d in dims)
    return sum(1 for r in records
               if any(s == want and dt in dtypes for s, dt in
                      list(zip(r.shapes, r.dtypes)) + list(r.operands)))
