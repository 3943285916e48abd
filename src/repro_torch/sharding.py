"""Logical-axis sharding rules (MaxText-style); port of `repro.sharding`.

Model code annotates tensors with *logical* axis names; the mapping to
mesh axes lives here, in one table, so changing the parallelism strategy
is a one-line rule edit.

  batch      -> ("pod", "data")   data parallelism, hierarchical across pods
  seq        -> "model"           sequence parallelism between layers
  heads/ff/vocab/experts -> "model"   tensor/expert parallelism
  fsdp       -> "data"            parameter + optimizer-state sharding over
                                  the data axis (ZeRO-3 style)
  cache_seq  -> "model"           decode KV caches sharded over sequence

A spec is a tuple with one entry per tensor dim: None, a mesh axis name,
or a tuple of names (major first); `tuple()` of the reference's
`PartitionSpec` has the same form.  A mesh is anything with named axes and
sizes: a `launch.mesh.MeshSpec`, or a `torch.distributed.device_mesh.
DeviceMesh` with `mesh_dim_names`.  On a DeviceMesh a spec becomes DTensor
placements, one per mesh dim (`placements_for`, `sharding_for`), and
`constrain` redistributes a DTensor to them.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

Part = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Part, ...]

DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": ("model",),
    "embed": (),
    "head_dim": (),
    "heads": ("model",),
    "kv_heads": (),
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "fsdp": ("data",),
    "expert_fsdp": ("data",),
    "cache_batch": ("data",),
    "cache_seq": ("model",),
    "ssm_heads": ("model",),
    "state": (),
    "layers": (),
    "frames": ("model",),
}

# Serving layout: params live model-sharded (row/column-parallel), NOT
# fsdp-sharded — decode must not pay a ZeRO-3 all-gather of the weights for
# every generated token.  Checkpoints reshard on load (elastic restore).
SERVING_RULES = {"fsdp": ("model",)}

_ctx = threading.local()


def axis_names(mesh) -> Tuple[str, ...]:
    """A mesh's axis names, in mesh order."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(names)


def axis_sizes(mesh) -> Dict[str, int]:
    """A mesh's axis sizes by name."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(axis_names(mesh), (int(s) for s in shape)))


@contextmanager
def use_mesh_rules(mesh, rules: Optional[dict] = None):
    """Activate (mesh, rules) for logical-axis resolution in model code."""
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, {**DEFAULT_RULES, **(rules or {})})
    try:
        yield
    finally:
        _ctx.state = prev


def current_mesh():
    st = getattr(_ctx, "state", None)
    return st[0] if st else None


def _resolve(name: Optional[str], names: Tuple[str, ...], rules: dict
             ) -> Part:
    if name is None:
        return None
    axes = tuple(a for a in rules.get(name, ()) if a in names)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def spec_for(logical: Sequence[Optional[str]], mesh=None,
             shape: Optional[Sequence[int]] = None) -> Spec:
    """Spec from logical axis names; () outside a mesh context.

    With `shape`, axes that do not evenly divide their dimension are
    dropped (progressively, from the innermost axis of a multi-axis rule),
    as the reference does for jit's even tiling: e.g. 56 heads on a 16-way
    "model" axis fall back to replication."""
    st = getattr(_ctx, "state", None)
    if mesh is None:
        if st is None or st[0] is None:
            return ()
        mesh, rules = st
    else:
        rules = st[1] if st else DEFAULT_RULES
    names = axis_names(mesh)
    parts = [_resolve(n, names, rules) for n in logical]
    if shape is not None:
        parts = [_fit(p, dim, mesh) for p, dim in zip(parts, shape)]
    return tuple(_dedup(parts))


def _dedup(parts):
    """A mesh axis may appear once per spec: first dim wins, later drop.

    Needed when rule overrides map two logical axes of one tensor onto the
    same mesh axis (e.g. serving layouts with fsdp -> "model")."""
    seen = set()
    out = []
    for p in parts:
        if p is None:
            out.append(None)
            continue
        axes = list(p) if isinstance(p, tuple) else [p]
        kept = [a for a in axes if a not in seen]
        seen.update(kept)
        out.append(tuple(kept) if len(kept) > 1 else
                   (kept[0] if kept else None))
    return out


def _fit(part: Part, dim: int, mesh) -> Part:
    """Drop trailing mesh axes until the tiling divides `dim` evenly."""
    if part is None:
        return None
    sizes = axis_sizes(mesh)
    axes = list(part) if isinstance(part, tuple) else [part]
    while axes:
        n = 1
        for a in axes:
            n *= sizes[a]
        if dim % n == 0:
            break
        axes.pop()
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def sanitize_spec(spec: Sequence[Part], shape: Sequence[int], mesh) -> Spec:
    """Apply the divisibility fallback + axis dedup to a spec."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(_dedup([_fit(p, d, mesh) for p, d in zip(parts, shape)]))


def placements_for(spec: Sequence[Part], mesh) -> tuple:
    """DTensor placements of a spec on a mesh: per mesh dim, Shard(i) where
    that axis tiles tensor dim i, Replicate() elsewhere, and on an axis of
    size 1, which tiles nothing.  A dim tiled by several axes is split
    major to minor in mesh order, as DTensor splits a dim over several
    mesh dims."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(names)
    for i, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        # DTensor orders a dim's shards by mesh dim; a spec that names them
        # in another order would lay the blocks out differently
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec part {part} is not in mesh order "
                             f"{names}")
        for k in order:
            if sizes[names[k]] > 1:
                out[k] = Shard(i)
    return tuple(out)


def sharding_for(logical: Sequence[Optional[str]], mesh=None):
    """DTensor placements (one per mesh dim) for logical axis names on a
    DeviceMesh (default: the active one); None outside a mesh context."""
    if mesh is None:
        mesh = current_mesh()
        if mesh is None:
            return None
    return placements_for(spec_for(logical, mesh), mesh)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Pin a tensor's layout by logical names; `x` itself outside a mesh
    context.

    Under a context a DTensor is redistributed to the resolved placements
    (shape-aware: non-dividing axes fall back per `spec_for`); a plain
    tensor passes through unchanged, as on one device there is nothing to
    pin.  This is the hook the dry run uses to lay out activations."""
    st = getattr(_ctx, "state", None)
    if st is None or st[0] is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = spec_for(logical, st[0], shape=x.shape)
    want = placements_for(spec, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)
