"""Checkpointing: atomic step directories, keep-last-k, resume; port of
`repro.checkpoint.manager` with the same on-disk layout.

  * atomic commit: a step is written to `step_<10 digits>.tmp/` and
    renamed, so a crash mid-write never corrupts the latest checkpoint;
  * resume: `restore_latest` / `restore_flat` read the newest committed
    step;
  * arrays are host numpy in `arrays.npz` under flatten keys (a bfloat16
    tensor as its exact float32 values, cast back on restore)
    ('.lam', '.extra/.l_diag' for a NamedTuple state, '0', 'a' for tuples
    and dicts), with `meta.json` holding the step, the structure, the
    array count and the caller's `extra` dict.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

# committed step dirs are exactly step_<10 digits>; anything else (".tmp"
# mid-write litter, ".old" replaced-step litter, user files) is never a step
_STEP_RE = re.compile(r"^step_(\d{10})$")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs in the reference's flatten order and key form."""
    def join(part):
        return f"{prefix}/{part}" if prefix else part
    if _is_namedtuple(tree):
        for name, child in zip(tree._fields, tree):
            yield from _walk(child, join(f".{name}"))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], join(str(k)))
    elif isinstance(tree, (tuple, list)):
        for i, child in enumerate(tree):
            yield from _walk(child, join(str(i)))
    elif tree is not None:
        yield prefix, tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:    # numpy has none; exact in float32
            leaf = leaf.float()
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in _walk(tree)}


def _structure(tree) -> str:
    if _is_namedtuple(tree):
        return (f"{type(tree).__name__}("
                + ", ".join(f"{n}={_structure(c)}"
                            for n, c in zip(tree._fields, tree)) + ")")
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_structure(c) for c in tree) + ")"
    return "*"


def _rebuild(like, leaves: Iterator):
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(c, leaves) for c in like))
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(c, leaves) for c in like)
    if like is None:
        return None
    return next(leaves)


class CheckpointManager:
    """Retention: after each save all but the newest `keep_last` committed
    steps are pruned (`max_to_keep` is an alias that wins when given).  A
    step a resume loaded is protected from pruning for this manager's
    lifetime, so the known-good restore point survives post-resume
    saves."""

    def __init__(self, directory: str, keep_last: int = 3,
                 max_to_keep: Optional[int] = None):
        self.dir = directory
        self.keep_last = keep_last if max_to_keep is None else int(max_to_keep)
        self._protected_steps: set = set()
        os.makedirs(directory, exist_ok=True)
        self._sweep_litter()

    def _sweep_litter(self):
        """Remove crash leftovers: a half-written `step_N.tmp/` or the
        replaced copy `step_N.old/` of a re-saved step."""
        for name in os.listdir(self.dir):
            if name.endswith((".tmp", ".old")):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    def save(self, step: int, state: Any, extra: Optional[Dict] = None):
        tmp = os.path.join(self.dir, f"step_{step:010d}.tmp")
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = _flatten(state)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        meta = {"step": step, "treedef": _structure(state),
                "n_arrays": len(flat), "extra": extra or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            # a re-save of a committed step swaps through `.old`, so the
            # step is valid at every instant
            old = final + ".old"
            if os.path.exists(old):
                shutil.rmtree(old)
            os.rename(final, old)
            os.rename(tmp, final)    # atomic commit
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, final)    # atomic commit
        self._prune()
        return final

    def _prune(self):
        steps = self.all_steps()
        keep = set(steps[-self.keep_last:]) if self.keep_last > 0 else set()
        for s in steps:
            if s in keep or s in self._protected_steps:
                continue
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load_step(self, step: int) -> Tuple[Dict[str, np.ndarray], Dict]:
        """A committed step's arrays and meta; a corrupt or truncated
        checkpoint raises ValueError naming its path."""
        path = os.path.join(self.dir, f"step_{step:010d}")
        npz = os.path.join(path, "arrays.npz")
        try:
            with np.load(npz) as z:
                data = {k: z[k] for k in z.files}
        except FileNotFoundError:
            raise ValueError(
                f"checkpoint step {step} at {path} is missing arrays.npz "
                f"(incomplete or deleted checkpoint)") from None
        except Exception as e:
            raise ValueError(
                f"checkpoint arrays at {npz} are unreadable ({e}); the "
                f"file is corrupt — delete the step dir and resume from "
                f"an earlier checkpoint") from e
        meta_path = os.path.join(path, "meta.json")
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except FileNotFoundError:
            raise ValueError(
                f"checkpoint step {step} at {path} is missing meta.json "
                f"(incomplete or deleted checkpoint)") from None
        except Exception as e:
            raise ValueError(
                f"checkpoint metadata at {meta_path} is unreadable "
                f"({e}); the file is corrupt — delete the step dir and "
                f"resume from an earlier checkpoint") from e
        if meta.get("n_arrays") not in (None, len(data)):
            raise ValueError(
                f"checkpoint step {step} at {path} holds {len(data)} "
                f"arrays but its metadata promises {meta['n_arrays']} "
                f"(truncated write?)")
        # this step restored cleanly: exempt it from pruning
        self._protected_steps.add(step)
        return data, meta

    def restore_flat(self, step: int) -> Tuple[Dict[str, np.ndarray], Dict]:
        """The raw flattened arrays (flatten key -> numpy) and the `extra`
        dict, for callers that rebuild the state themselves
        (`UpdateRule.state_from_flat`)."""
        data, meta = self._load_step(step)
        return data, meta["extra"]

    def restore(self, step: int, like: Any, device=None, mesh=None,
                placements: Any = None) -> Tuple[Any, Dict]:
        """Restore into the structure of `like`: each tensor leaf comes
        back as a tensor of its dtype on `device` (default: the leaf's
        own), each other leaf as a numpy array of its dtype.

        The elastic-reshard hook: with a DeviceMesh `mesh` and
        `placements` (a tree of `like`'s structure, each leaf a tuple of
        DTensor placements, one per mesh dim), each tensor leaf comes back
        as a DTensor laid out so, whatever layout it was saved from (a
        checkpoint holds whole arrays)."""
        if placements is not None:
            tree, extra = self.restore(step, like, device)
            return _distribute(tree, mesh, placements), extra
        data, meta = self._load_step(step)
        leaves = []
        for key, leaf in _walk(like):
            if key not in data:
                raise ValueError(
                    f"checkpoint step {step} in {self.dir} has no array "
                    f"'{key}' required by the requested structure (saved "
                    f"under a different state layout?)")
            arr = data[key]
            if isinstance(leaf, torch.Tensor):
                leaves.append(torch.as_tensor(
                    arr, device=leaf.device if device is None else device
                ).to(leaf.dtype))
            else:
                leaves.append(np.asarray(arr, np.asarray(leaf).dtype))
        return _rebuild(like, iter(leaves)), meta["extra"]

    def restore_latest(self, like: Any, device=None, mesh=None,
                       placements: Any = None):
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, like, device, mesh, placements)
        return step, tree, extra


def _distribute(tree, mesh, placements):
    """`tree` with each tensor leaf laid out on `mesh` by the matching
    leaf of `placements` (a tree of the same structure; None keeps the
    leaf as it is)."""
    if isinstance(tree, torch.Tensor):
        if placements is None:
            return tree
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(tree, mesh, list(placements))
    if _is_namedtuple(tree):
        return type(tree)(*(_distribute(c, mesh, p)
                            for c, p in zip(tree, placements)))
    if isinstance(tree, dict):
        return {k: _distribute(v, mesh, placements[k])
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_distribute(c, mesh, p)
                          for c, p in zip(tree, placements))
    return tree
