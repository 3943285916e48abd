"""Fault injectors (port of `repro.testing.faults`, DESIGN.md §9).

  * `NaNInjectingObjective` poisons the objective inside the chunk: a
    persistent fault, deterministic in λ, so a retry meets it again (the
    DIVERGED path).  The condition is a `torch.where` on the device: the
    wrapper holds no host branch.
  * `ChunkFaultInjector` poisons a chunk's result through
    `SolveEngine.chunk_fault_hook`: a transient fault that fires a set
    number of times, so a retry succeeds (the rollback path).
  * `PreemptAfter`: a `preempt_fn` that trips after n chunk boundaries.
  * `corrupt_checkpoint` / `litter_tmp` sabotage a checkpoint directory.
"""
from __future__ import annotations

import os
from typing import Optional

import torch


class NaNInjectingObjective:
    """Wrap an objective so that its `calculate` returns NaN (g, grad).

    mode="always"     every evaluation is poisoned;
    mode="trip_norm"  poisoned once ‖λ‖₂ >= `trip_norm`.

    Every other attribute delegates to the wrapped objective."""

    def __init__(self, inner, mode: str = "always",
                 trip_norm: Optional[float] = None):
        if mode not in ("always", "trip_norm"):
            raise ValueError(f"mode must be 'always' or 'trip_norm', "
                             f"got {mode!r}")
        if mode == "trip_norm" and trip_norm is None:
            raise ValueError("mode='trip_norm' requires trip_norm")
        self.inner = inner
        self.mode = mode
        self.trip_norm = trip_norm

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def calculate(self, lam, gamma):
        g, grad, aux = self.inner.calculate(lam, gamma)
        if self.mode == "always":
            bad = torch.ones((), dtype=torch.bool, device=g.device)
        else:
            bad = (torch.linalg.vector_norm(lam)
                   >= torch.full((), self.trip_norm, dtype=torch.float32,
                                 device=lam.device))
        nan = torch.full((), float("nan"), dtype=g.dtype, device=g.device)
        g = torch.where(bad, nan, g)
        grad = torch.where(bad, torch.full_like(grad, float("nan")), grad)
        return g, grad, aux


class ChunkFaultInjector:
    """Transient fault for `SolveEngine.chunk_fault_hook`: fills one
    SolveState field with NaN when the chunk starting at iteration `at_it`
    completes, for its first `times` encounters."""

    def __init__(self, at_it: int, times: int = 1, field: str = "lam"):
        self.at_it = int(at_it)
        self.times = int(times)
        self.field = field
        self.injected = 0

    def __call__(self, it_start, state, stats):
        if it_start == self.at_it and self.injected < self.times:
            self.injected += 1
            poison = torch.full_like(getattr(state, self.field), float("nan"))
            state = state._replace(**{self.field: poison})
        return state, stats


class PreemptAfter:
    """A `preempt_fn` that returns True after `n` chunk boundaries."""

    def __init__(self, n: int):
        self.n = int(n)
        self.calls = 0

    def __call__(self) -> bool:
        self.calls += 1
        return self.calls > self.n


def corrupt_checkpoint(directory: str, step: Optional[int] = None,
                       kind: str = "truncate") -> str:
    """Sabotage a committed checkpoint step (the latest by default):
    "truncate" halves arrays.npz, "garbage" overwrites it with non-zip
    bytes, "drop_meta" deletes meta.json.  Returns the step's path."""
    from ..checkpoint.manager import CheckpointManager
    mgr = CheckpointManager(directory)
    if step is None:
        step = mgr.latest_step()
        if step is None:
            raise ValueError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    npz = os.path.join(path, "arrays.npz")
    if kind == "truncate":
        size = os.path.getsize(npz)
        with open(npz, "rb+") as f:
            f.truncate(max(size // 2, 1))
    elif kind == "garbage":
        with open(npz, "wb") as f:
            f.write(b"not a zipfile, definitely")
    elif kind == "drop_meta":
        os.remove(os.path.join(path, "meta.json"))
    else:
        raise ValueError(f"unknown corruption kind {kind!r}")
    return path


def litter_tmp(directory: str, step: int = 999, old: bool = False) -> str:
    """Leave a crash leftover `step_N.tmp/` (or `.old/`) holding junk, as a
    kill mid-save would."""
    suffix = ".old" if old else ".tmp"
    path = os.path.join(directory, f"step_{step:010d}{suffix}")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "arrays.npz"), "wb") as f:
        f.write(b"half-written junk")
    return path
