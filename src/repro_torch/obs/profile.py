"""Opt-in torch.profiler window over the chunked solve loop (DESIGN.md
§11); port of `repro.obs.profile`.

Profiling every chunk of a long solve would swamp the trace, so
`ProfilerHook` traces a *window* of chunks: it starts at chunk
`start_chunk` and stops after `num_chunks` (the CLI's `--profile-dir`,
`--profile-start-chunk`, `--profile-num-chunks`).  It records the host's
activity and, when the engine's device is a card, the card's kernels,
and writes one Chrome trace a window into `trace_dir`, named with the
rank and the chunk range (`trace_rank0_chunks2-3.json`).

The engine drives it at chunk boundaries: `chunk_start` before a chunk
is enqueued, `chunk_end` after the chunk's host read (the device has
finished it), and `stop` from its `finally`, so a solve that diverges,
is preempted or raises mid-window still writes its trace.  Start and
stop go into the run log as `profile` events.

On the card the trace drops a kernel whose timestamp falls outside the
interval the profiler recorded, and the card's timestamps can read
milliseconds early: in some windows on an H100 the first of the
window's launches were missing from the trace, and `tests/
torch_trace_loss.py` saw a kernel start 3.97 ms before its own launch on
the trace's clock (PERF.md §6).  So the profiler starts one chunk before
the window, in torch.profiler's warm-up (recording, its events
discarded; a window at chunk 0 has no chunk before it and starts cold),
and the hook brackets the window with `PRIME_KERNELS` tiny kernels
spread over `PRIME_SECONDS`, in a `ProfilerHook.prime` range when it
steps into the window and a `ProfilerHook.drain` range before it stops,
so that what the trace may lose at either edge are those.  Spread out,
they add a few hundred events to the trace (back to back, 50 ms of
them were ~5,000 kernels a burst and made a one-chunk trace five times
larger).

The profiler takes one window at a time in a process: a hook that finds
another profiler running raises instead of skipping silently.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

import torch

__all__ = ["ProfilerHook"]

PRIME_KERNELS = 256
PRIME_SECONDS = 0.05


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


class ProfilerHook:
    def __init__(self, trace_dir: str, start_chunk: int = 0,
                 num_chunks: int = 1):
        if num_chunks < 1:
            raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
        self.trace_dir = trace_dir
        self.start_chunk = int(start_chunk)
        self.num_chunks = int(num_chunks)
        self.active = False
        self.trace_paths: List[str] = []   # one a window written
        self._done = False
        self._prof = None
        self._device = None
        self._first = self._last = None

    def chunk_start(self, chunk_idx: int, telemetry=None,
                    device=None) -> None:
        """Called before chunk `chunk_idx` is enqueued on `device`."""
        if self.active:
            self._last = chunk_idx
            return
        if self._done or chunk_idx < self.start_chunk - 1:
            return
        if self._prof is None:
            self._begin(device, warm=chunk_idx < self.start_chunk)
            if chunk_idx < self.start_chunk:
                return                        # the warm-up chunk
        else:
            self._prof.step()                 # warm-up -> recording
        self._burst("ProfilerHook.prime")
        self.active = True
        self._first = self._last = chunk_idx
        if telemetry is not None:
            telemetry.event("profile", action="start", dir=self.trace_dir,
                            chunk=chunk_idx)

    def _begin(self, device, warm: bool) -> None:
        if torch._C._autograd._profiler_enabled():
            raise RuntimeError(
                "ProfilerHook: another profiler is already running in this "
                "process; torch.profiler records one window at a time")
        from torch.profiler import ProfilerActivity, profile, schedule
        self._device = torch.device(device) if device is not None else None
        activities = [ProfilerActivity.CPU]
        if self._device is not None and self._device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.trace_dir, exist_ok=True)
        self._prof = profile(
            activities=activities,
            schedule=(schedule(wait=0, warmup=1, active=self.num_chunks)
                      if warm else None))
        self._prof.start()

    def _burst(self, name: str) -> None:
        """A burst of tiny kernels at an edge of the window (module doc)."""
        dev = self._device
        if dev is None or dev.type != "cuda":
            return
        with torch.profiler.record_function(name):
            x = torch.zeros(32, device=dev)
            for _ in range(PRIME_KERNELS):
                x.add_(1.0)
                time.sleep(PRIME_SECONDS / PRIME_KERNELS)
            torch.cuda.synchronize(dev)

    def chunk_end(self, chunk_idx: int, telemetry=None) -> None:
        """Called after chunk `chunk_idx`'s host read."""
        if not self.active:
            return
        if chunk_idx + 1 - self.start_chunk >= self.num_chunks:
            self.stop(telemetry, chunk=chunk_idx)

    def stop(self, telemetry=None, chunk: Optional[int] = None) -> None:
        """Flush the trace; idempotent (the engine calls it in finally).
        Waits for the card first, so the window's kernels are in it, then
        closes the window with the drain burst.  A solve that ends during
        the warm-up writes no trace."""
        if not self.active:
            if self._prof is not None:        # ended in the warm-up
                self._prof.stop()
                self._prof = None
                self._done = True
            return
        self.active = False
        self._done = True
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self._burst("ProfilerHook.drain")
        self._prof.stop()
        last = self._last if chunk is None else chunk
        path = os.path.join(
            self.trace_dir,
            f"trace_rank{_rank()}_chunks{self._first}-{last}.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        self.trace_paths.append(path)
        if telemetry is not None:
            telemetry.event("profile", action="stop", dir=self.trace_dir,
                            chunk=chunk, trace=path)
