"""The traced run's device trace: a torch.profiler window over one whole
solve, recording the card's activity alone (kernels, copies), and its
reduction to what the per-layer readers take.

Recording the host's operations too cost the solve more than its own
time on an H100 (1.55 to 3.6 ms an iteration of the matching cell), and
the card then idled waiting for the profiler; so the host's side is not
recorded, and tiny marker kernels of operations the solve path never
launches carry what the trace needs from the host:

  * the window's edges.  The card's timestamps can read milliseconds early
    (4 ms seen), and the trace then drops the first kernels of a window.
    So, as the program's `ProfilerHook` does, the profiler starts in a
    warm-up step whose events are discarded, and the window is bracketed
    by a burst of PRIME_KERNELS tiny kernels spread over PRIME_SECONDS at
    each edge (`atan` before the solve, `sinh` after it): what the trace
    may lose at an edge are those.  The window runs from the last kernel
    of the first burst to the first of the second.
  * each evaluation of the dual: a `sin` kernel before `calculate` and a
    `cos` kernel after it.  The card runs one stream in order, so the
    kernels between the two are the evaluation's.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch

PRIME_KERNELS = 256
PRIME_SECONDS = 0.05
# marker operations, and the part of their kernels' names that is theirs
PRIME, DRAIN, ENTER, EXIT = "atan", "sinh", "sin", "cos"


def _marks(op: str, name: str) -> bool:
    return f"{op}_kernel_cuda" in name


def burst(op: str, device) -> None:
    """PRIME_KERNELS tiny `op` kernels over PRIME_SECONDS, waited for."""
    x = torch.zeros(32, device=device)
    for _ in range(PRIME_KERNELS):
        getattr(x, op + "_")()
        time.sleep(PRIME_SECONDS / PRIME_KERNELS)
    torch.cuda.synchronize(device)


class DeviceTrace:
    """`with DeviceTrace(device) as tr: ...` traces the card's activity
    over the body, bracketed; `tr.enter()` / `tr.exit()` mark an
    evaluation while the trace is on; `tr.reduce()` afterwards."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.mark = torch.zeros(1, device=self.device)
        self.active = False
        self._prof = None
        self.events = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, schedule
        self._prof = profile(activities=[ProfilerActivity.CUDA],
                             schedule=schedule(wait=0, warmup=1, active=1))
        self._prof.start()
        burst(PRIME, self.device)                 # the warm-up, discarded
        self._prof.step()
        burst(PRIME, self.device)
        self.active = True
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        self.active = False
        burst(DRAIN, self.device)
        self._prof.stop()
        self.events = [(e.start_ns(), e.end_ns(), e.name())
                       for e in self._prof.profiler.kineto_results.events()
                       if _on_device(e)]
        self._prof = None
        return False

    def enter(self) -> None:
        if self.active:
            self.mark.sin_()

    def exit(self) -> None:
        if self.active:
            self.mark.cos_()

    def reduce(self) -> dict:
        return reduce_events(self.events or [])


def _on_device(e) -> bool:
    """A kernel, copy or fill on the card (not a range the profiler
    mirrors onto the card's timeline)."""
    if not str(e.device_type()).endswith("CUDA"):
        return False
    kind = getattr(e, "activity_type", lambda: "")()
    return "annotation" not in str(kind) and not e.name().startswith(
        "ProfilerStep")


def reduce_events(events: List[tuple]) -> dict:
    """From the card's (start ns, end ns, name) events: the window's busy
    and total seconds, each evaluation's device seconds, the operations
    by device time and the idle time summed by what the card waited
    for."""
    events = sorted(events)
    prime = [b for a, b, n in events if _marks(PRIME, n)]
    drain = [a for a, b, n in events if _marks(DRAIN, n)]
    out = {"events": len(events)}
    if not prime or not drain:
        return out
    w0, w1 = max(prime), min(drain)
    inside = [(a, b, n) for a, b, n in events if a >= w0 and b <= w1]
    busy, cur_a, cur_b, prev_end = 0, None, None, w0
    calls: List[int] = []
    in_call, acc, last_name = False, 0, ""
    gaps = []
    by_name: Dict[str, int] = {}
    for a, b, name in inside:
        if a > prev_end:
            where = ("inside calculate" if in_call else
                     "the solve's start (the engine's set-up)"
                     if not last_name else
                     "after a read to the host (the engine's check)"
                     if "DtoH" in last_name else
                     "between evaluations (the rule's step, the engine)")
            gaps.append((a - prev_end, where))
        prev_end = max(prev_end, b)
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
        last_name = name
        if _marks(ENTER, name):
            in_call, acc = True, 0
        elif _marks(EXIT, name):
            if in_call:
                calls.append(acc)
            in_call = False
        else:
            by_name[name] = by_name.get(name, 0) + (b - a)
            if in_call:
                acc += b - a
    if cur_b is not None:
        busy += cur_b - cur_a
    if w1 > prev_end:
        gaps.append((w1 - prev_end, "the solve's end (the engine's return)"))
    idle: Dict[str, int] = {}
    for d, w in gaps:
        idle[w] = idle.get(w, 0) + d
    out.update(
        window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
        calculate_s=[v / 1e9 for v in calls],
        device_ops=[[n, v / 1e9] for n, v in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        idle_gaps=[[w, d / 1e9] for w, d in
                   sorted(idle.items(), key=lambda kv: -kv[1])])
    return out
