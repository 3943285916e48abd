"""kernels.host_ms: host milliseconds the hand-written kernels' wrappers
take an evaluation: the program's `launch` spans (the checks, the
allocations, the ctypes call) over the count of its `calculate` spans,
in the window's solves after the first (which runs under the
profiler)."""


def read(ctx):
    spans = [r for r in ctx.get("records") or ()
             if r.get("type") == "span" and r.get("solve") is not None]
    if not spans:
        return None
    first = min(s["solve"] for s in spans)
    later = [s for s in spans if s["solve"] != first]
    calls = sum(s["name"] == "calculate" for s in later)
    launch = [s["dur_s"] for s in later if s["name"] == "launch"]
    return sum(launch) / calls * 1e3 if calls and launch else None
