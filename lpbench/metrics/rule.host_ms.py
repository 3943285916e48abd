"""rule.host_ms: host milliseconds of one iteration's rule step outside
its evaluation: the self time of the program's `step` spans (each less
its child `calculate` span) over their count, in the window's solves
after the first (which runs under the profiler)."""


def read(ctx):
    spans = [r for r in ctx.get("records") or ()
             if r.get("type") == "span" and r.get("solve") is not None]
    if not spans:
        return None
    first = min(s["solve"] for s in spans)
    own = {s["id"]: s["dur_s"] for s in spans
           if s["name"] == "step" and s["solve"] != first}
    for s in spans:
        if s.get("parent") in own:
            own[s["parent"]] -= s["dur_s"]
    return sum(own.values()) / len(own) * 1e3 if own else None
