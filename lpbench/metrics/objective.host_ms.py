"""objective.host_ms: host milliseconds of one evaluation: the program's
`calculate` spans (the engine's call into the objective: the sweep's and
the Ax reduction's kernel wrappers, the formulation's torch operations)
over their count, in the window's solves after the first (which runs
under the profiler)."""


def read(ctx):
    spans = [r for r in ctx.get("records") or ()
             if r.get("type") == "span" and r.get("solve") is not None]
    if not spans:
        return None
    first = min(s["solve"] for s in spans)
    calls = [s["dur_s"] for s in spans
             if s["name"] == "calculate" and s["solve"] != first]
    return sum(calls) / len(calls) * 1e3 if calls else None
