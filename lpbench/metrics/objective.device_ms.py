"""objective.device_ms: device milliseconds of the kernels launched
inside one `calculate` (one evaluation of the dual: the sweep, the Ax
reduction, the coupling rows), the mean over the traced solve's calls."""


def read(ctx):
    trace = ctx.get("trace") or {}
    calls = trace.get("calculate_s")
    return sum(calls) / len(calls) * 1e3 if calls else None
