"""kernels_roofline: one evaluation's least bytes (`roofline.py`, counted
from the instance's real edges) at the card's peak bandwidth, as a share
of the evaluation's device time (`objective.device_ms`), in percent."""


def read(ctx):
    trace = ctx.get("trace") or {}
    calls = trace.get("calculate_s")
    if not calls:
        return None
    device_s = sum(calls) / len(calls)
    return ctx["evaluation_bytes"] / ctx["hbm_bytes_per_s"] / device_s * 100
