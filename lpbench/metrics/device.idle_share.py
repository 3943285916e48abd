"""device.idle_share: the share of the traced window's wall time with no
operation on the card, in percent."""


def read(ctx):
    trace = ctx.get("trace") or {}
    if not trace.get("window_s"):
        return None
    return (1.0 - trace["busy_s"] / trace["window_s"]) * 100
