"""engine.host_ms: the engine's own `host` spans (its one device-to-host
read a chunk and what it decides from it) summed over the window, per
iteration, in milliseconds."""


def read(ctx):
    records = ctx.get("records")
    its = sum(s["iterations"] for s in ctx["solves"])
    if not records or not its:
        return None
    host = [r["dur_s"] for r in records
            if r.get("type") == "span" and r.get("name") == "host"]
    return sum(host) / its * 1e3 if host else None
