"""solve_s: time to tolerance of one cold solve, the window's summed wall
time of its completed solves over their count (host clock, each solve
waited for on the card)."""


def read(ctx):
    times = [s["seconds"] for s in ctx["solves"]]
    return sum(times) / len(times) if times else None
