"""engine.iters: the mean iterations a solve of the window ran to its
stop (`SolveResult.iterations_run`)."""


def read(ctx):
    its = [s["iterations"] for s in ctx["solves"]]
    return sum(its) / len(its) if its else None
