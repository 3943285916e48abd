"""setup.build_s: seconds from the packed instance handed to the program
to its objective ready on the card (preconditioning, the Ax plan and its
work table, the formulation's rows), waited for (host clock)."""


def read(ctx):
    return ctx["build_s"]
