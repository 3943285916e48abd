"""setup_s: seconds from the process's start to the window's: imports,
loading the kernels (building them in a checkout's first run), generating
the instance, the program's objective and the warm-up solve."""


def read(ctx):
    return ctx["setup_s"]
