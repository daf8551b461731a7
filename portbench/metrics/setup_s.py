"""setup_s: seconds from the process's start to the window's: imports,
the card, loading (on a first run, building) the kernels, the graph and
its layout, the weights, the gate state and the warm-up steps."""


def read(ctx):
    return ctx.setup_s
