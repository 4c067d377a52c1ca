"""Device operations launched per outer iteration (kernels, copies and
sets), over the traced sub-window."""

KERNELS = ()


def read(ctx):
    n = sum(v[0] for v in ctx.trace.kernels.values())
    return n / ctx.k if n > 0 else None
