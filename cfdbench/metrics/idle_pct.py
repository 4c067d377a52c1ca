"""Share of the traced sub-window with no device operation running, in
percent. The profiler's own host cost is inside the window, so compare
it only with other traced runs."""

KERNELS = ()


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
