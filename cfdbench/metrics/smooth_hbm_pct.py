"""Row 2, the fused Jacobi sweeps (ops/fused_smooth.py: one launch of
tiles in 2-D, the z-march in 3-D): the momentum smoother runs once per
outer iteration on the three components, each call reading diag, the
neighbour columns, b and x0 once and writing x once; those bytes over
the device time of the sweep kernels, against the card's HBM rate."""

from cfdbench.metrics import hbm_bytes

KERNELS = ("orc::jacobi_",)


def read(ctx):
    n, t = ctx.kernel_sum(KERNELS)
    if ctx.dims is None or n <= 0 or t <= 0:
        return None
    b = ctx.k * hbm_bytes.sweep_bytes(ctx.cells, hbm_bytes.neighbour_columns(ctx.dims), 3, ctx.value_bytes)
    return 100.0 * b / t / ctx.hbm_bytes_per_s
