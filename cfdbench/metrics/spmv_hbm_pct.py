"""Row 1, the shift SpMV (ops/shift_spmv.py): bytes per call from the
cell's shapes (diag, the neighbour columns and x read once, y written
once, one batch row) times its launches, over its device time, against
the card's HBM rate. Every launch is counted as one batch row, so the
momentum residual's three-row call is undercounted and the share is a
lower bound."""

from cfdbench.metrics import hbm_bytes

KERNELS = ("orc::shift_spmv_kernel",)


def read(ctx):
    n, t = ctx.kernel_sum(KERNELS)
    if ctx.dims is None or n <= 0 or t <= 0:
        return None
    b = n * hbm_bytes.spmv_bytes(ctx.cells, hbm_bytes.neighbour_columns(ctx.dims), 1, ctx.value_bytes)
    return 100.0 * b / t / ctx.hbm_bytes_per_s
