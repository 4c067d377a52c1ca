"""Rows 4 and 6, the SIMPLE_FC assembly kernels (ops/fused_assembly.py
fc_momentum_assembly and fc_pc_assembly), each once per outer
iteration: their inputs read once and outputs written once, over their
device time, against the card's HBM rate (TVD_DC momentum, Rhie-Chow
faces, linear face pressures: the flagship's instances)."""

from cfdbench.metrics import hbm_bytes

KERNELS = ("orc::fc_momentum_kernel", "orc::fc_pc_kernel")


def read(ctx):
    if ctx.dims is None:
        return None
    K, C, s = hbm_bytes.ell_columns(ctx.dims), ctx.cells, ctx.value_bytes
    per_kernel = {
        KERNELS[0]: hbm_bytes.fc_momentum_bytes(C, K, s),
        KERNELS[1]: hbm_bytes.fc_pc_bytes(C, K, s),
    }
    b = t = 0.0
    for name, nbytes in per_kernel.items():
        n, tk = ctx.kernel_sum((name,))
        if n > 0:
            b += ctx.k * nbytes
            t += tk
    if b <= 0 or t <= 0:
        return None
    return 100.0 * b / t / ctx.hbm_bytes_per_s
