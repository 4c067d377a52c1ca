"""Frozen byte counts of the port's kernels, computed from the cell's
shapes: each input read once, each output written once (PERF.md's kernel
table, "bound" column). C cells, K neighbour columns, B batch rows, s
bytes per value; the flag word of the assembly kernels is 4 bytes."""


def spmv_bytes(C, K, B, s):
    """Row 1, the shift SpMV: diag and K columns, x read, y written."""
    return (1 + K + 2 * B) * C * s


def sweep_bytes(C, K, B, s):
    """Row 2, the fused Jacobi sweeps (every sweep of one call): diag, K
    columns, b and x0 read, x written."""
    return (1 + K + 3 * B) * C * s


def fc_momentum_bytes(C, K, s, tvd=True, p_so=False):
    """Row 4, fc_momentum_assembly: vel (3), p, K flux planes, grad vel
    (9, TVD_DC) and grad p (3, SecondOrder) read; diag, K off, b (3)
    written; the flags."""
    reads = 3 + 1 + K + 9 * int(tvd) + 3 * int(p_so)
    return C * (4 + (reads + 1 + K + 3) * s)


def fc_pc_bytes(C, K, s, rc=True):
    """Row 6, fc_pc_assembly: vel (3), the momentum diagonal and grad p
    (3, Rhie-Chow) read; diag, K off, b and K flux_h planes written; the
    flags."""
    return C * (4 + (4 + 3 * int(rc) + 2 + 2 * K) * s)


def neighbour_columns(dims):
    """Columns of a box's matrix with a neighbour: two per axis longer
    than one cell (what the SpMV and sweeps read)."""
    return 2 * sum(1 for n in dims if n > 1)


def ell_columns(dims):
    """ELL width of the box (the flux planes, the assembly outputs): the
    neighbour columns, at least 6."""
    return max(neighbour_columns(dims), 6)
