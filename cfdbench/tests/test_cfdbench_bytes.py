"""The frozen byte formulas reproduce PERF.md's kernel table, bound
column, at 1024^2 float32."""

import pytest

from cfdbench.metrics import hbm_bytes

C = 1024 * 1024
DIMS = (1024, 1024, 1)


@pytest.mark.parametrize(
    "row, nbytes, mb",
    [
        ("row 1 B=1", lambda: hbm_bytes.spmv_bytes(C, hbm_bytes.neighbour_columns(DIMS), 1, 4), 29.4),
        ("row 2 B=3", lambda: hbm_bytes.sweep_bytes(C, hbm_bytes.neighbour_columns(DIMS), 3, 4), 58.7),
        ("row 4 TVD_DC", lambda: hbm_bytes.fc_momentum_bytes(C, hbm_bytes.ell_columns(DIMS), 4), 125.8),
        ("row 6 RC", lambda: hbm_bytes.fc_pc_bytes(C, hbm_bytes.ell_columns(DIMS), 4), 92.3),
        ("row 1 128^3 K=6", lambda: hbm_bytes.spmv_bytes(128**3, hbm_bytes.neighbour_columns((128,) * 3), 1, 4), 75.5),
        ("row 2 128^3 B=3", lambda: hbm_bytes.sweep_bytes(128**3, 6, 3, 4), 134.2),
    ],
    ids=lambda x: x if isinstance(x, str) else "",
)
def test_bound_column(row, nbytes, mb):
    assert round(nbytes() / 1e6, 1) == mb
