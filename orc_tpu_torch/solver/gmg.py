"""Geometric multigrid (port of orc_tpu/solver/gmg.py, in progress).

Only `infer_box_dims` is ported so far: the assembly kernels' column
specs need it. The GMG hierarchy and V-cycle are ROADMAP Queue 1,
item 8.
"""

from __future__ import annotations

from typing import Optional, Tuple


def infer_box_dims(
    offsets: Tuple[int, ...], n_cells: int
) -> Optional[Tuple[int, int, int]]:
    """Recover (nx, ny, nz) of a structured box from its neighbor
    offsets (cell id = ix + nx*(iy + ny*iz)).

    Interior steps contribute +/-{1, nx, nx*ny}; periodic wraps
    contribute -/+{nx-1, nx*(ny-1), nx*ny*(nz-1)}. Returns None when no
    consistent box exists (irregular mesh)."""
    pos = sorted({abs(int(d)) for d in offsets if d != 0})
    if not pos:
        return None
    # Candidate nx values: every offset magnitude o could be nx (step)
    # or o+1 could be nx (wrap nx-1); nx=1 covers 1-cell-wide axes.
    cands_x = {1}
    for o in pos:
        cands_x.add(o)
        cands_x.add(o + 1)
    for nx in sorted(cands_x):
        if nx < 1 or n_cells % nx:
            continue
        rest = n_cells // nx
        cands_y = {1}
        for o in pos:
            if o % nx == 0:
                cands_y.add(o // nx)
                cands_y.add(o // nx + 1)
        for ny in sorted(cands_y):
            if ny < 1 or rest % ny:
                continue
            nz = rest // ny
            allowed = {1, nx, nx * ny} | {
                nx - 1,
                nx * (ny - 1),
                nx * ny * (nz - 1),
            }
            allowed.discard(0)
            if set(pos) <= allowed:
                return (nx, ny, nz)
    return None
