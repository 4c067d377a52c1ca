"""Boundary-condition tensors on the device (port of the zone-table part
of orc_tpu/ops/fields.py).

`device_bc` moves a `BoundaryTable` to the device as three small
per-zone tensors. The per-face gather `face_bc` serves the face-major
step, which is not ported yet.
"""

from __future__ import annotations

import torch

from orc_tpu_torch.mesh.zones import BoundaryTable, FaceCondition

# Integer codes used in on-device selects.
INTERIOR = int(FaceCondition.INTERIOR)
WALL = int(FaceCondition.WALL)
PRESSURE_INLET = int(FaceCondition.PRESSURE_INLET)
PRESSURE_OUTLET = int(FaceCondition.PRESSURE_OUTLET)
SYMMETRY = int(FaceCondition.SYMMETRY)
VELOCITY_INLET = int(FaceCondition.VELOCITY_INLET)


def device_bc(
    table: BoundaryTable,
    dtype: torch.dtype = torch.float64,
    *,
    device: torch.device | str,
):
    """Zone-level tensors on `device`: (codes [Z] i32, scalar [Z],
    vector [Z,3])."""
    return (
        torch.tensor(table.codes, dtype=torch.int32, device=device),
        torch.tensor(table.scalar, dtype=dtype, device=device),
        torch.tensor(table.vector, dtype=dtype, device=device),
    )
