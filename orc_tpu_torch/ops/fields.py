"""Boundary-condition tensors on the device and user momentum sources
(port of the zone-table part of orc_tpu/ops/fields.py).

`device_bc` moves a `BoundaryTable` to the device as three small
per-zone tensors; `momentum_source_term` evaluates a user momentum
source. The per-face gather `face_bc` serves the face-major step, which
is not ported yet.
"""

from __future__ import annotations

import inspect

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


def momentum_source_term(source, centroids, volumes):
    """Evaluate a user momentum source with orc_tpu's contract:
    ``f(centroids [C,3]) -> [C,3]`` (already volume-integrated) or
    ``f(centroids, volumes [C]) -> [C,3]`` (for a force per unit
    volume). In the port the callable receives torch tensors on the
    mesh's device and returns one. Dispatch counts the REQUIRED
    positional parameters only, so a closure that captures by default
    argument (``lambda cc, _g=g: ...``) keeps the one-argument form."""
    required = [
        prm
        for prm in inspect.signature(source).parameters.values()
        if prm.default is inspect.Parameter.empty
        and prm.kind
        in (
            inspect.Parameter.POSITIONAL_ONLY,
            inspect.Parameter.POSITIONAL_OR_KEYWORD,
        )
    ]
    if len(required) >= 2:
        return source(centroids, volumes)
    return source(centroids)
