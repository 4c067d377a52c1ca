"""Boundary-condition tensors on the device and user momentum sources
(port of orc_tpu/ops/fields.py).

`device_bc` moves a `BoundaryTable` to the device as three small
per-zone tensors; `face_bc` gathers them onto the faces (`FaceBC`) for
the face-major step; `momentum_source_term` evaluates a user momentum
source. BC types, like values, are data selected with `torch.where`.
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class FaceBC:
    """Per-face boundary-condition data gathered from the zone tables,
    with the zone tables themselves: (c,k)-shaped consumers select BC
    data zone table -> [C,K] directly (`ck()`), never through the
    per-face tensors (orc_tpu's rule, kept here so both packages run
    the same selects)."""

    code: torch.Tensor  # [F] i32 FaceCondition code
    scalar: torch.Tensor  # [F] zone scalar (boundary pressure, ...)
    vector: torch.Tensor  # [F,3] zone vector (wall / inlet velocity, ...)
    zcode: torch.Tensor  # [Z] i32 zone table
    zscalar: torch.Tensor  # [Z]
    zvector: torch.Tensor  # [Z,3]

    def is_(self, *codes: int) -> torch.Tensor:
        m = self.code == codes[0]
        for c in codes[1:]:
            m = m | (self.code == c)
        return m

    def ck(self, mesh):
        """(code, scalar, vector) per (cell, face slot): [C,K], [C,K],
        [C,K,3], a static Z-way select over the face zone slot."""
        from orc_tpu_torch.ops.ck_ops import zone_sel

        zs = mesh.face_zone_slot[mesh.cell_faces.long()]
        Z = self.zcode.shape[0]
        return tuple(zone_sel(t, zs, Z) for t in (self.zcode, self.zscalar, self.zvector))


def device_bc(
    table: BoundaryTable,
    dtype: torch.dtype = torch.float64,
    *,
    device: torch.device | str,
):
    """Zone-level tensors on `device`: (codes [Z] i32, scalar [Z],
    vector [Z,3]). Uploaded without waiting for the card: a blocking copy
    to a CUDA device would first drain its queue."""
    return (
        torch.tensor(table.codes, dtype=torch.int32).to(device, non_blocking=True),
        torch.tensor(table.scalar, dtype=dtype).to(device, non_blocking=True),
        torch.tensor(table.vector, dtype=dtype).to(device, non_blocking=True),
    )


def face_bc(mesh, zone_codes, zone_scalar, zone_vector) -> FaceBC:
    """Gather the zone BC tensors onto the faces (the vector by a static
    Z-way select, as orc_tpu does)."""
    from orc_tpu_torch.ops.ck_ops import zone_sel

    s = mesh.face_zone_slot
    idx = s.long()
    return FaceBC(
        code=zone_codes[idx],
        scalar=zone_scalar[idx],
        vector=zone_sel(zone_vector, s, zone_codes.shape[0]),
        zcode=zone_codes,
        zscalar=zone_scalar,
        zvector=zone_vector,
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
