"""Compiled mesh: padded structure-of-arrays tensors (port of the
`CompiledMesh` half of orc_tpu/mesh/compile.py).

Face-major tensors [F]/[F,3] and cell-major ELL tensors [C,K] with the
same fields, dtypes and conventions as orc_tpu: int32 indices, bool
masks, floats in the mesh dtype, and the static `neighbor_offsets` /
`ck_constants` of structured boxes. Every tensor lives on one device,
the mesh's. The TGRID compile path (`compile_mesh`,
`compile_from_arrays`) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CompiledMesh:
    # --- face-major ---
    face_owner: torch.Tensor  # [F] i32
    face_neighbor: torch.Tensor  # [F] i32 (self-index at boundaries)
    face_interior: torch.Tensor  # [F] bool
    face_area: torch.Tensor  # [F]
    face_normal: torch.Tensor  # [F,3] unit, outward from owner
    face_centroid: torch.Tensor  # [F,3]
    face_zone_slot: torch.Tensor  # [F] i32 into BoundaryTable arrays
    face_lw: torch.Tensor  # [F] linear-weighted interp weight
    face_r_on: torch.Tensor  # [F,3] owner->neighbor (boundary: owner->face)
    face_dist_on: torch.Tensor  # [F] |face_r_on|
    face_dist_fo: torch.Tensor  # [F] |face centroid - owner centroid|
    # --- cell-major ---
    cell_centroid: torch.Tensor  # [C,3]
    cell_volume: torch.Tensor  # [C]
    cell_faces: torch.Tensor  # [C,K] i32 (0 at padded slots)
    cell_face_mask: torch.Tensor  # [C,K] bool
    cell_face_sign: torch.Tensor  # [C,K] +1 owner / -1 neighbor (0 padded)
    cell_neighbors: torch.Tensor  # [C,K] i32 (self at boundary/padded slots)
    # --- static metadata ---
    dim: int = 3
    # Per-column neighbor index deltas of a structured adjacency
    # (see ops.spmv.EllMatrix.offsets); None for irregular meshes.
    neighbor_offsets: tuple | None = None
    # Uniform-box per-column geometry constants
    # (int_slot, K x (area, n_out, dist_fo, dist_on, zone_slot)).
    ck_constants: tuple | None = None

    @property
    def n_cells(self) -> int:
        return self.cell_volume.shape[0]

    @property
    def n_faces(self) -> int:
        return self.face_area.shape[0]

    @property
    def max_faces_per_cell(self) -> int:
        return self.cell_faces.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.cell_volume.dtype

    @property
    def device(self) -> torch.device:
        return self.cell_volume.device


def trim_for_ck(mesh: CompiledMesh) -> CompiledMesh:
    """Copy of the mesh with every tensor the (c,k) step never reads
    replaced by a 2-row dummy, so the face tables can be freed during a
    long run. Two rows, not one, so an accidental use fails on a shape
    mismatch instead of broadcasting."""
    dt, dev = mesh.dtype, mesh.device
    d1 = torch.zeros((2,), dtype=dt, device=dev)
    d3 = torch.zeros((2, 3), dtype=dt, device=dev)
    i1 = torch.zeros((2,), dtype=torch.int32, device=dev)
    b1 = torch.zeros((2,), dtype=torch.bool, device=dev)
    K = mesh.max_faces_per_cell
    return dataclasses.replace(
        mesh,
        face_owner=i1,
        face_neighbor=i1,
        face_interior=b1,
        face_area=d1,
        face_normal=d3,
        face_centroid=d3,
        face_zone_slot=i1,
        face_lw=d1,
        face_r_on=d3,
        face_dist_on=d1,
        face_dist_fo=d1,
        cell_faces=torch.zeros((2, K), dtype=torch.int32, device=dev),
        cell_face_sign=torch.zeros((2, K), dtype=dt, device=dev),
        cell_neighbors=torch.zeros((2, K), dtype=torch.int32, device=dev),
    )
