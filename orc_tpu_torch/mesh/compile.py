"""Mesh compiler: RawMesh or face arrays -> padded structure-of-arrays
tensors (port of orc_tpu/mesh/compile.py).

Face-major tensors [F]/[F,3] and cell-major ELL tensors [C,K] with the
same fields, dtypes and conventions as orc_tpu: int32 indices, bool
masks, floats in the mesh dtype, the static `neighbor_offsets` of a
structured adjacency and the `ck_constants` of uniform boxes. A mesh
without constant neighbour offsets is RCM-reordered and carries a slice
plan (mesh/reorder.py). Host work is numpy, as in orc_tpu; every field
moves to the mesh's device in one transfer.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orc_tpu_torch.mesh.geometry import derive_geometry
from orc_tpu_torch.mesh.reorder import (
    SlicePlan,
    build_best_slice_plan,
    rcm_permutation,
)
from orc_tpu_torch.mesh.tgrid import RawMesh
from orc_tpu_torch.mesh.zones import BoundaryTable, FaceCondition
from orc_tpu_torch.utils.device import resolve_device


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
    # Vertex-interpolation tables of node-based Green-Gauss
    # (mesh/nodes.py NodeInterp), built on request from the raw face-node
    # topology the compiled mesh otherwise discards.
    nodes: "object | None" = None
    # Irregular meshes: the RCM permutation (cell_order[new_id] = old_id,
    # [C] i32; None when the input order was kept) and the slice plan of
    # EllMatrix.prepare() and the neighbour-value gather.
    cell_order: "torch.Tensor | None" = None
    slice_plan: "SlicePlan | None" = None

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
        nodes=None,
    )


def compile_mesh(
    raw: RawMesh,
    dtype: torch.dtype = torch.float64,
    nodes: bool = False,
    device: torch.device | str = "cuda",
):
    """Compile a parsed mesh into (CompiledMesh, BoundaryTable) on
    `device`.

    Translational-periodic pairs (RawMesh.periodic_pairs) are merged:
    each (face, shadow) pair becomes one interior face between the two
    owner cells, with the periodic translation folded into the face
    interpolation geometry. `nodes=True` also builds the vertex tables of
    node-based Green-Gauss (mesh/nodes.py), their cell ids remapped
    through the RCM `cell_order` when the mesh was reordered."""
    device = resolve_device(device)
    geo = derive_geometry(raw)
    table = BoundaryTable(raw.face_zones)
    zone_slot = np.array(
        [table.slot_of_zone[z] for z in raw.face_zone_id], dtype=np.int64
    )
    fo, fn = geo.face_owner, geo.face_neighbor
    fa, fnorm, fc = geo.face_area, geo.face_normal, geo.face_centroid
    face_shift = None
    if raw.periodic_pairs.size:
        fo, fn, fa, fnorm, fc, zone_slot, face_shift = _merge_periodic(
            raw.periodic_pairs, table, fo, fn, fa, fnorm, fc, zone_slot
        )
    mesh = compile_from_arrays(
        dim=raw.dim,
        face_owner=fo,
        face_neighbor=fn,
        face_area=fa,
        face_normal=fnorm,
        face_centroid=fc,
        face_zone_slot=zone_slot,
        cell_centroid=geo.cell_centroid,
        cell_volume=geo.cell_volume,
        dtype=dtype,
        face_shift=face_shift,
        device=device,
    )
    if nodes:
        from orc_tpu_torch.mesh.nodes import build_node_interp

        ni = build_node_interp(raw, geo.cell_centroid, dtype=mesh.dtype, device=device)
        if mesh.cell_order is not None:
            # The tables name cells in the raw order; the weights stay.
            order = mesh.cell_order.cpu().numpy()
            inv = np.empty(order.shape[0], dtype=np.int64)
            inv[order] = np.arange(order.shape[0])
            remapped = inv[ni.node_cells.cpu().numpy()]
            ni = dataclasses.replace(
                ni,
                node_cells=torch.tensor(remapped, dtype=torch.int32, device=device),
            )
        mesh = dataclasses.replace(mesh, nodes=ni)
    return mesh, table


def to_raw_order(mesh: CompiledMesh, arr):
    """A compiled-order cell array in the raw-mesh cell order (numpy;
    identity when no reordering was applied)."""
    a = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else arr
    if mesh.cell_order is None:
        return np.asarray(a)
    order = mesh.cell_order.cpu().numpy()
    inv = np.empty(order.shape[0], dtype=np.int64)
    inv[order] = np.arange(order.shape[0])
    return np.asarray(a)[inv]


def _merge_periodic(
    pairs, table, owner, neighbor, area, normal, centroid, zone_slot
):
    """Fold (periodic, shadow) face pairs into single interior faces:
    the periodic-side face keeps its owner and geometry, its neighbour
    becomes the shadow face's owner, and the translation
    x_f(periodic) - x_f(shadow) is returned as the face shift. Shadow
    faces are dropped; merged faces take the interior zone slot."""
    f_idx = np.asarray(pairs[:, 0], dtype=np.int64)
    s_idx = np.asarray(pairs[:, 1], dtype=np.int64)
    owner = np.asarray(owner, dtype=np.int64).copy()
    neighbor = np.asarray(neighbor, dtype=np.int64).copy()
    zone_slot = np.asarray(zone_slot, dtype=np.int64).copy()
    if (neighbor[f_idx] >= 0).any() or (neighbor[s_idx] >= 0).any():
        raise ValueError("periodic pair references a non-boundary face")

    shift = np.zeros_like(centroid)
    shift[f_idx] = centroid[f_idx] - centroid[s_idx]
    # Translational periodicity only: one translation per pair zone.
    for slot in np.unique(zone_slot[f_idx]):
        sel = zone_slot[f_idx] == slot
        sh = shift[f_idx][sel]
        if np.abs(sh - sh[0]).max() > 1e-9 * max(1.0, np.abs(sh).max()):
            raise NotImplementedError(
                "rotationally-periodic zones are not supported (pair "
                "translations differ within one zone)"
            )
    neighbor[f_idx] = owner[s_idx]

    interior_slots = [
        table.slot_of_zone[zid]
        for zid, fz in table.zones.items()
        if fz.zone_type == FaceCondition.INTERIOR
    ]
    if not interior_slots:
        raise ValueError("periodic merge requires an interior face zone")
    zone_slot[f_idx] = interior_slots[0]

    keep = np.ones(owner.shape[0], dtype=bool)
    keep[s_idx] = False
    return (
        owner[keep],
        neighbor[keep],
        np.asarray(area)[keep],
        np.asarray(normal)[keep],
        np.asarray(centroid)[keep],
        zone_slot[keep],
        shift[keep],
    )


def compile_from_arrays(
    dim: int,
    face_owner: np.ndarray,
    face_neighbor: np.ndarray,  # -1 for boundary faces
    face_area: np.ndarray,
    face_normal: np.ndarray,  # unit, outward from owner
    face_centroid: np.ndarray,
    face_zone_slot: np.ndarray,
    cell_centroid: np.ndarray,
    cell_volume: np.ndarray,
    dtype: torch.dtype = torch.float64,
    face_shift: np.ndarray | None = None,  # [F,3] periodic translation
    device: torch.device | str = "cuda",
) -> CompiledMesh:
    """CompiledMesh on `device` from numpy face and cell arrays.

    `face_shift` translates each interior face's neighbour centroid to
    its periodic image before the interpolation helpers (lw, r_on, dist)
    are derived; it is nonzero only on merged periodic faces.

    A structured adjacency (constant per-column neighbour deltas) keeps
    the input order and sets `neighbor_offsets`. Any other mesh of more
    than 2 cells is RCM-reordered (`cell_order`) and gets the slice plan
    of the lowest modelled cost (`slice_plan`, with the neighbour-gather
    table)."""
    device = resolve_device(device)
    C = cell_volume.shape[0]
    owner = np.asarray(face_owner, dtype=np.int64)
    neighbor = np.asarray(face_neighbor, dtype=np.int64)
    interior = neighbor >= 0
    neighbor_safe = np.where(interior, neighbor, owner)
    cell_centroid = np.asarray(cell_centroid)
    cell_volume = np.asarray(cell_volume)
    face_centroid = np.asarray(face_centroid)

    # Interpolation helpers (w = dx0 / (dx0 + dx1), centroid -> face,
    # solver.rs:988-991); periodic faces see the neighbour's image.
    shift = (
        np.zeros_like(np.asarray(face_normal, dtype=np.float64))
        if face_shift is None
        else np.asarray(face_shift, dtype=np.float64)
    )
    nbr_centroid = cell_centroid[neighbor_safe] + shift
    dx0 = np.linalg.norm(cell_centroid[owner] - face_centroid, axis=1)
    dx1 = np.linalg.norm(nbr_centroid - face_centroid, axis=1)
    lw = np.where(interior, dx0 / np.maximum(dx0 + dx1, 1e-300), 0.0)
    r_on = np.where(
        interior[:, None],
        nbr_centroid - cell_centroid[owner],
        face_centroid - cell_centroid[owner],
    )
    dist_on = np.linalg.norm(r_on, axis=1)

    cell_faces, cell_face_mask, cell_face_sign, cell_neighbors = _build_ell(
        owner, neighbor, neighbor_safe, interior, C
    )
    entry_interior = interior[cell_faces] & cell_face_mask
    structured = _structure_ell(
        cell_faces, cell_face_mask, cell_face_sign, cell_neighbors,
        entry_interior,
    )
    cell_order = None
    slice_plan = None
    if structured is not None:
        offsets, cell_faces, cell_face_mask, cell_face_sign, cell_neighbors = (
            structured
        )
    else:
        offsets = None
        if C > 2:
            rcm = rcm_permutation(cell_neighbors, entry_interior)
            inv = np.empty(C, dtype=np.int64)
            inv[rcm] = np.arange(C)
            owner = inv[owner]
            neighbor = np.where(interior, inv[neighbor_safe], -1)
            neighbor_safe = np.where(interior, inv[neighbor_safe], owner)
            cell_centroid = cell_centroid[rcm]
            cell_volume = cell_volume[rcm]
            cell_faces, cell_face_mask, cell_face_sign, cell_neighbors = (
                _build_ell(owner, neighbor, neighbor_safe, interior, C)
            )
            entry_interior = interior[cell_faces] & cell_face_mask
            slice_plan = build_best_slice_plan(
                cell_neighbors, entry_interior, build_col_tile=True,
                device=device,
            )
            cell_order = rcm

    # torch.tensor copies: the caller's arrays may be read-only views.
    def f(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    def i32(x):
        return torch.tensor(np.asarray(x), dtype=torch.int32, device=device)

    def b8(x):
        return torch.tensor(np.asarray(x), dtype=torch.bool, device=device)

    return CompiledMesh(
        face_owner=i32(owner),
        face_neighbor=i32(neighbor_safe),
        face_interior=b8(interior),
        face_area=f(face_area),
        face_normal=f(face_normal),
        face_centroid=f(face_centroid),
        face_zone_slot=i32(face_zone_slot),
        face_lw=f(lw),
        face_r_on=f(r_on),
        face_dist_on=f(dist_on),
        face_dist_fo=f(dx0),
        cell_centroid=f(cell_centroid),
        cell_volume=f(cell_volume),
        cell_faces=i32(cell_faces),
        cell_face_mask=b8(cell_face_mask),
        cell_face_sign=f(cell_face_sign),
        cell_neighbors=i32(cell_neighbors),
        dim=dim,
        neighbor_offsets=offsets,
        cell_order=None if cell_order is None else i32(cell_order),
        slice_plan=slice_plan,
    )


def _build_ell(owner, neighbor, neighbor_safe, interior, C):
    """Pack the face list into [C,K] ELL tables (faces, mask, owner-sign,
    neighbour cell; self-index at boundary and padded slots)."""
    F = owner.shape[0]
    n_int = int(interior.sum())
    ell_face = np.concatenate([np.arange(F), np.arange(F)[interior]])
    ell_cell = np.concatenate([owner, neighbor[interior]])
    ell_sign = np.concatenate([np.ones(F), -np.ones(n_int)])
    ell_other = np.concatenate([neighbor_safe, owner[interior]])

    order = np.argsort(ell_cell, kind="stable")
    ell_face = ell_face[order]
    ell_cell = ell_cell[order]
    ell_sign = ell_sign[order]
    ell_other = ell_other[order]

    counts = np.zeros(C, dtype=np.int64)
    np.add.at(counts, owner, 1)
    np.add.at(counts, neighbor[interior], 1)
    K = int(counts.max())
    starts = np.zeros(C + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(ell_cell)) - starts[ell_cell]

    cell_faces = np.zeros((C, K), dtype=np.int64)
    cell_face_mask = np.zeros((C, K), dtype=bool)
    cell_face_sign = np.zeros((C, K), dtype=np.float64)
    cell_neighbors = np.tile(np.arange(C, dtype=np.int64)[:, None], (1, K))
    cell_faces[ell_cell, slot] = ell_face
    cell_face_mask[ell_cell, slot] = True
    cell_face_sign[ell_cell, slot] = ell_sign
    # Interior faces point at the other cell; boundary faces at the cell
    # itself (its gather is the own value, with a zero coefficient).
    is_int_entry = interior[ell_face]
    cell_neighbors[ell_cell[is_int_entry], slot[is_int_entry]] = ell_other[
        is_int_entry
    ]
    return cell_faces, cell_face_mask, cell_face_sign, cell_neighbors


def _structure_ell(cell_faces, mask, sign, nbrs, entry_interior):
    """Detect a structured adjacency and reorder the ELL columns so that
    every interior entry of column k has neighbour == cell + d_k.

    Returns (offsets, faces, mask, sign, neighbors), or None when the
    mesh is irregular. Periodic wrap faces add distinct deltas: the ELL
    widens to one column per delta (up to 2K), so the shift path
    survives them."""
    C, K = nbrs.shape
    if C == 0 or not entry_interior.any():
        return None
    delta = nbrs - np.arange(C)[:, None]
    cand = np.unique(delta[entry_interior])
    if len(cand) > 2 * K:
        return None
    K_eff = max(K, len(cand))
    rows, cols = np.nonzero(entry_interior)
    tgt = np.searchsorted(cand, delta[rows, cols])
    key = rows * K_eff + tgt
    if len(np.unique(key)) != len(key):
        return None  # two same-offset neighbours in one row: irregular

    new_f = np.zeros((C, K_eff), dtype=cell_faces.dtype)
    new_m = np.zeros((C, K_eff), dtype=mask.dtype)
    new_s = np.zeros((C, K_eff), dtype=sign.dtype)
    new_n = np.tile(np.arange(C, dtype=nbrs.dtype)[:, None], (1, K_eff))
    used = np.zeros((C, K_eff), dtype=bool)
    new_f[rows, tgt] = cell_faces[rows, cols]
    new_m[rows, tgt] = True
    new_s[rows, tgt] = sign[rows, cols]
    new_n[rows, tgt] = nbrs[rows, cols]
    used[rows, tgt] = True

    # Boundary entries fill each row's free columns in order (their
    # matrix coefficients are zero, so their column offset is moot).
    brows, bcols = np.nonzero(mask & ~entry_interior)
    if len(brows):
        free_rows, free_cols = np.nonzero(~used)
        ord_b = np.arange(len(brows)) - np.searchsorted(brows, brows)
        ord_f = np.arange(len(free_rows)) - np.searchsorted(free_rows, free_rows)
        slot_lookup = np.full((C, K_eff), -1, dtype=np.int64)
        slot_lookup[free_rows, ord_f] = free_cols
        j = slot_lookup[brows, ord_b]
        assert (j >= 0).all()
        new_f[brows, j] = cell_faces[brows, bcols]
        new_m[brows, j] = True
        new_s[brows, j] = sign[brows, bcols]
        new_n[brows, j] = nbrs[brows, bcols]

    offsets = tuple(int(d) for d in cand) + (0,) * (K_eff - len(cand))
    return offsets, new_f, new_m, new_s, new_n
