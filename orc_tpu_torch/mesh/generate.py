"""Structured hex-mesh generation (port of the analytic path of
orc_tpu/mesh/generate.py).

`structured_box_mesh` builds the CompiledMesh arrays in closed form with
numpy, then moves them to the requested device in one transfer per
field. Zone naming follows the reference's couette fixtures: INLET
(x-), OUTLET (x+), BOTTOM_WALL (y-), TOP_WALL (y+), PERIODIC_-Z (z-),
PERIODIC_+Z (z+), FLUID interior.

Not ported yet: the generic construction through the TGRID compiler
(needed only for a periodic axis of exactly 2 cells) and `write_tgrid`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from orc_tpu_torch.mesh.compile import CompiledMesh
from orc_tpu_torch.mesh.zones import BoundaryTable, FaceCondition, FaceZone

DEFAULT_ZONE_NAMES = {
    "interior": "FLUID",
    "x-": "INLET",
    "x+": "OUTLET",
    "y-": "BOTTOM_WALL",
    "y+": "TOP_WALL",
    "z-": "PERIODIC_-Z",
    "z+": "PERIODIC_+Z",
}


def structured_box_mesh(
    nx: int,
    ny: int,
    nz: int = 1,
    lengths: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    zone_names: Dict[str, str] | None = None,
    dtype: torch.dtype = torch.float64,
    periodic: Tuple[str, ...] = (),
    device: torch.device | str = "cpu",
):
    """Uniform structured hex mesh of nx*ny*nz cells on `device`.

    Cell (i,j,k) has id ``i + nx*(j + ny*k)`` (x fastest). Returns
    (CompiledMesh, BoundaryTable); boundary zones default to WALL
    (SYMMETRY on the planes of a 1-cell axis) — set the actual BCs on
    the table afterwards. `periodic` lists axes ("x", "y", "z") to close
    translationally with wrap faces (each such axis needs >= 3 cells
    here)."""
    per_axes = frozenset({"x": 0, "y": 1, "z": 2}[a] for a in periodic)
    for axis, n in zip((0, 1, 2), (nx, ny, nz)):
        if axis in per_axes and n < 2:
            raise ValueError(
                f"periodic axis {'xyz'[axis]} needs at least 2 cells "
                f"(got {n}): a 1-cell wrap face would connect a cell to "
                "itself"
            )
        if axis in per_axes and n == 2:
            raise NotImplementedError(
                f"periodic axis {'xyz'[axis]} with {n} cells needs the "
                "generic TGRID-compile construction, which is not ported "
                "yet (ROADMAP Queue 1, item 2)"
            )
    return _structured_compile(
        nx, ny, nz, lengths, origin, zone_names, dtype, per_axes, device
    )


def _box_zone_table(names, per_axes, dims):
    """Zone table: 1 interior, 2..7 the axis boundary pairs. Periodic
    axes: high plane PERIODIC, low plane PERIODIC_SHADOW. The planes of
    a non-periodic 1-cell axis (a 2D reduction) default to SYMMETRY."""
    zones = {1: FaceZone(1, FaceCondition.INTERIOR, names["interior"])}
    for axis, (lo_key, hi_key) in enumerate(
        (("x-", "x+"), ("y-", "y+"), ("z-", "z+"))
    ):
        if axis in per_axes:
            lo_t, hi_t = (
                FaceCondition.PERIODIC_SHADOW, FaceCondition.PERIODIC
            )
        elif dims[axis] == 1:
            lo_t = hi_t = FaceCondition.SYMMETRY
        else:
            lo_t = hi_t = FaceCondition.WALL
        zones[2 + 2 * axis] = FaceZone(2 + 2 * axis, lo_t, names[lo_key])
        zones[3 + 2 * axis] = FaceZone(3 + 2 * axis, hi_t, names[hi_key])
    return BoundaryTable(zones)


def _structured_compile(
    nx, ny, nz, lengths, origin, zone_names, dtype, per_axes, device
):
    """Closed-form CompiledMesh of a uniform box: face ids are (axis,
    plane, transverse) triples, the ELL has one column per flat offset
    (ascending), boundary faces occupy their own direction's column (or
    the first free pad column on 1-cell axes), and the interpolation
    geometry is constant per face class."""
    names = dict(DEFAULT_ZONE_NAMES)
    if zone_names:
        names.update(zone_names)
    dims = (nx, ny, nz)
    h = (lengths[0] / nx, lengths[1] / ny, lengths[2] / nz)
    o = origin
    C = nx * ny * nz
    table = _box_zone_table(names, per_axes, dims)
    slot = table.slot_of_zone
    int_slot = slot[1]

    idx = np.arange(C, dtype=np.int64)
    ia = (idx % nx, (idx // nx) % ny, idx // (nx * ny))  # i, j, k
    strides = (1, nx, nx * ny)

    # Transverse flat index (cell id with the axis digit removed) and
    # its inverse (cell id from transverse index + axis coordinate).
    def other_flat(axis):
        if axis == 0:
            return idx // nx
        if axis == 1:
            return ia[0] + nx * ia[2]
        return idx % (nx * ny)

    def cell_from(axis, of, q):
        if axis == 0:
            return q + nx * of
        if axis == 1:
            return of % nx + nx * q + nx * ny * (of // nx)
        return of + nx * ny * q

    # --- face arrays, direction-major -------------------------------
    P = {a: C // dims[a] for a in range(3)}
    n_planes = {
        a: dims[a] + (0 if a in per_axes else 1) for a in range(3)
    }
    base = {}
    acc = 0
    for a in range(3):
        base[a] = acc
        acc += n_planes[a] * P[a]
    F = acc

    f_owner = np.empty(F, dtype=np.int64)
    f_neighbor = np.empty(F, dtype=np.int64)
    f_interior = np.empty(F, dtype=bool)
    f_area = np.empty(F)
    f_normal = np.zeros((F, 3))
    f_centroid = np.empty((F, 3))
    f_zslot = np.empty(F, dtype=np.int64)
    f_lw = np.empty(F)
    f_r_on = np.zeros((F, 3))
    f_dist_on = np.empty(F)
    f_dist_fo = np.empty(F)

    for a in range(3):
        per = a in per_axes
        n_a, pa = dims[a], P[a]
        sl = slice(base[a], base[a] + n_planes[a] * pa)
        fi = np.arange(n_planes[a] * pa, dtype=np.int64)
        p_idx = fi // pa
        of = fi % pa
        plane = p_idx + 1 if per else p_idx
        if per:
            own_q = p_idx  # cell below plane p_idx+1
            nbr_q = np.where(p_idx < n_a - 1, p_idx + 1, 0)
            f_owner[sl] = cell_from(a, of, own_q)
            f_neighbor[sl] = cell_from(a, of, nbr_q)
            f_interior[sl] = True
            f_normal[sl, a] = 1.0
            f_zslot[sl] = int_slot
            f_lw[sl] = 0.5
            f_r_on[sl, a] = h[a]
            f_dist_on[sl] = h[a]
        else:
            has_lo = p_idx > 0
            has_hi = p_idx < n_a
            own_q = np.where(has_lo, p_idx - 1, 0)
            f_owner[sl] = cell_from(a, of, own_q)
            inter = has_lo & has_hi
            nbr = np.where(
                inter, cell_from(a, of, np.minimum(p_idx, n_a - 1)), -1
            )
            f_neighbor[sl] = nbr
            f_interior[sl] = inter
            f_normal[sl, a] = np.where(has_lo, 1.0, -1.0)
            f_zslot[sl] = np.where(
                inter,
                int_slot,
                np.where(has_lo, slot[3 + 2 * a], slot[2 + 2 * a]),
            )
            f_lw[sl] = np.where(inter, 0.5, 0.0)
            # owner -> neighbor (interior: +h along a); boundary:
            # owner -> face centroid (half cell toward the face).
            f_r_on[sl, a] = np.where(
                inter, h[a], np.where(has_lo, 0.5 * h[a], -0.5 * h[a])
            )
            f_dist_on[sl] = np.where(inter, h[a], 0.5 * h[a])
        f_area[sl] = np.prod([h[b] for b in range(3) if b != a])
        f_dist_fo[sl] = 0.5 * h[a]
        # Centroid: axis coordinate on the plane, transverse centered.
        f_centroid[sl, a] = o[a] + plane * h[a]
        for b in range(3):
            if b == a:
                continue
            if a == 0:  # of = j + ny*k
                coord = of % ny if b == 1 else of // ny
            else:  # a == 1: of = i + nx*k; a == 2: of = i + nx*j
                coord = of % nx if b == 0 else of // nx
            f_centroid[sl, b] = o[b] + (coord + 0.5) * h[b]

    # --- ELL tables: one column per flat offset ---------------------
    col_specs = []  # (delta, spec)
    leftovers = []
    for a in range(3):
        per = a in per_axes
        n_a, s_a, pa = dims[a], strides[a], P[a]
        i_a = ia[a]
        of_c = other_flat(a)
        if n_a == 1:
            # Both faces are leftover boundary fills (plane 0 and 1).
            leftovers.append((base[a] + of_c, base[a] + pa + of_c))
            continue
        if per:
            fup = base[a] + i_a * pa + of_c  # plane i_a+1
            fdn = base[a] + ((i_a - 1) % n_a) * pa + of_c
            w = s_a * (n_a - 1)
            fw = base[a] + (n_a - 1) * pa + of_c
            col_specs += [
                (s_a, dict(face=fup, mask=i_a < n_a - 1, sign=1.0,
                           nbr=idx + s_a, axis=a, dir=1, wrap_or_per=True)),
                (-s_a, dict(face=fdn, mask=i_a > 0, sign=-1.0,
                            nbr=idx - s_a, axis=a, dir=-1, wrap_or_per=True)),
                (-w, dict(face=fw, mask=i_a == n_a - 1, sign=1.0,
                          nbr=idx - w, axis=a, dir=1, wrap_or_per=True)),
                (w, dict(face=fw, mask=i_a == 0, sign=-1.0,
                         nbr=idx + w, axis=a, dir=-1, wrap_or_per=True)),
            ]
        else:
            fup = base[a] + (i_a + 1) * pa + of_c
            fdn = base[a] + i_a * pa + of_c
            hi = i_a == n_a - 1
            lo = i_a == 0
            col_specs += [
                (s_a, dict(face=fup, mask=None, sign=1.0,
                           nbr=np.where(hi, idx, idx + s_a),
                           interior=~hi, axis=a, dir=1, wrap_or_per=False)),
                (-s_a, dict(face=fdn, mask=None,
                            sign=np.where(lo, 1.0, -1.0),
                            nbr=np.where(lo, idx, idx - s_a),
                            interior=~lo, axis=a, dir=-1, wrap_or_per=False)),
            ]

    col_specs.sort(key=lambda t: t[0])
    n_struct = len(col_specs)
    K = max(n_struct, 6)
    cell_faces = np.zeros((C, K), dtype=np.int64)
    cell_mask = np.zeros((C, K), dtype=bool)
    cell_sign = np.zeros((C, K))
    cell_nbrs = np.tile(idx[:, None], (1, K))
    for kcol, (_delta, spec) in enumerate(col_specs):
        m = spec["mask"] if spec["mask"] is not None else np.ones(C, bool)
        cell_faces[:, kcol] = np.where(m, spec["face"], 0)
        cell_mask[:, kcol] = m
        cell_sign[:, kcol] = np.where(m, spec["sign"], 0.0)
        cell_nbrs[:, kcol] = np.where(
            m & spec.get("interior", m), spec["nbr"], idx
        )

    def col_const(a, d, bnd_slot):
        nvec = [0.0, 0.0, 0.0]
        nvec[a] = float(d)
        return (
            float(np.prod([h[b] for b in range(3) if b != a])),
            tuple(nvec),
            0.5 * h[a],
            float(h[a]),
            int(bnd_slot),
        )

    consts = [None] * K
    for kcol, (_delta, spec) in enumerate(col_specs):
        a, d = spec["axis"], spec["dir"]
        bnd_slot = (
            int_slot
            if spec["wrap_or_per"]
            else (slot[3 + 2 * a] if d > 0 else slot[2 + 2 * a])
        )
        consts[kcol] = col_const(a, d, bnd_slot)
    used = cell_mask.copy()
    for a_left, (lo_face, hi_face) in zip(
        [a for a in range(3) if dims[a] == 1 and a not in per_axes],
        leftovers,
    ):
        for bface, d in ((lo_face, -1.0), (hi_face, 1.0)):
            kfree = np.argmax(~used, axis=1)
            cell_faces[idx, kfree] = bface
            cell_mask[idx, kfree] = True
            cell_sign[idx, kfree] = 1.0
            used[idx, kfree] = True
            if not per_axes:
                consts[int(kfree[0])] = col_const(
                    a_left,
                    d,
                    slot[3 + 2 * a_left] if d > 0 else slot[2 + 2 * a_left],
                )
    # Leftover boundary faces land in per-ROW free columns when periodic
    # wrap columns exist, which breaks per-column constancy.
    ck_constants = None
    if not (leftovers and per_axes) and all(c is not None for c in consts):
        ck_constants = (int(int_slot), tuple(consts))
    offsets = tuple(int(d) for d, _ in col_specs) + (0,) * (K - n_struct)

    # --- cell geometry ----------------------------------------------
    cc = np.empty((C, 3))
    for a in range(3):
        cc[:, a] = o[a] + (ia[a] + 0.5) * h[a]
    vol = np.full(C, h[0] * h[1] * h[2])

    def f(x):
        return torch.as_tensor(x, dtype=dtype).to(device)

    def i32(x):
        return torch.as_tensor(x, dtype=torch.int32).to(device)

    def b8(x):
        return torch.as_tensor(x, dtype=torch.bool).to(device)

    mesh = CompiledMesh(
        face_owner=i32(f_owner),
        face_neighbor=i32(np.where(f_interior, f_neighbor, f_owner)),
        face_interior=b8(f_interior),
        face_area=f(f_area),
        face_normal=f(f_normal),
        face_centroid=f(f_centroid),
        face_zone_slot=i32(f_zslot),
        face_lw=f(f_lw),
        face_r_on=f(f_r_on),
        face_dist_on=f(f_dist_on),
        face_dist_fo=f(f_dist_fo),
        cell_centroid=f(cc),
        cell_volume=f(vol),
        cell_faces=i32(cell_faces),
        cell_face_mask=b8(cell_mask),
        cell_face_sign=f(cell_sign),
        cell_neighbors=i32(cell_nbrs),
        dim=3,
        neighbor_offsets=offsets,
        ck_constants=ck_constants,
    )
    return mesh, table
