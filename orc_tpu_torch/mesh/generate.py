"""Structured hex-mesh generation (port of orc_tpu/mesh/generate.py).

- `structured_box_mesh` builds the CompiledMesh arrays of a uniform box
  in closed form with numpy, then moves them to the device in one
  transfer per field. A periodic axis of exactly 2 cells has no
  structured column assignment and takes the generic construction
  through `compile_from_arrays` instead.
- `write_tgrid` writes a structured box as a TGRID .msh text file (the
  grammar of the reference's reader, io.rs:78-284).

Zone naming follows the reference's couette fixtures: INLET (x-), OUTLET
(x+), BOTTOM_WALL (y-), TOP_WALL (y+), PERIODIC_-Z (z-), PERIODIC_+Z
(z+), FLUID interior.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from orc_tpu_torch.mesh.compile import CompiledMesh, compile_from_arrays
from orc_tpu_torch.mesh.zones import BoundaryTable, FaceCondition, FaceZone
from orc_tpu_torch.utils.device import resolve_device

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
    device: torch.device | str = "cuda",
):
    """Uniform structured hex mesh of nx*ny*nz cells on `device` (the
    CUDA device unless the caller names another).

    Cell (i,j,k) has id ``i + nx*(j + ny*k)`` (x fastest). Returns
    (CompiledMesh, BoundaryTable); boundary zones default to WALL
    (SYMMETRY on the planes of a 1-cell axis) — set the actual BCs on
    the table afterwards. `periodic` lists axes ("x", "y", "z") to close
    translationally with wrap faces."""
    device = resolve_device(device)
    per_axes = frozenset({"x": 0, "y": 1, "z": 2}[a] for a in periodic)
    for axis, n in zip((0, 1, 2), (nx, ny, nz)):
        if axis in per_axes and n < 2:
            raise ValueError(
                f"periodic axis {'xyz'[axis]} needs at least 2 cells "
                f"(got {n}): a 1-cell wrap face would connect a cell to "
                "itself"
            )
    # A 2-cell periodic axis gives two same-offset neighbours per row
    # (step and wrap both at +/-1): the generic construction.
    if any(axis in per_axes and n == 2 for axis, n in zip((0, 1, 2), (nx, ny, nz))):
        return _structured_box_mesh_generic(
            nx, ny, nz, lengths, origin, zone_names, dtype, per_axes, device
        )
    return _structured_compile(
        nx, ny, nz, lengths, origin, zone_names, dtype, per_axes, device
    )


def _structured_box_mesh_generic(
    nx, ny, nz, lengths, origin, zone_names, dtype, per_axes, device
):
    """Face lists -> compile_from_arrays (orc_tpu's generic box, the
    equivalence reference of `_structured_compile`)."""
    names = dict(DEFAULT_ZONE_NAMES)
    if zone_names:
        names.update(zone_names)
    dims = (nx, ny, nz)
    h = [lengths[a] / dims[a] for a in range(3)]
    o = list(origin)
    C = nx * ny * nz

    def cid(i, j, k):
        return i + nx * (j + ny * k)

    i, j, k = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    flat = cid(i, j, k).ravel()
    cc = np.zeros((C, 3))
    for a, q in enumerate((i, j, k)):
        cc[flat, a] = o[a] + (q.ravel() + 0.5) * h[a]
    vol = np.full(C, h[0] * h[1] * h[2])
    table = _box_zone_table(names, per_axes, dims)

    parts = {key: [] for key in ("own", "nbr", "area", "nrm", "cen", "zs", "shf")}
    for axis in range(3):
        is_per = axis in per_axes
        n_axis = dims[axis]
        lo_zone, hi_zone = 2 + 2 * axis, 3 + 2 * axis
        ax_counts = list(dims)
        ax_counts[axis] = n_axis + 1
        pi, pj, pk = np.meshgrid(
            *(np.arange(c) for c in ax_counts), indexing="ij"
        )
        plane = (pi, pj, pk)[axis].ravel()
        others = [q.ravel() for q in (pi, pj, pk)]
        if is_per:
            sel = plane > 0  # the low plane merges into the wrap
            plane = plane[sel]
            others = [q[sel] for q in others]
        lo_idx = list(others)
        lo_idx[axis] = plane - 1
        hi_idx = list(others)
        hi_idx[axis] = np.where(plane < n_axis, plane, 0)  # wrap at top
        has_lo = plane > 0
        has_hi = (plane < n_axis) | is_per
        lo_cell = cid(*[np.clip(x, 0, None) for x in lo_idx])
        hi_cell = cid(*hi_idx)
        own = np.where(has_lo, lo_cell, hi_cell)
        nrm = np.zeros((own.shape[0], 3))
        nrm[:, axis] = np.where(has_lo, 1.0, -1.0)
        cen = np.zeros((own.shape[0], 3))
        for a in range(3):
            if a == axis:
                cen[:, a] = o[a] + plane * h[a]
            else:
                cen[:, a] = o[a] + (others[a] + 0.5) * h[a]
        # Wrap faces: the neighbour's image sits one domain length up.
        shf = np.zeros((own.shape[0], 3))
        if is_per:
            shf[plane == n_axis, axis] = lengths[axis]
        parts["own"].append(own)
        parts["nbr"].append(np.where(has_lo & has_hi, hi_cell, -1))
        parts["area"].append(
            np.full(own.shape[0], np.prod([h[b] for b in range(3) if b != axis]))
        )
        parts["nrm"].append(nrm)
        parts["cen"].append(cen)
        parts["zs"].append(
            np.where(
                has_lo & has_hi,
                table.slot_of_zone[1],
                np.where(
                    has_lo,
                    table.slot_of_zone[hi_zone],
                    table.slot_of_zone[lo_zone],
                ),
            )
        )
        parts["shf"].append(shf)
    cat = {key: np.concatenate(v) for key, v in parts.items()}
    mesh = compile_from_arrays(
        dim=3,
        face_owner=cat["own"],
        face_neighbor=cat["nbr"],
        face_area=cat["area"],
        face_normal=cat["nrm"],
        face_centroid=cat["cen"],
        face_zone_slot=cat["zs"],
        cell_centroid=cc,
        cell_volume=vol,
        dtype=dtype,
        face_shift=cat["shf"] if per_axes else None,
        device=device,
    )
    return mesh, table


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


def write_tgrid(
    path: str,
    nx: int,
    ny: int,
    nz: int = 1,
    lengths: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    zone_names: Dict[str, str] | None = None,
    periodic: Tuple[str, ...] = (),
):
    """Write a structured box as a TGRID .msh text file.

    Periodic axes emit their high-plane faces as a PERIODIC zone (BC
    code 12), the low plane as PERIODIC_SHADOW (code 8), and an
    ``(18 ...)`` section pairing each periodic face with its shadow,
    which mesh/tgrid.py keeps."""
    names = dict(DEFAULT_ZONE_NAMES)
    if zone_names:
        names.update(zone_names)
    per_axes = frozenset({"x": 0, "y": 1, "z": 2}[a] for a in periodic)
    lx, ly, lz = lengths
    ox, oy, oz = origin
    hx, hy, hz = lx / nx, ly / ny, lz / nz
    npx, npy, npz = nx + 1, ny + 1, nz + 1
    n_nodes = npx * npy * npz
    n_cells = nx * ny * nz

    def nid(i, j, k):  # 1-based node id
        return 1 + i + npx * (j + npy * k)

    def cid(i, j, k):  # 1-based cell id
        return 1 + i + nx * (j + ny * k)

    zone_faces = {
        "interior": [],
        "x-": [],
        "x+": [],
        "y-": [],
        "y+": [],
        "z-": [],
        "z+": [],
    }

    # Quad faces with nodes ordered counterclockwise seen from +axis.
    for i in range(npx):
        for j in range(ny):
            for k in range(nz):
                nodes = (
                    nid(i, j, k),
                    nid(i, j + 1, k),
                    nid(i, j + 1, k + 1),
                    nid(i, j, k + 1),
                )
                c_lo = cid(i - 1, j, k) if i > 0 else 0
                c_hi = cid(i, j, k) if i < nx else 0
                key = "interior" if (c_lo and c_hi) else ("x-" if i == 0 else "x+")
                zone_faces[key].append((nodes, c_hi, c_lo))
    for j in range(npy):
        for i in range(nx):
            for k in range(nz):
                nodes = (
                    nid(i, j, k),
                    nid(i + 1, j, k),
                    nid(i + 1, j, k + 1),
                    nid(i, j, k + 1),
                )
                c_lo = cid(i, j - 1, k) if j > 0 else 0
                c_hi = cid(i, j, k) if j < ny else 0
                key = "interior" if (c_lo and c_hi) else ("y-" if j == 0 else "y+")
                zone_faces[key].append((nodes, c_hi, c_lo))
    for k in range(npz):
        for i in range(nx):
            for j in range(ny):
                nodes = (
                    nid(i, j, k),
                    nid(i + 1, j, k),
                    nid(i + 1, j + 1, k),
                    nid(i, j + 1, k),
                )
                c_lo = cid(i, j, k - 1) if k > 0 else 0
                c_hi = cid(i, j, k) if k < nz else 0
                key = "interior" if (c_lo and c_hi) else ("z-" if k == 0 else "z+")
                zone_faces[key].append((nodes, c_hi, c_lo))

    n_faces = sum(len(v) for v in zone_faces.values())
    # As _box_zone_table: walls (code 3), SYMMETRY (code 7) on the
    # planes of a 1-cell non-periodic axis, the periodic pair codes on
    # periodic axes, so a re-read box gets the analytic BoundaryTable.
    bc_code = {"interior": 2}
    for axis, (lo_key, hi_key) in enumerate(
        (("x-", "x+"), ("y-", "y+"), ("z-", "z+"))
    ):
        code = 7 if (nx, ny, nz)[axis] == 1 else 3
        bc_code[lo_key] = bc_code[hi_key] = code
    for axis in per_axes:
        lo_key, hi_key = (("x-", "x+"), ("y-", "y+"), ("z-", "z+"))[axis]
        bc_code[hi_key] = 12  # PERIODIC
        bc_code[lo_key] = 8  # PERIODIC_SHADOW

    with open(path, "w") as f:
        f.write('(0 "Generated by orc_tpu structured_box_mesh")\n')
        f.write('(0 "Units: Meters")\n')
        f.write("(2 3)\n")
        f.write(f"(10 (0 1 {n_nodes:x} 0 3))\n")
        f.write(f"(10 (1 1 {n_nodes:x} 1 3)\n(\n")
        # Emit nodes in id order (i fastest).
        for idx in range(n_nodes):
            i = idx % npx
            j = (idx // npx) % npy
            k = idx // (npx * npy)
            f.write(f"{ox + i * hx:.17g} {oy + j * hy:.17g} {oz + k * hz:.17g}\n")
        f.write("))\n")
        f.write(f"(12 (0 1 {n_cells:x} 0 0))\n")
        f.write(f"(12 (2 1 {n_cells:x} 1 4))\n")
        f.write(f"(13 (0 1 {n_faces:x} 0 0))\n")

        zone_id = 10
        first = 1
        zone_start: Dict[str, int] = {}
        zone_num: Dict[str, int] = {}
        for key in ("interior", "x-", "x+", "y-", "y+", "z-", "z+"):
            faces = zone_faces[key]
            if not faces:
                continue
            last = first + len(faces) - 1
            zone_start[key] = first
            zone_num[key] = zone_id
            f.write(f'(0 "Faces of zone {names[key]}")\n')
            f.write(
                f"(13 ({zone_id:x} {first:x} {last:x} {bc_code[key]:x} 4)(\n"
            )
            for nodes, c0, c1 in faces:
                f.write(
                    " ".join(f"{x:x}" for x in nodes)
                    + f" {c0:x} {c1:x}\n"
                )
            f.write(")\n)\n")
            first = last + 1
            zone_id += 1

        # One (18 section per periodic axis: high-plane (PERIODIC)
        # faces paired with low-plane (PERIODIC_SHADOW) faces in the
        # same transverse order.
        for axis in sorted(per_axes):
            lo_key, hi_key = (("x-", "x+"), ("y-", "y+"), ("z-", "z+"))[
                axis
            ]
            n_pairs = len(zone_faces[hi_key])
            assert n_pairs == len(zone_faces[lo_key])
            f.write(f'(0 "Periodic pairs for axis {"xyz"[axis]}")\n')
            f.write(
                f"(18 (1 {n_pairs:x} {zone_num[hi_key]:x} "
                f"{zone_num[lo_key]:x})(\n"
            )
            for idx in range(n_pairs):
                f.write(
                    f"{zone_start[hi_key] + idx:x} "
                    f"{zone_start[lo_key] + idx:x}\n"
                )
            f.write("))\n")
