"""Mesh-domain decomposition: slab and RCB partitioning with halo
construction (port of orc_tpu/parallel/partition.py).

Cells are split into partitions; each partition owns a block of cells
plus *halo* slots that replicate remote face neighbours. Every
partition's local arrays are padded to one size L, and the per-offset
exchange lists drive the halo refresh of parallel/sharded.py. The host
work is orc_tpu's numpy, so the integer tables equal orc_tpu's; the
local meshes become CompiledMesh objects, one per partition on that
partition's device.

Local index space of an RCB partition (size L = c_max + h_max + 1):
  [0, c_max)            owned cells (padded tail inactive)
  [c_max, c_max+h_max)  halo slots (remote cells, refreshed on demand)
  L-1                   trash slot (padded exchange targets land here)
and of a slab partition (size L = c_max + 2H + 1), see _partition_slab.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from orc_tpu_torch.mesh.compile import CompiledMesh
from orc_tpu_torch.utils.device import resolve_device


def rcb_partition(points: np.ndarray, n_parts: int) -> np.ndarray:
    """Recursive coordinate bisection -> part id per point [N]."""
    points = np.asarray(points)
    out = np.zeros(points.shape[0], dtype=np.int64)

    def rec(idx: np.ndarray, parts: int, base: int):
        if parts == 1:
            out[idx] = base
            return
        p_lo = parts // 2
        pts = points[idx]
        axis = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        order = np.argsort(pts[:, axis], kind="stable")
        n_lo = int(round(len(idx) * p_lo / parts))
        rec(idx[order[:n_lo]], p_lo, base)
        rec(idx[order[n_lo:]], parts - p_lo, base + p_lo)

    rec(np.arange(points.shape[0]), n_parts, 0)
    return out


@dataclasses.dataclass(frozen=True)
class Partition:
    """Per-partition local meshes and the exchange plan. The tables are
    host numpy arrays with a leading partition axis P, as orc_tpu's
    stacked arrays; the local meshes live on their partitions' devices."""

    local_meshes: tuple  # of CompiledMesh, one per partition
    owned_global: np.ndarray  # [P, L] i32 global id of each local slot
    owned_mask: np.ndarray  # [P, L] bool: true at owned, real slots
    # Exchange plan, one entry per active ring offset:
    send_idx: tuple  # of [P, s_d] i32 local indices to gather and send
    recv_idx: tuple  # of [P, s_d] i32 local halo slots (trash-padded)
    offsets: tuple
    n_parts: int
    c_max: int
    h_max: int

    @property
    def local_size(self) -> int:
        return self.c_max + self.h_max + 1

    @property
    def devices(self) -> tuple:
        return tuple(m.device for m in self.local_meshes)


def partition_mesh(
    mesh: CompiledMesh,
    n_parts: int,
    dtype=None,
    method: str = "auto",
    devices: Sequence | None = None,
) -> Partition:
    """Partition a compiled mesh into `n_parts` parts.

    method: "slab" (contiguous index ranges with ghost layers: keeps the
    structured neighbour offsets, so each partition's SpMV stays a shift
    SpMV), "rcb" (recursive coordinate bisection: general meshes), or
    "auto" (slab when the mesh is structured). `devices` places the
    local meshes (one device per partition, repeats allowed; default:
    the mesh's device for every partition)."""
    if devices is None:
        devices = [mesh.device] * n_parts
    devices = [resolve_device(d) for d in devices]
    if len(devices) != n_parts:
        raise ValueError(
            f"{n_parts} partitions need {n_parts} devices, got {len(devices)}"
        )
    if method == "auto":
        method = "slab" if mesh.neighbor_offsets is not None else "rcb"
    if method == "slab":
        if mesh.neighbor_offsets is None:
            raise ValueError("slab partitioning requires a structured mesh")
        return _partition_slab(mesh, n_parts, dtype, devices)
    return _partition_rcb(mesh, n_parts, dtype, devices)


def _np(t):
    return t.detach().cpu().numpy()


def _global_arrays(mesh: CompiledMesh) -> dict:
    """The global mesh's fields the partitioners read, as numpy."""
    return dict(
        owner=_np(mesh.face_owner).astype(np.int64),
        neighbor=_np(mesh.face_neighbor).astype(np.int64),
        interior=_np(mesh.face_interior),
        nbrs=_np(mesh.cell_neighbors).astype(np.int64),
        mask=_np(mesh.cell_face_mask),
        faces=_np(mesh.cell_faces).astype(np.int64),
        sign=_np(mesh.cell_face_sign),
        cc=_np(mesh.cell_centroid),
        vol=_np(mesh.cell_volume),
        area=_np(mesh.face_area),
        normal=_np(mesh.face_normal),
        fcent=_np(mesh.face_centroid),
        zslot=_np(mesh.face_zone_slot).astype(np.int64),
        lw=_np(mesh.face_lw),
        ron=_np(mesh.face_r_on),
        dist_on=_np(mesh.face_dist_on),
        dist_fo=_np(mesh.face_dist_fo),
    )


def _local_arrays(n_parts: int, f_max: int, L: int, K: int) -> dict:
    """orc_tpu's padded local arrays: padded faces point along +x with
    unit distances, padded cells gather themselves."""

    def zeros(shape, fill=0.0):
        return np.full(shape, fill, dtype=np.float64)

    a = dict(
        owner=np.zeros((n_parts, f_max), dtype=np.int64),
        neighbor=np.zeros((n_parts, f_max), dtype=np.int64),
        interior=np.zeros((n_parts, f_max), dtype=bool),
        area=zeros((n_parts, f_max)),
        normal=zeros((n_parts, f_max, 3)),
        fcent=zeros((n_parts, f_max, 3)),
        zslot=np.zeros((n_parts, f_max), dtype=np.int64),
        lw=zeros((n_parts, f_max)),
        ron=zeros((n_parts, f_max, 3)),
        dist_on=zeros((n_parts, f_max), 1.0),
        dist_fo=zeros((n_parts, f_max), 1.0),
        ccent=zeros((n_parts, L, 3)),
        vol=zeros((n_parts, L), 1.0),
        cf=np.zeros((n_parts, L, K), dtype=np.int64),
        cmask=np.zeros((n_parts, L, K), dtype=bool),
        csign=zeros((n_parts, L, K)),
        cnbr=np.tile(np.arange(L, dtype=np.int64)[None, :, None], (n_parts, 1, K)),
    )
    a["normal"][:, :, 0] = 1.0
    a["ron"][:, :, 0] = 1.0
    return a


def _copy_faces(a: dict, g: dict, p: int, pf: np.ndarray) -> None:
    """The global face data of the faces `pf` into part p's slots."""
    n_f = len(pf)
    a["interior"][p, :n_f] = g["interior"][pf]
    for name in ("area", "normal", "fcent", "zslot", "lw", "ron", "dist_on", "dist_fo"):
        a[name][p, :n_f] = g[name][pf]


def _local_meshes(a, mesh, dtype, devices, neighbor_offsets, ck_constants):
    """One CompiledMesh per partition from the stacked local arrays."""

    def f(x, dev):
        return torch.tensor(x, dtype=dtype, device=dev)

    def i32(x, dev):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    def b(x, dev):
        return torch.tensor(x, dtype=torch.bool, device=dev)

    out = []
    for p, dev in enumerate(devices):
        out.append(
            CompiledMesh(
                face_owner=i32(a["owner"][p], dev),
                face_neighbor=i32(a["neighbor"][p], dev),
                face_interior=b(a["interior"][p], dev),
                face_area=f(a["area"][p], dev),
                face_normal=f(a["normal"][p], dev),
                face_centroid=f(a["fcent"][p], dev),
                face_zone_slot=i32(a["zslot"][p], dev),
                face_lw=f(a["lw"][p], dev),
                face_r_on=f(a["ron"][p], dev),
                face_dist_on=f(a["dist_on"][p], dev),
                face_dist_fo=f(a["dist_fo"][p], dev),
                cell_centroid=f(a["ccent"][p], dev),
                cell_volume=f(a["vol"][p], dev),
                cell_faces=i32(a["cf"][p], dev),
                cell_face_mask=b(a["cmask"][p], dev),
                cell_face_sign=f(a["csign"][p], dev),
                cell_neighbors=i32(a["cnbr"][p], dev),
                dim=mesh.dim,
                neighbor_offsets=neighbor_offsets,
                ck_constants=ck_constants,
            )
        )
    return tuple(out)


def _partition_slab(mesh: CompiledMesh, n_parts: int, dtype, devices) -> Partition:
    """Ghost-layer slab decomposition of a structured mesh.

    Each part owns the contiguous global range [p*c_max, ...) and keeps
    H = max|offset| ghost cells on each side in global index order, so
    local neighbour deltas equal the global `neighbor_offsets` and every
    partition's SpMV stays on the shift path.

    Local layout (size L = c_max + 2H + 1):
      [0, H)              lower ghost layer
      [H, H + size_p)     owned cells
      [H + c_max, +H)     upper ghost layer
      L-1                 trash slot
    """
    dtype = dtype or mesh.dtype
    C, F, K = mesh.n_cells, mesh.n_faces, mesh.max_faces_per_cell
    offs = mesh.neighbor_offsets
    # Ghost depth = the largest neighbour offset (periodic wraps along
    # the slab axis make H approach C: correct, but RCB suits them).
    H = max(1, max(abs(int(d)) for d in offs))
    c_max = -(-C // n_parts)
    L = c_max + 2 * H + 1
    trash = L - 1

    starts = [p * c_max for p in range(n_parts)]
    sizes = [max(0, min(c_max, C - s)) for s in starts]
    part_of = np.minimum(np.arange(C) // c_max, n_parts - 1)
    g = _global_arrays(mesh)
    owner, neighbor, interior = g["owner"], g["neighbor"], g["interior"]

    local_of = np.full((n_parts, C), trash, dtype=np.int64)
    halos: List[np.ndarray] = []
    for p in range(n_parts):
        w0 = starts[p] - H
        lo = np.arange(max(0, w0), starts[p])
        hi = np.arange(
            min(C, starts[p] + sizes[p]), min(C, starts[p] + c_max + H)
        )
        # In-window cells (ghosts + owned) all map by g - w0.
        win = np.arange(max(0, w0), min(C, starts[p] + c_max + H))
        local_of[p, win] = win - w0
        halos.append(np.concatenate([lo, hi]))

    part_faces: List[np.ndarray] = []
    for p in range(n_parts):
        sel = (part_of[owner] == p) | (interior & (part_of[neighbor] == p))
        part_faces.append(np.nonzero(sel)[0])
    f_max = max(len(f) for f in part_faces)
    a = _local_arrays(n_parts, f_max, L, K)
    owned_global = np.zeros((n_parts, L), dtype=np.int64)
    owned_mask = np.zeros((n_parts, L), dtype=bool)

    for p in range(n_parts):
        w0 = starts[p] - H
        o = np.arange(starts[p], starts[p] + sizes[p])
        sl = o - w0  # local slots of owned cells
        owned_global[p, sl] = o
        owned_mask[p, sl] = True
        # Halo (ghost-layer) slots record their global ids too: owned_mask
        # tells them apart (the sharded AMG reads the global ids of
        # neighbour slots, which may be halos).
        hg = halos[p]
        owned_global[p, local_of[p, hg]] = hg
        pf = part_faces[p]
        n_f = len(pf)
        face_local = np.full(F, -1, dtype=np.int64)
        face_local[pf] = np.arange(n_f)

        a["owner"][p, :n_f] = owner[pf] - w0
        a["neighbor"][p, :n_f] = neighbor[pf] - w0
        _copy_faces(a, g, p, pf)

        win = np.arange(max(0, w0), min(C, starts[p] + c_max + H))
        a["ccent"][p, win - w0] = g["cc"][win]
        a["vol"][p, win - w0] = g["vol"][win]

        a["cf"][p, sl] = np.where(
            g["mask"][o], np.maximum(face_local[g["faces"][o]], 0), 0
        )
        a["cmask"][p, sl] = g["mask"][o]
        a["csign"][p, sl] = g["sign"][o]
        a["cnbr"][p, sl] = np.where(g["mask"][o], g["nbrs"][o] - w0, sl[:, None])

    send_idx, recv_idx, ring_offsets = _exchange_plan(
        halos, local_of, part_of, n_parts, trash
    )
    return Partition(
        # Uniform-box column constants hold for every owned local cell
        # (slab windows keep the global geometry and column order), so
        # the (c,k) step keeps the compact geometry and the fused
        # assembly kernels stay eligible.
        local_meshes=_local_meshes(a, mesh, dtype, devices, offs, mesh.ck_constants),
        owned_global=owned_global.astype(np.int32),
        owned_mask=owned_mask,
        send_idx=tuple(s.astype(np.int32) for s in send_idx),
        recv_idx=tuple(r.astype(np.int32) for r in recv_idx),
        offsets=tuple(ring_offsets),
        n_parts=n_parts,
        c_max=c_max + 2 * H,  # owned + ghost extent (L = this + 1)
        h_max=0,
    )


def _exchange_plan(halos, local_of, part_of, n_parts, trash):
    """Per-ring-offset send/recv index lists (shared by both
    partitioners)."""
    send_idx: List[np.ndarray] = []
    recv_idx: List[np.ndarray] = []
    ring_offsets: List[int] = []
    for d in range(1, n_parts):
        sends = []
        any_traffic = False
        for src in range(n_parts):
            dst = (src + d) % n_parts
            need = halos[dst][part_of[halos[dst]] == src]
            if len(need):
                any_traffic = True
            sends.append(need)
        if not any_traffic:
            continue
        s_max = max(len(s) for s in sends)
        s_arr = np.zeros((n_parts, s_max), dtype=np.int64)
        r_arr = np.full((n_parts, s_max), trash, dtype=np.int64)
        for src in range(n_parts):
            dst = (src + d) % n_parts
            need = sends[src]
            s_arr[src, : len(need)] = local_of[src, need]
            r_arr[dst, : len(need)] = local_of[dst, need]
        send_idx.append(s_arr)
        recv_idx.append(r_arr)
        ring_offsets.append(d)
    return send_idx, recv_idx, ring_offsets


def _partition_rcb(mesh: CompiledMesh, n_parts: int, dtype, devices) -> Partition:
    """RCB partitions with sorted halo blocks."""
    dtype = dtype or mesh.dtype
    C, F, K = mesh.n_cells, mesh.n_faces, mesh.max_faces_per_cell
    g = _global_arrays(mesh)
    owner, neighbor, interior = g["owner"], g["neighbor"], g["interior"]
    nbrs_g, mask_g = g["nbrs"], g["mask"]
    part_of = rcb_partition(g["cc"], n_parts)

    owned: List[np.ndarray] = [np.nonzero(part_of == p)[0] for p in range(n_parts)]
    c_max = max(len(o) for o in owned)

    # Halo cells: remote neighbours of owned cells (the [C,K] table).
    halos: List[np.ndarray] = []
    for p in range(n_parts):
        o = owned[p]
        nb = nbrs_g[o][mask_g[o]]
        halos.append(np.unique(nb[part_of[nb] != p]))
    h_max = max(max((len(h) for h in halos), default=0), 1)
    L = c_max + h_max + 1
    trash = L - 1

    # Local index of a global cell within part p.
    local_of = np.full((n_parts, C), trash, dtype=np.int64)
    for p in range(n_parts):
        local_of[p, owned[p]] = np.arange(len(owned[p]))
        local_of[p, halos[p]] = c_max + np.arange(len(halos[p]))

    # Faces present in part p: any face adjacent to an owned cell (cut
    # faces are duplicated on both sides).
    part_faces: List[np.ndarray] = []
    for p in range(n_parts):
        sel = (part_of[owner] == p) | (interior & (part_of[neighbor] == p))
        part_faces.append(np.nonzero(sel)[0])
    f_max = max(len(f) for f in part_faces)
    a = _local_arrays(n_parts, f_max, L, K)
    owned_global = np.zeros((n_parts, L), dtype=np.int64)
    owned_mask = np.zeros((n_parts, L), dtype=bool)

    for p in range(n_parts):
        o = owned[p]
        n_o = len(o)
        owned_global[p, :n_o] = o
        owned_mask[p, :n_o] = True
        owned_global[p, c_max : c_max + len(halos[p])] = halos[p]
        pf = part_faces[p]
        n_f = len(pf)
        face_local = np.full(F, -1, dtype=np.int64)
        face_local[pf] = np.arange(n_f)

        a["owner"][p, :n_f] = local_of[p, owner[pf]]
        a["neighbor"][p, :n_f] = local_of[p, neighbor[pf]]
        _copy_faces(a, g, p, pf)

        # Cell geometry of owned and halo slots.
        a["ccent"][p, :n_o] = g["cc"][o]
        a["vol"][p, :n_o] = g["vol"][o]
        hs = halos[p]
        a["ccent"][p, c_max : c_max + len(hs)] = g["cc"][hs]
        a["vol"][p, c_max : c_max + len(hs)] = g["vol"][hs]

        # [L,K] adjacency rows of owned cells (every face of an owned
        # cell is in part_faces, so face_local is never -1 at a valid
        # slot).
        lf = face_local[g["faces"][o]]
        a["cf"][p, :n_o] = np.where(mask_g[o], np.maximum(lf, 0), 0)
        a["cmask"][p, :n_o] = mask_g[o]
        a["csign"][p, :n_o] = g["sign"][o]
        rows = np.arange(n_o)[:, None]
        cn = np.where(mask_g[o], local_of[p, nbrs_g[o]], rows)
        # Boundary slots keep the self-gather convention.
        a["cnbr"][p, :n_o] = np.where(cn == trash, rows, cn)

    send_idx, recv_idx, offsets = _exchange_plan(
        halos, local_of, part_of, n_parts, trash
    )
    return Partition(
        local_meshes=_local_meshes(a, mesh, dtype, devices, None, None),
        owned_global=owned_global.astype(np.int32),
        owned_mask=owned_mask,
        send_idx=tuple(s.astype(np.int32) for s in send_idx),
        recv_idx=tuple(r.astype(np.int32) for r in recv_idx),
        offsets=tuple(offsets),
        n_parts=n_parts,
        c_max=c_max,
        h_max=h_max,
    )
