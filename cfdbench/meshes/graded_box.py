"""A box of nx x ny x nz hexahedra (quadrilaterals in 2-D, nz = 1) with
optional geometric grading along y, its cells written in a fixed
scrambled order, so that the program reads it as an irregular mesh
(reverse Cuthill-McKee and a slice plan), as it reads a user's file.

Zones: FLUID (the interior faces), then the boundary planes named as the
program's generated box names them (INLET, OUTLET at x = 0, lx;
BOTTOM_WALL, TOP_WALL at y = 0, ly; PERIODIC_-Z, PERIODIC_+Z at z = 0,
lz in 3-D), so the same geometry is a channel or a closed cavity as the
configuration's boundaries say. Each boundary zone is written with the
condition code that `codes` gives it by name (default wall).

Plain numpy; the cell order depends on the parameters alone, never on a
run's seed.
"""

from __future__ import annotations

import numpy as np

from cfdbench.meshes import Grid

#: Boundary zones by (axis, side), in file order.
PLANE_ZONES = {
    (0, 0): "INLET",
    (0, 1): "OUTLET",
    (1, 0): "BOTTOM_WALL",
    (1, 1): "TOP_WALL",
    (2, 0): "PERIODIC_-Z",
    (2, 1): "PERIODIC_+Z",
}
CODES = {"interior": 2, "wall": 3, "pressure_inlet": 4, "pressure_outlet": 5, "symmetry": 7, "velocity_inlet": 10}
#: Seed of the fixed cell order.
ORDER_SEED = 20231


def node_lines(n: int, length: float, grading: float = 1.0) -> np.ndarray:
    """n + 1 node positions on [0, length]; each cell `grading` times as
    wide as the one below it."""
    if grading == 1.0:
        return length * np.arange(n + 1, dtype=np.float64) / n
    w = grading ** np.arange(n, dtype=np.float64)
    x = np.concatenate([[0.0], np.cumsum(w)])
    return length * x / x[-1]


def generate(nx, ny, nz=1, lengths=(1.0, 1.0, 1.0), grading_y=1.0, codes=None, dim=None) -> Grid:
    """The box's Grid. `dim` 2 (edges as faces, nz = 1) or 3 (hexahedra;
    nz = 1 gives one layer between the two z planes); by default 2 where
    nz = 1."""
    dims = (int(nx), int(ny), int(nz))
    dim = int(dim or (2 if dims[2] == 1 else 3))
    if dim == 2 and dims[2] != 1:
        raise ValueError("a 2-D box has nz = 1")
    lines = [
        node_lines(dims[0], float(lengths[0])),
        node_lines(dims[1], float(lengths[1]), float(grading_y)),
        node_lines(dims[2], float(lengths[2])),
    ]
    npt = [d + 1 for d in dims]
    C = dims[0] * dims[1] * dims[2]
    # Natural cell c = i + nx (j + ny k) is written at position pos[c].
    pos = np.random.default_rng(ORDER_SEED).permutation(C)
    ijk = _positions(dims)
    cell_ijk = np.empty_like(ijk)
    cell_ijk[pos] = ijk

    if dim == 2:
        X, Y = np.meshgrid(lines[0], lines[1], indexing="xy")
        points = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)], axis=1)
    else:
        Z, Y, X = np.meshgrid(lines[2], lines[1], lines[0], indexing="ij")
        points = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def node(q):
        return q[:, 0] + npt[0] * (q[:, 1] + npt[1] * q[:, 2])

    def cell(q):
        return pos[q[:, 0] + dims[0] * (q[:, 1] + dims[1] * q[:, 2])]

    # Per axis a: the faces on planes 0 .. n_a, their corners in order
    # around the face, their lower and upper cells.
    e = np.eye(3, dtype=np.int64)
    blocks = {}
    for a in range(dim):
        ext = list(dims)
        ext[a] += 1
        g = _positions(ext)
        t = [b for b in range(dim) if b != a]
        corners = [0 * e[0], e[t[0]]] if dim == 2 else [0 * e[0], e[t[0]], e[t[0]] + e[t[1]], e[t[1]]]
        nodes = np.stack([node(g + c) for c in corners], axis=1)
        plane = g[:, a]
        lo_ok, hi_ok = plane > 0, plane < dims[a]
        lo = np.where(lo_ok, cell(np.where(lo_ok[:, None], g - e[a], 0)), -1)
        hi = np.where(hi_ok, cell(np.where(hi_ok[:, None], g, 0)), -1)
        inner = lo_ok & hi_ok
        blocks[a] = (nodes[inner], np.stack([lo[inner], hi[inner]], axis=1))
        for side, on, own in ((0, ~lo_ok, hi), (1, ~hi_ok, lo)):
            blocks[(a, side)] = (nodes[on], np.stack([own[on], np.full(int(on.sum()), -1)], axis=1))

    codes = codes or {}
    zones = [("FLUID", CODES["interior"])]
    order = [[blocks[a] for a in range(dim)]]
    for key, name in PLANE_ZONES.items():
        if key in blocks:
            zones.append((name, CODES[codes.get(name, "wall")]))
            order.append([blocks[key]])
    face_nodes = np.concatenate([n for part in order for n, _ in part])
    face_cells = np.concatenate([c for part in order for _, c in part])
    face_zone = np.concatenate(
        [np.full(sum(len(n) for n, _ in part), z, dtype=np.int64) for z, part in enumerate(order)]
    )
    return Grid(
        dim=dim, points=points, face_nodes=face_nodes.astype(np.int64),
        face_cells=face_cells.astype(np.int64), face_zone=face_zone, zones=zones,
        n_cells=C, cell_ijk=cell_ijk,
    )


def _positions(ext) -> np.ndarray:
    """(i, j, k) of every point of an ext[0] x ext[1] x ext[2] lattice,
    i fastest."""
    k, j, i = np.unravel_index(np.arange(ext[0] * ext[1] * ext[2]), ext[::-1])
    return np.stack([i, j, k], axis=1).astype(np.int64)
