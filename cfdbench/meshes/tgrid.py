"""The ASCII TGRID writer, and the mesh file of a configuration's case.

`write(grid, path)` writes a Grid in the layout the program's own writer
uses (orc_tpu_torch/mesh/generate.write_tgrid), which both of the
program's parsers read: a node section, one cell zone, and one face
section per zone, named by the comment before it. Lines are built as
byte arrays, a chunk of rows at a time: node coordinates in numpy's
shortest round-trip form, indices in fixed-width hexadecimal.

`mesh_file(case, root)` writes the file of a case
({"generator": name, **params}) once into `root`, named by the
generator, a hash of its parameters and of the sources that make it; a
run that finds the file reuses it.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path

import numpy as np

from cfdbench.meshes import Grid, generator

CHUNK = 1 << 20
FLOAT_WIDTH = 25  # the longest float64 repr, '-1.2345678901234567e-308', and a space
HEX = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)
SPACE, NEWLINE = ord(" "), ord("\n")


def _hex_rows(cols: np.ndarray) -> bytes:
    """Rows of non-negative integers as lines of space-separated
    hexadecimal numbers of one width."""
    n, k = cols.shape
    width = max(1, (int(cols.max(initial=0)).bit_length() + 3) // 4)
    shifts = 4 * np.arange(width - 1, -1, -1, dtype=np.int64)
    out = np.full((n, k, width + 1), SPACE, dtype=np.uint8)
    out[:, :, :width] = HEX[(cols[:, :, None] >> shifts) & 15]
    out = out.reshape(n, k * (width + 1))
    out[:, -1] = NEWLINE
    return out.tobytes()


def _float_rows(x: np.ndarray) -> bytes:
    """Rows of float64 as lines of space-padded round-trip decimals."""
    n, d = x.shape
    s = np.ascontiguousarray(x).astype(f"S{FLOAT_WIDTH - 1}")
    out = np.full((n, d, FLOAT_WIDTH), SPACE, dtype=np.uint8)
    txt = s.view(np.uint8).reshape(n, d, FLOAT_WIDTH - 1)
    out[:, :, : FLOAT_WIDTH - 1] = np.where(txt == 0, SPACE, txt)
    out = out.reshape(n, d * FLOAT_WIDTH)
    out[:, -1] = NEWLINE
    return out.tobytes()


def write(grid: Grid, path, title="cfdbench") -> None:
    """Write `grid` as an ASCII TGRID file at `path`."""
    dim, N, C, F = grid.dim, grid.points.shape[0], grid.n_cells, grid.n_faces
    M = grid.face_nodes.shape[1]
    zone = np.asarray(grid.face_zone)
    if np.any(np.diff(zone) < 0):
        raise ValueError("faces of one zone must be contiguous, the zones in order")
    if np.any(grid.face_cells[:, 0] < 0):
        raise ValueError("every face's first cell must be present")
    cells1 = grid.face_cells + 1  # 1-based, 0 = none
    with open(path, "wb") as f:
        f.write(f'(0 "Generated by {title}")\n(0 "Units: Meters")\n(2 {dim})\n'.encode())
        f.write(f"(10 (0 1 {N:x} 0 {dim}))\n(10 (1 1 {N:x} 1 {dim})\n(\n".encode())
        for a in range(0, N, CHUNK):
            f.write(_float_rows(grid.points[a : a + CHUNK, :dim]))
        f.write(b"))\n")
        f.write(f"(12 (0 1 {C:x} 0 0))\n(12 (2 1 {C:x} 1 {4 if dim == 3 else 3}))\n".encode())
        f.write(f"(13 (0 1 {F:x} 0 0))\n".encode())
        bounds = np.searchsorted(zone, np.arange(len(grid.zones) + 1))
        for z, (name, code) in enumerate(grid.zones):
            first, last = int(bounds[z]), int(bounds[z + 1])
            if first == last:
                continue
            f.write(f'(0 "Faces of zone {name}")\n'.encode())
            f.write(f"(13 ({10 + z:x} {first + 1:x} {last:x} {code:x} {M:x})(\n".encode())
            for a in range(first, last, CHUNK):
                b = min(a + CHUNK, last)
                f.write(_hex_rows(np.concatenate([grid.face_nodes[a:b] + 1, cells1[a:b]], axis=1)))
            f.write(b")\n)\n")


def _key(name: str, params: dict) -> str:
    """Hash of a case: the generator, its parameters, and the sources of
    the generator and of this writer."""
    h = hashlib.sha256(json.dumps([name, params], sort_keys=True).encode())
    for src in (Path(generator(name).__file__), Path(__file__)):
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def mesh_file(case: dict, root: Path):
    """(path, seconds spent making it, the Grid or None) of a case's mesh
    file under `root`: written on the first call, found on later ones."""
    params = {k: v for k, v in case.items() if k != "generator"}
    name = case["generator"]
    path = Path(root) / f"{name}-{_key(name, params)}.msh"
    if path.exists():
        return path, 0.0, None
    t = time.perf_counter()
    grid = generator(name).generate(**params)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        write(grid, tmp, f"cfdbench.meshes.{name}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path, time.perf_counter() - t, grid
