"""ANSYS Fluent TGRID (.msh) mesh reader (port of orc_tpu/mesh/tgrid.py,
Python parser).

Host-side numpy: parses the TGRID section grammar into a `RawMesh`;
`read_mesh` compiles it onto a device with mesh/compile.py.

Grammar (the reference reader's, io.rs:32-284):

- ``(0 "...")``   comments; the trailing word names the next face zone
- ``(2 d)``       dimensionality (2 or 3)
- ``(10 ...)``    nodes, with hexadecimal index ranges
- ``(12 ...)``    cell zones
- ``(13 ...)``    faces: node indices + two cell indices, hexadecimal,
                  1-based with 0 meaning "no cell" (boundary)
- ``(18 ...)``    periodic shadow-face pairs, kept as
                  ``RawMesh.periodic_pairs``
- ``(39/45 ...)`` zone names (decimal ids), used when no comment named
                  the zone
- anything else is skipped.

Face body lines carry a leading node count when the section's face type
is 0 (mixed) or 5 (polygonal); otherwise the node count equals the face
type code.

`read_mesh` parses with the port's C++ reader (mesh/native.py,
csrc/tgrid_reader.cpp) where it can: `native="auto"` tries it and takes
this parser when it fails, True requires it, False takes this parser.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List

import numpy as np
import torch

from orc_tpu_torch.mesh.zones import CellZone, FaceCondition, FaceZone

_HEX_TOKENS = re.compile(r"[0-9a-fA-F]+")
_NAME_SECTION = re.compile(r"\((?:39|45)\s*\((\d+)\s+(\S+)\s+([^\s\)]+)")


@dataclasses.dataclass
class RawMesh:
    """Parsed topology straight from the file (host, numpy)."""

    dim: int
    points: np.ndarray  # [N, 3] float64 (z = 0 for 2D)
    face_nodes: List[np.ndarray]  # ragged: per-face 0-based node indices
    face_cells: np.ndarray  # [F, 2] int64; c0/c1 in file order, -1 = none
    face_zone_id: np.ndarray  # [F] int64
    face_zones: Dict[int, FaceZone]
    cell_zones: Dict[int, CellZone]
    n_cells: int
    # [P,2] int64, 0-based (periodic face, shadow face) pairs.
    periodic_pairs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), dtype=np.int64)
    )

    @property
    def n_faces(self) -> int:
        return len(self.face_nodes)


def _header_ints(line: str) -> List[int]:
    """All hexadecimal integer tokens in a section header line."""
    return [int(t, 16) for t in _HEX_TOKENS.findall(line)]


def _consume_body(lines: List[str], start: int, out: List[str]) -> int:
    """Collect stripped body lines until the closing ')' line; returns
    the index one past the closing line."""
    j = start
    n = len(lines)
    while j < n:
        s = lines[j].strip()
        if s == "(":
            j += 1
            continue
        if s.startswith(")"):
            return j + 1
        if s:
            out.append(s)
        j += 1
    return j


def parse_tgrid(text: str) -> RawMesh:
    lines = text.splitlines()
    n = len(lines)
    i = 0

    dim = 0
    zone_comment_name = ""
    points: Dict[int, np.ndarray] = {}
    face_nodes: Dict[int, np.ndarray] = {}
    face_cells: Dict[int, tuple] = {}
    face_zone_of: Dict[int, int] = {}
    face_zones: Dict[int, FaceZone] = {}
    cell_zones: Dict[int, CellZone] = {}
    n_cells_declared = 0
    section_names: Dict[int, str] = {}
    periodic_pairs: List[tuple] = []

    while i < n:
        line = lines[i].strip()
        if not line:
            i += 1
            continue
        tok = line.split(None, 1)[0]

        if tok == "(0":
            # The comment's last word names the next zone (io.rs:83-90).
            if " " in line:
                zone_comment_name = (
                    line.rsplit(" ", 1)[1].rstrip(")").rstrip('"')
                )
            i += 1
            continue

        if tok == "(2":
            dim = int(line.split()[1].rstrip(")"))
            if dim not in (2, 3):
                raise ValueError(f"mesh must be 2D or 3D, got {dim}D")
            i += 1
            continue

        if tok.startswith("(39") or tok.startswith("(45"):
            m = _NAME_SECTION.search(line)
            if m:
                section_names[int(m.group(1))] = m.group(3)
            i += 1
            continue

        if tok == "(10":
            hdr = _header_ints(line)
            if len(hdr) < 6:
                i += 1
                continue
            _, zone, first, _last, _, _ = hdr[:6]
            if zone == 0:
                i += 1
                continue
            body: List[str] = []
            i = _consume_body(lines, i + 1, body)
            idx = first - 1
            for s in body:
                parts = s.replace(")", " ").split()
                if len(parts) >= dim:
                    x = float(parts[0])
                    y = float(parts[1])
                    z = float(parts[2]) if dim == 3 else 0.0
                    points[idx] = np.array([x, y, z])
                idx += 1
            continue

        if tok == "(12":
            hdr = _header_ints(line)
            if len(hdr) >= 6:
                _, zone, _first, last, ztype = hdr[:5]
                if zone == 0:
                    n_cells_declared = max(n_cells_declared, last)
                else:
                    cell_zones.setdefault(
                        zone, CellZone(zone_id=zone, zone_type=ztype)
                    )
            i += 1
            continue

        if tok == "(18":
            # (18 (first last zone shadow)) then "face shadow-face" lines,
            # hex, 1-based (io.rs:176-179 skips them).
            body = []
            i = _consume_body(lines, i + 1, body)
            for s in body:
                toks = _HEX_TOKENS.findall(s)
                if len(toks) >= 2:
                    periodic_pairs.append(
                        (int(toks[0], 16) - 1, int(toks[1], 16) - 1)
                    )
            continue

        if tok == "(13":
            hdr = _header_ints(line)
            if len(hdr) < 6:
                i += 1
                continue
            _, zone, first, _last, bc_type, face_type = hdr[:6]
            if zone == 0:
                i += 1
                continue
            try:
                cond = FaceCondition(bc_type)
            except ValueError as e:
                raise ValueError(
                    f"invalid boundary-condition code {bc_type} for face "
                    f"zone {zone}"
                ) from e
            face_zones.setdefault(
                zone,
                FaceZone(zone_id=zone, zone_type=cond, name=zone_comment_name),
            )
            body = []
            i = _consume_body(lines, i + 1, body)
            fidx = first - 1
            for s in body:
                toks = _HEX_TOKENS.findall(s)
                if len(toks) < 2:
                    continue
                vals = [int(t, 16) for t in toks]
                if face_type in (0, 5):
                    cnt = vals[0]
                    nodes = vals[1 : 1 + cnt]
                    cells = vals[1 + cnt : 3 + cnt]
                else:
                    nodes = vals[:-2]
                    cells = vals[-2:]
                face_nodes[fidx] = np.asarray(nodes, dtype=np.int64) - 1
                c0 = cells[0] - 1 if cells[0] > 0 else -1
                c1 = cells[1] - 1 if len(cells) > 1 and cells[1] > 0 else -1
                face_cells[fidx] = (c0, c1)
                face_zone_of[fidx] = zone
                fidx += 1
            continue

        i += 1

    for zid, fz in face_zones.items():
        if not fz.name and zid in section_names:
            fz.name = section_names[zid]

    n_pts = max(points) + 1 if points else 0
    pts = np.zeros((n_pts, 3), dtype=np.float64)
    for k, v in points.items():
        pts[k] = v
    f_count = max(face_nodes) + 1 if face_nodes else 0
    fn = [face_nodes[k] for k in range(f_count)]
    fc = np.full((f_count, 2), -1, dtype=np.int64)
    fz_id = np.zeros((f_count,), dtype=np.int64)
    for k in range(f_count):
        fc[k] = face_cells[k]
        fz_id[k] = face_zone_of[k]

    n_cells = int(fc.max()) + 1
    if n_cells_declared:
        n_cells = max(n_cells, n_cells_declared)

    if dim == 0:
        raise ValueError("mesh file has no (2 d) dimension section")
    for k, nodes in enumerate(fn):
        if len(nodes) < dim:
            raise ValueError(f"face {k} has too few nodes ({len(nodes)})")

    return RawMesh(
        dim=dim,
        points=pts,
        face_nodes=fn,
        face_cells=fc,
        face_zone_id=fz_id,
        face_zones=face_zones,
        cell_zones=cell_zones,
        n_cells=n_cells,
        periodic_pairs=(
            np.asarray(periodic_pairs, dtype=np.int64)
            if periodic_pairs
            else np.zeros((0, 2), dtype=np.int64)
        ),
    )


def read_mesh(
    path: str,
    verbose: bool = False,
    native: str | bool = "auto",
    dtype: torch.dtype = torch.float64,
    nodes: bool = False,
    device: torch.device | str = "cuda",
):
    """Read a TGRID mesh file and compile it onto `device`: returns
    (CompiledMesh, BoundaryTable).

    `native`: "auto" tries the C++ parser (mesh/native.py) and takes this
    module's Python parser when it fails; True requires it (a failed
    g++ build or parse raises); False forces Python. Either parser gives
    the same RawMesh: a host parser choice, not a device fallback.

    `nodes=True` also builds the vertex-interpolation tables required
    by node-based Green-Gauss gradients (mesh/nodes.py)."""
    from orc_tpu_torch.mesh.compile import compile_mesh

    raw = None
    if native in ("auto", True):
        try:
            from orc_tpu_torch.mesh.native import parse_tgrid_native

            raw = parse_tgrid_native(path)
        except Exception:
            if native is True:
                raise
    if raw is None:
        with open(path) as f:
            raw = parse_tgrid(f.read())
    if verbose:
        print(
            f"Read mesh {path}: {raw.n_cells} cells, {raw.n_faces} faces, "
            f"{len(raw.points)} nodes ({raw.dim}D)"
        )
        for zid, fz in sorted(raw.face_zones.items()):
            print(f"  face zone {zid}: {fz.zone_type.name} ({fz.name})")
    return compile_mesh(raw, dtype=dtype, nodes=nodes, device=device)
