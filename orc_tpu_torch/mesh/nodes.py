"""Node (vertex) interpolation tables of node-based Green-Gauss (port of
orc_tpu/mesh/nodes.py).

Cell values are interpolated to the mesh vertices by inverse-distance
weighting, vertex values are averaged to face values, and the
Green-Gauss sum runs on those face values (ops/gradients.py). Both
stages are padded fixed-width gather-reduce tables ([N,Kn] cells per
node, [F,Kf] nodes per face), built once on the host from the RawMesh.

orc_tpu fills each node's row from a Python set, so a row's order (and
with it the order of the weighted sum) follows set iteration; here the
rows are built by sorting (node, cell) pairs, each row in ascending cell
order. The tables hold the same (cell, weight) pairs per row.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orc_tpu_torch.mesh.tgrid import RawMesh
from orc_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class NodeInterp:
    node_cells: torch.Tensor  # [N,Kn] i32 (0 at padded slots)
    node_w: torch.Tensor  # [N,Kn] IDW weights, normalized, 0 padded
    face_nodes: torch.Tensor  # [F,Kf] i32 (0 at padded slots)
    face_node_w: torch.Tensor  # [F,Kf] 1/n_nodes(f), 0 padded

    @property
    def n_nodes(self) -> int:
        return self.node_cells.shape[0]

    def to(self, device) -> "NodeInterp":
        return NodeInterp(
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
            }
        )


def _rows(keys: np.ndarray, values: np.ndarray, n_rows: int, width=None):
    """Pack (row, value) pairs, sorted by row, into a zero-padded
    [n_rows, width] table; returns (table, slot of each pair)."""
    counts = np.bincount(keys, minlength=n_rows)
    if width is None:
        width = int(counts.max()) if n_rows else 1
    starts = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(keys.shape[0]) - starts[keys]
    table = np.zeros((n_rows, width), dtype=values.dtype)
    table[keys, slot] = values
    return table, slot


def build_node_interp(
    raw: RawMesh,
    cell_centroid: np.ndarray,
    dtype: torch.dtype = torch.float64,
    *,
    device: torch.device | str = "cuda",
) -> NodeInterp:
    """Host-side build of the two padded interpolation tables (numpy,
    vectorized), moved to `device`."""
    device = resolve_device(device)
    N = raw.points.shape[0]
    F = raw.n_faces
    C = max(int(raw.n_cells), 1)
    cc = np.asarray(cell_centroid, dtype=np.float64)
    pts = np.asarray(raw.points, dtype=np.float64)

    counts = np.fromiter((len(fn) for fn in raw.face_nodes), np.int64, F)
    flat = (
        np.concatenate(raw.face_nodes).astype(np.int64)
        if F else np.zeros(0, np.int64)
    )
    face_of = np.repeat(np.arange(F, dtype=np.int64), counts)
    fcells = np.asarray(raw.face_cells, dtype=np.int64)

    # node -> adjacent cells (through the faces that carry each node),
    # each (node, cell) pair once, sorted by node then cell.
    nodes, cells = [], []
    for side in (0, 1):
        c = fcells[face_of, side] if F else np.zeros(0, np.int64)
        on = c >= 0
        nodes.append(flat[on])
        cells.append(c[on])
    key = np.unique(np.concatenate(nodes) * C + np.concatenate(cells))
    node, cell = key // C, key % C
    node_cells, _ = _rows(node, cell, N)
    d = np.linalg.norm(cc[cell] - pts[node], axis=1)
    w = 1.0 / np.maximum(d, 1e-300)
    w = w / np.bincount(node, weights=w, minlength=N)[node]
    node_w, _ = _rows(node, w, N, node_cells.shape[1])

    # Orphan nodes keep zero weights and contribute nothing.
    face_nodes, _ = _rows(face_of, flat, F)
    face_node_w, _ = _rows(face_of, 1.0 / counts[face_of], F, face_nodes.shape[1])

    def f(x):
        return torch.tensor(x, dtype=dtype, device=device)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    return NodeInterp(
        node_cells=i32(node_cells),
        node_w=f(node_w),
        face_nodes=i32(face_nodes),
        face_node_w=f(face_node_w),
    )


def node_face_values(ni: NodeInterp, phi):
    """Cell field -> face values through the vertices: phi [C] -> [F];
    [C,3] -> [F,3]."""
    nc = ni.node_cells.long()
    fn = ni.face_nodes.long()
    if phi.ndim == 1:
        phi_n = torch.sum(phi[nc] * ni.node_w, dim=1)  # [N]
        return torch.sum(phi_n[fn] * ni.face_node_w, dim=1)
    phi_n = torch.sum(phi[nc] * ni.node_w[..., None], dim=1)  # [N,3]
    return torch.sum(phi_n[fn] * ni.face_node_w[..., None], dim=1)
