"""Greedy graph colouring of the cell adjacency, on the host (port of
orc_tpu/solver/coloring.py).

Gauss-Seidel runs in parallel as a multi-colour sweep: cells of one
colour share no faces, so they update together with full Gauss-Seidel
semantics. The colouring is computed once per mesh (a greedy pass in
cell order over the bounded-degree graph; K + 1 colours suffice).
"""

from __future__ import annotations

import numpy as np
import torch


def greedy_coloring(mesh):
    """(colors [C] int32 on the mesh's device, n_colors): each cell, in
    cell order, takes the smallest colour none of its face neighbours
    has taken, as orc_tpu's loop does."""
    nbrs = mesh.cell_neighbors.cpu().numpy()
    C = nbrs.shape[0]
    own = np.arange(C)[:, None]
    mask = mesh.cell_face_mask.cpu().numpy() & (nbrs != own)
    # Slots that are not faces point at the cell itself, which has no
    # colour yet when its turn comes, so they constrain nothing.
    rows = np.where(mask, nbrs, own).tolist()
    colors = [-1] * C
    for c, row in enumerate(rows):
        used = {colors[j] for j in row}
        col = 0
        while col in used:
            col += 1
        colors[c] = col
    out = torch.tensor(colors, dtype=torch.int32, device=mesh.device)
    return out, int(max(colors)) + 1
