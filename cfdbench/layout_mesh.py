"""Reading the program's outputs in a mesh reference's layout.

The program reads the generator's file and numbers cells its own way:
program cell i is file cell `cell_order[i]` (reverse Cuthill-McKee), or
i where it kept the file's order. It keeps the file's faces in the
file's order. Both are checked, never assumed: every cell centroid and
every face centroid of the program against the reference's own, as a
share of the mesh's size (`gap`, against `limit`: 1e-9 in float64, the
float32 rounding of a coordinate in float32). The stored face velocities
of SIMPLE_FC, per (cell, slot) [C, K] or per face [F], map to one value
per face, positive out of the reference's owner. It reads the mesh's
tensors and imports nothing of the program.
"""

from __future__ import annotations

import torch

LIMITS = {torch.float64: 1e-9, torch.float32: float(torch.finfo(torch.float32).eps)}


class MeshLayout:
    """Maps from the program's numbering onto a reference Mesh
    (reference/mesh.py). Holds only index tensors, so the program's mesh
    can be freed once it is built."""

    def __init__(self, mesh, ref):
        dev = ref.device
        C, F = ref.n_cells, ref.owner.shape[0]
        self.limit = LIMITS[mesh.dtype]
        if mesh.n_cells != C or mesh.n_faces != F:
            raise ValueError(f"the program has {mesh.n_cells} cells and {mesh.n_faces} faces, the file {C} and {F}")
        order = mesh.cell_order
        self.order = (torch.arange(C, device=dev) if order is None else order.to(dev).long())
        scale = max(
            float(torch.max(torch.abs(ref.face_centroid))),
            float(torch.max(ref.face_centroid.amax(0) - ref.face_centroid.amin(0))),
        )
        gap_c = torch.max(torch.abs(mesh.cell_centroid.to(dev).double() - ref.cell_centroid[self.order]))
        gap_f = torch.max(torch.abs(mesh.face_centroid.to(dev).double() - ref.face_centroid))
        # Each face's owner in the program, as a reference cell: the
        # reference's owner (+1) or its neighbour (-1).
        own = self.order[mesh.face_owner.to(dev).long()]
        nbr = self.order[mesh.face_neighbor.to(dev).long()]
        same = own == ref.owner
        flipped = (nbr == ref.owner) & (own == ref.neighbour)
        self.sign = torch.where(same, 1.0, -1.0).double()
        wrong = int(torch.sum(~(same | flipped)))
        self.gap = float("inf") if wrong else float(max(gap_c, gap_f)) / scale
        # The slot of each face's owner in the program's [C, K] tables.
        cf = mesh.cell_faces.to(dev).long()
        rows, cols = torch.nonzero(mesh.cell_face_mask.to(dev) & (mesh.cell_face_sign.to(dev) > 0), as_tuple=True)
        faces = cf[rows, cols]
        if faces.numel() != F or int(torch.unique(faces).numel()) != F:
            raise ValueError("every face needs exactly one owner slot")
        self.slot_cell = torch.empty(F, dtype=torch.long, device=dev)
        self.slot_k = torch.empty(F, dtype=torch.long, device=dev)
        self.slot_cell[faces], self.slot_k[faces] = rows, cols

    def cells(self, x, dtype=torch.float64):
        """A program cell field [C] or [C, 3] as [C] or [3, C]."""
        x = x.to(self.order.device, dtype)
        y = torch.empty_like(x)
        y[self.order] = x
        return y.T.contiguous() if y.ndim == 2 else y

    def rows(self, x, dtype=torch.float64):
        """A component-major [B, C] program field as [B, C]."""
        return self.cells(x.T, dtype)

    def flux(self, f, dtype=torch.float64):
        """Stored face velocities [C, K] or [F] as one [F] array (in a
        list of one), out of the reference's owner."""
        f = f.to(self.order.device)
        per_face = f[self.slot_cell, self.slot_k] if f.ndim == 2 else f
        return [(self.sign * per_face.double()).to(dtype)]

    def state(self, s, dtype=torch.float64):
        """A program FlowState in the reference layout: vel [3, C], p [C],
        md the momentum diagonals [3, C], flux a list or None."""
        return dict(
            vel=self.cells(s.vel, dtype),
            p=self.cells(s.p, dtype),
            md=self.rows(s.mom_diag, dtype),
            flux=None if s.flux is None else self.flux(s.flux, dtype),
        )
