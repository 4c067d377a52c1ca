"""Reading the program's outputs in the reference's layout.

The program numbers cells and faces its own way; the reference keeps
[Z, Y, X] cell grids and one face array per axis. This module builds
the correspondence once from the mesh's geometry (cell centroids, each
face slot's outward normal), so it holds whatever order the program
keeps, and then maps states: a cell field by its cells' positions, the
stored face velocities of SIMPLE_FC, per (cell, slot) [C, K] or per
face [F], by the face each value belongs to. It reads the mesh's
tensors and imports nothing of the program.
"""

from __future__ import annotations

import torch


class Layout:
    """Maps from the program's numbering onto a reference box of `dims`
    and spacing `h`. Holds only index tensors, so the mesh can be freed
    once it is built."""

    def __init__(self, mesh, dims, h):
        self.dims = tuple(dims)
        nx, ny, nz = self.dims
        cc = mesh.cell_centroid.double()
        ijk = [torch.round(cc[:, a] / h[a] - 0.5).long() for a in range(3)]
        self.ijk = ijk
        self.flat = ijk[0] + nx * (ijk[1] + ny * ijk[2])
        C = self.flat.numel()
        if C != nx * ny * nz:
            raise ValueError(f"mesh has {C} cells, the box {nx * ny * nz}")
        self._ck = self._slot_table(mesh)
        self._fm = self._face_table(mesh)

    # --- cells ------------------------------------------------------------

    def cells(self, x, dtype=torch.float64):
        """A [C] or [C, 3] program field as [Z, Y, X] or [3, Z, Y, X]."""
        nx, ny, nz = self.dims
        y = torch.empty(x.shape, dtype=dtype, device=x.device)
        y[self.flat] = x.to(dtype)
        x = y
        if x.ndim == 1:
            return x.reshape(nz, ny, nx)
        return x.T.reshape(x.shape[1], nz, ny, nx)

    def rows(self, x, dtype=torch.float64):
        """A component-major [B, C] program field as [B, Z, Y, X]."""
        return self.cells(x.T, dtype)

    # --- stored face velocities -----------------------------------------------

    def _face_pos(self, a, plane, cells):
        """Flat index into axis a's face array [Z, Y, X] (+1 along a) of
        the face on plane `plane` beside `cells`."""
        nx, ny, nz = self.dims
        ext = [nx, ny, nz]
        ext[a] += 1
        c = [self.ijk[0][cells], self.ijk[1][cells], self.ijk[2][cells]]
        c[a] = plane
        return c[0] + ext[0] * (c[1] + ext[1] * c[2])

    def _slot_table(self, mesh):
        """Per axis: (cells, slots, face positions, signs) of the slots
        that carry each face of that axis once: every cell's upper face
        and the lower boundary plane."""
        table = [([], [], [], []) for _ in range(3)]
        for k in range(mesh.cell_faces.shape[1]):
            m = mesh.cell_face_mask[:, k]
            f = mesh.cell_faces[:, k].long()
            n = mesh.cell_face_sign[:, k, None] * mesh.face_normal[f]
            axis = torch.argmax(torch.abs(n), dim=1)
            s = torch.gather(n, 1, axis[:, None])[:, 0]
            for a in range(3):
                on = m & (axis == a)
                up = torch.nonzero(on & (s > 0))[:, 0]
                low = torch.nonzero(on & (s < 0) & (self.ijk[a] == 0))[:, 0]
                for cells, plane, sign in (
                    (up, self.ijk[a][up] + 1, 1.0),
                    (low, torch.zeros_like(low), -1.0),
                ):
                    table[a][0].append(cells)
                    table[a][1].append(torch.full_like(cells, k))
                    table[a][2].append(self._face_pos(a, plane, cells))
                    table[a][3].append(torch.full(cells.shape, sign, dtype=torch.float64, device=cells.device))
        return [tuple(torch.cat(col) for col in t) for t in table]

    def _face_table(self, mesh):
        """Per axis: (faces, face positions, signs) of the face-major
        layout (owner-outward values)."""
        own = mesh.face_owner.long()
        n = mesh.face_normal
        axis = torch.argmax(torch.abs(n), dim=1)
        s = torch.gather(n, 1, axis[:, None])[:, 0]
        table = []
        for a in range(3):
            fa = torch.nonzero(axis == a)[:, 0]
            cells = own[fa]
            plane = torch.where(s[fa] > 0, self.ijk[a][cells] + 1, self.ijk[a][cells])
            sign = torch.where(s[fa] > 0, 1.0, -1.0).double()
            table.append((fa, self._face_pos(a, plane, cells), sign))
        return table

    def flux(self, f, dtype=torch.float64):
        """Stored face velocities [C, K] or [F] as one face array per
        axis, along +e_a."""
        nx, ny, nz = self.dims
        out = []
        for a in range(3):
            ext = [nz, ny, nx]
            ext[2 - a] += 1
            arr = torch.zeros(ext[0] * ext[1] * ext[2], dtype=dtype, device=f.device)
            if f.ndim == 2:
                cells, slots, pos, sign = self._ck[a]
                arr[pos] = (sign * f[cells, slots].double()).to(dtype)
            else:
                faces, pos, sign = self._fm[a]
                arr[pos] = (sign * f[faces].double()).to(dtype)
            out.append(arr.reshape(ext))
        return out

    def state(self, s, dtype=torch.float64):
        """A program FlowState in the reference layout: vel [3, ...],
        p, md the momentum diagonals [3, ...], flux a list or None."""
        return dict(
            vel=self.cells(s.vel, dtype),
            p=self.cells(s.p, dtype),
            md=self.rows(s.mom_diag, dtype),
            flux=None if s.flux is None else self.flux(s.flux, dtype),
        )
