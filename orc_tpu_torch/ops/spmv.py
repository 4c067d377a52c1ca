"""ELL sparse matrix-vector products (port of the structured part of
orc_tpu/ops/spmv.py).

`EllMatrix` is A = diag(diag) + scatter(off) over a neighbor table. On a
structured mesh (`offsets` set) the SpMV is a shift SpMV: kernel 1
(ops/shift_spmv.py) on the card, its torch.roll version on CPU. The
slice-plan layout of irregular meshes is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from orc_tpu_torch.ops.shift_spmv import shift_spmv


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """diag: [..., C]; off: [..., C, K] or a K-tuple of [..., C]
    columns; neighbors: [C, K] i32 (or None on the shift path).

    `offsets`: per-column index deltas of a structured adjacency
    (neighbors[c, k] == c + offsets[k] wherever off != 0). Any row whose
    neighbor is not exactly c + offsets[k] carries a zero coefficient,
    which makes the wrap-around of a roll and the zero padding of the
    kernel agree."""

    diag: torch.Tensor
    off: "torch.Tensor | tuple"
    neighbors: "torch.Tensor | None"
    offsets: tuple | None = None

    @property
    def n(self) -> int:
        return self.diag.shape[-1]

    def matvec(self, x):
        """A @ x for x of shape [..., C]."""
        return ell_spmv(self.diag, self.off, self.neighbors, x, self.offsets)

    def split_columns(self) -> "EllMatrix":
        """Split `off` into its K per-offset [..., C] columns before a
        solver loop, dropping zero-offset (padded, never active) slots.
        A column of a [C,K] tensor is a strided view; of the assembly
        kernels' transposed [K,C] planes, a contiguous one. No-op when
        already split or unstructured."""
        if self.offsets is None or isinstance(self.off, tuple):
            return self
        keep = [k for k, d in enumerate(self.offsets) if int(d) != 0]
        return EllMatrix(
            diag=self.diag,
            off=tuple(self.off[..., k] for k in keep),
            neighbors=self.neighbors,
            offsets=tuple(self.offsets[k] for k in keep),
        )

    def with_values(self, diag, off) -> "EllMatrix":
        return EllMatrix(
            diag=diag, off=off, neighbors=self.neighbors, offsets=self.offsets
        )

    def jacobi_preconditioned(self):
        """Return (D^-1 A, D^-1): rows scaled by 1/diag."""
        inv_d = 1.0 / self.diag
        if isinstance(self.off, tuple):
            off_scaled = tuple(o * inv_d for o in self.off)
        else:
            off_scaled = self.off * inv_d[..., None]
        return (
            EllMatrix(
                diag=torch.ones_like(self.diag),
                off=off_scaled,
                neighbors=self.neighbors,
                offsets=self.offsets,
            ),
            inv_d,
        )


def ell_spmv(diag, off, neighbors, x, offsets=None):
    """y = diag * x + sum_k off[..., k] * x[..., neighbors[:, k]].

    With static `offsets` the gathers are shifts: kernel 1 on CUDA
    tensors (batched x shares one [C] matrix there), torch.roll on
    CPU. The gather form of irregular meshes is not ported yet."""
    if offsets is None:
        raise NotImplementedError(
            "the gather SpMV of irregular meshes is not ported yet "
            "(ROADMAP Queue 1, item 11)"
        )
    return shift_spmv(diag, off, offsets, x)
