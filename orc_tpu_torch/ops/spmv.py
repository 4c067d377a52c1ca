"""ELL sparse matrix-vector products (port of orc_tpu/ops/spmv.py).

`EllMatrix` is A = diag(diag) + scatter(off) over a neighbor table:
- structured meshes (`offsets` set): the shift SpMV, kernel 1
  (ops/shift_spmv.py) on the card, its torch.roll version on CPU;
- irregular meshes with a slice plan: `prepare()` converts `off` once
  per solve into the slice-column layout, after which every matvec is
  the slice SpMV (ops/slice_spmv.py, kernels 7-9 on the card);
- otherwise the gather form over `neighbors`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from orc_tpu_torch.ops.shift_spmv import shift_spmv
from orc_tpu_torch.ops.slice_spmv import slice_spmv


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """diag: [..., C]; off: [..., C, K] or a K-tuple of [..., C]
    columns (or, with `slice_layout`, [..., ntiles, n_max, T]);
    neighbors: [C, K] i32 (None on the shift path).

    `offsets`: per-column index deltas of a structured adjacency
    (neighbors[c, k] == c + offsets[k] wherever off != 0). Any row whose
    neighbor is not exactly c + offsets[k] carries a zero coefficient,
    which makes the wrap-around of a roll and the zero padding of the
    kernel agree.

    `plan` (irregular meshes, mesh/reorder.py) and `slice_layout`: see
    `prepare()`."""

    diag: torch.Tensor
    off: "torch.Tensor | tuple"
    neighbors: "torch.Tensor | None"
    offsets: tuple | None = None
    plan: "object | None" = None
    slice_layout: bool = False

    @property
    def n(self) -> int:
        return self.diag.shape[-1]

    def matvec(self, x):
        """A @ x for x of shape [..., C]."""
        if self.slice_layout:
            return slice_spmv(self.diag, self.off, self.plan, x)
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
        return dataclasses.replace(
            self,
            off=tuple(self.off[..., k] for k in keep),
            offsets=tuple(self.offsets[k] for k in keep),
        )

    def prepare(self) -> "EllMatrix":
        """The slice-column layout [..., ntiles, n_max, T] of `off`, once
        per solve, when a plan exists (no-op otherwise). One scatter-add:
        entry (c, k) lands in (tile c // T, column col_of[c, k], lane
        c % T); entries of one row that share a delta add up, as orc_tpu's
        K-way select accumulation does, and boundary or padded entries
        add their zero coefficient to column 0."""
        if self.plan is None or self.slice_layout:
            return self
        p = self.plan
        C, K = self.off.shape[-2:]
        batch = self.off.shape[:-2]
        dev = self.off.device
        c = torch.arange(C, device=dev)
        flat = (
            ((c // p.tile)[:, None] * p.n_max + p.col_of.long()) * p.tile
            + (c % p.tile)[:, None]
        ).reshape(-1)
        rows = self.off.reshape(-1, C * K)
        nb = rows.shape[0]
        coef = torch.zeros(
            (nb, p.ntiles * p.n_max * p.tile), dtype=self.off.dtype, device=dev
        )
        b_idx = torch.arange(nb, device=dev)[:, None].expand(nb, C * K)
        coef.index_put_(
            (b_idx.reshape(-1), flat.expand(nb, -1).reshape(-1)),
            rows.reshape(-1),
            accumulate=True,
        )
        return dataclasses.replace(
            self,
            off=coef.reshape(*batch, p.ntiles, p.n_max, p.tile),
            offsets=None,
            slice_layout=True,
        )

    def with_values(self, diag, off) -> "EllMatrix":
        return dataclasses.replace(self, diag=diag, off=off)

    def jacobi_preconditioned(self):
        """Return (D^-1 A, D^-1): rows scaled by 1/diag."""
        inv_d = 1.0 / self.diag
        if self.slice_layout:
            p = self.plan
            batch = self.diag.shape[:-1]
            cpad = p.ntiles * p.tile - p.n_cells
            inv_d_t = F.pad(inv_d, (0, cpad)).reshape(
                *batch, p.ntiles, 1, p.tile
            )
            off_scaled = self.off * inv_d_t
        elif isinstance(self.off, tuple):
            off_scaled = tuple(o * inv_d for o in self.off)
        else:
            off_scaled = self.off * inv_d[..., None]
        return (
            dataclasses.replace(
                self, diag=torch.ones_like(self.diag), off=off_scaled
            ),
            inv_d,
        )


def ell_spmv(diag, off, neighbors, x, offsets=None):
    """y = diag * x + sum_k off[..., k] * x[..., neighbors[:, k]].

    With static `offsets` the gathers are shifts: kernel 1 on CUDA
    tensors (batched x shares one [C] matrix, or takes one [B,C] matrix
    per batch row), torch.roll on CPU. Without, one gather over the
    neighbor table (meshes without a slice plan)."""
    if offsets is not None:
        return shift_spmv(diag, off, offsets, x)
    xg = x[..., neighbors.long()]  # [..., C, K]
    return diag * x + torch.sum(off * xg, dim=-1)
