"""Kernels 7-12: the slice-plan SpMVs and neighbour-value gather of
irregular meshes (the counterpart of orc_tpu/ops/pallas_slice.py).

- `slice_spmv` replaces `_kernel`, `_kernel_heavy` (via
  `_slice_spmv_pallas`) and `_kernel_wide` (via
  `_slice_spmv_pallas_wide`): y = diag * x + the slice-plan product of
  the [.., ntiles, n_max, T] coefficients of `EllMatrix.prepare()`.
- `slice_spmv_exact` replaces `_kernel_exact` and `_kernel_wide_exact`
  (via `_slice_spmv_exact`): the error-tracked off-diagonal product of
  the df32 residual (solver/refine.py), (y, err) in float32.
- `slice_nbr_values` replaces `_nbr_kernel` (via `_slice_nbr_pallas`)
  and `_nbr_kernel_wide` (via `_slice_nbr_pallas_wide`): the neighbour
  values x[nbr[c, k]] routed through the plan, the own value at slots
  that are not interior faces.

On the card each wrapper launches its kernel of ``csrc/slice_spmv.cu``;
on CPU tensors it runs the plain version beside it. The TPU kernels'
windows, lane rolls, heavy-tail split and 128-row tiles are TPU
workarounds: the CUDA kernels compute the same functions with a loop
bounded by each tile's used slice count (`SlicePlan.tile_nj`), at any
tile width, with the diagonal folded in and no padded copy of x.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from orc_tpu_torch.ops import _cuda
from orc_tpu_torch.ops.df32 import two_prod, two_sum


def slice_spmv_plain(diag, coef, plan, x):
    """orc_tpu's XLA `spmv.slice_spmv`: every slice of the zero-padded x
    gathered as [..., ntiles, n_max, T], times coef, summed over the
    slice columns. x: [..., C]; coef: [..., ntiles, n_max, T] (or shared
    by the batch)."""
    T, C = plan.tile, plan.n_cells
    batch = x.shape[:-1]
    xp = F.pad(x, (plan.pad_lo, plan.pad_hi))
    lanes = torch.arange(T, device=x.device)
    g = xp[..., plan.starts.long()[..., None] + lanes]  # [..., ntiles, n_max, T]
    y_off = torch.sum(coef * g, dim=-2).reshape(*batch, plan.ntiles * T)
    return diag * x + y_off[..., :C]


def _batch_stride(t, row_ndim, B, name):
    """Elements between the batch rows of `t`: 0 when one row is shared
    by the batch, else the row size (t must then hold B rows)."""
    if t.ndim == row_ndim:
        return 0
    if t.ndim != row_ndim + 1 or t.shape[0] != B:
        raise ValueError(
            f"{name} {tuple(t.shape)} is neither shared nor one row per "
            f"batch row of x (B={B})"
        )
    return t[0].numel()


def slice_spmv(diag, coef, plan, x):
    """y = diag * x + sum_j coef[.., t, j, l] * x[starts[t, j] - pad_lo + l]
    over each tile's used columns (reads outside [0, C) are zero).

    x: [C] or [B, C]; diag: [C] or [B, C]; coef: [ntiles, n_max, T] or
    [B, ntiles, n_max, T] (shared by the batch, or one per row). CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if not x.is_cuda:
        return slice_spmv_plain(diag, coef, plan, x)
    dev = x.device
    C, T = plan.n_cells, plan.tile
    if x.ndim not in (1, 2) or x.shape[-1] != C:
        raise ValueError(f"x must be [C] or [B,C] with C={C}, got {tuple(x.shape)}")
    B = 0 if x.ndim == 1 else x.shape[0]
    shape = (plan.ntiles, plan.n_max, T)
    if diag.shape[-1] != C or tuple(coef.shape[-3:]) != shape:
        raise ValueError(
            f"diag {tuple(diag.shape)} / coef {tuple(coef.shape)} do not "
            f"match the plan (C={C}, coef [..., {shape}])"
        )
    d_bs = _batch_stride(diag, 1, B, "diag")
    c_bs = _batch_stride(coef, 3, B, "coef")
    for name, t in (("diag", diag), ("coef", coef)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} {t.dtype} and x {x.dtype} differ")
    _cuda.check_cuda(
        dev, diag=diag, coef=coef, starts=plan.starts, tile_nj=plan.tile_nj
    )
    y = _launch_slice_spmv(
        diag.contiguous(), d_bs, coef.contiguous(), c_bs, plan, x.contiguous(),
        max(B, 1),
    )
    slice_spmv.launches += 1
    return y


def _launch_slice_spmv(diag, d_bs, coef, c_bs, plan, x, B):
    """The kernel launch of `slice_spmv` on checked, contiguous tensors."""
    y = torch.empty_like(x)
    _cuda.call(
        "orc_slice_spmv", x.device, _cuda.dtype_code(x), diag.data_ptr(), d_bs,
        coef.data_ptr(), c_bs, plan.starts.data_ptr(),
        plan.tile_nj.data_ptr(), x.data_ptr(), y.data_ptr(), plan.n_cells,
        plan.tile, plan.ntiles, plan.n_max, plan.pad_lo, B,
    )
    return y


def slice_spmv_exact_plain(coef, plan, x):
    """orc_tpu's `_kernel_exact` / `_kernel_wide_exact` in eager torch:
    over the n_max slice columns in order, the two-product of
    coef[.., t, j, l] and x[starts[t, j] - pad_lo + l] (zero outside
    [0, C)) is two-summed into y and its two error terms added into err.
    x: [C] or [B, C] float32; coef: [ntiles, n_max, T] or [B, ntiles,
    n_max, T]. Returns (y, err), each shaped like x."""
    T, C = plan.tile, plan.n_cells
    batch = x.shape[:-1]
    xp = F.pad(x, (plan.pad_lo, plan.pad_hi))
    lanes = torch.arange(T, device=x.device)
    g = xp[..., plan.starts.long()[..., None] + lanes]  # [..., ntiles, n_max, T]
    coef = coef.expand(g.shape)
    acc = torch.zeros(g.shape[:-2] + (T,), dtype=x.dtype, device=x.device)
    err = torch.zeros_like(acc)
    for j in range(plan.n_max):
        ph, pe = two_prod(coef[..., j, :], g[..., j, :])
        acc, te = two_sum(acc, ph)
        err = err + (te + pe)
    n = plan.ntiles * T
    return (
        acc.reshape(*batch, n)[..., :C],
        err.reshape(*batch, n)[..., :C],
    )


def slice_spmv_exact(coef, plan, x):
    """Error-tracked off-diagonal slice product of the df32 residual:
    (y, err) with y + err the row sums of coef * x over the plan, every
    product an exact two-product and every accumulation an error-free
    two-sum, in slice-column order (no diagonal term).

    x: [C] or [B, C] float32; coef: [ntiles, n_max, T] (shared by the
    batch) or [B, ntiles, n_max, T]. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise. The kernel's (y, err) are
    bitwise equal to the plain version's."""
    if not x.is_cuda:
        return slice_spmv_exact_plain(coef, plan, x)
    dev = x.device
    C, T = plan.n_cells, plan.tile
    if x.ndim not in (1, 2) or x.shape[-1] != C:
        raise ValueError(f"x must be [C] or [B,C] with C={C}, got {tuple(x.shape)}")
    if x.dtype != torch.float32 or coef.dtype != torch.float32:
        raise TypeError(
            f"the exact slice product takes float32 planes, got x {x.dtype}, "
            f"coef {coef.dtype}"
        )
    B = 0 if x.ndim == 1 else x.shape[0]
    shape = (plan.ntiles, plan.n_max, T)
    if tuple(coef.shape[-3:]) != shape:
        raise ValueError(
            f"coef {tuple(coef.shape)} does not match the plan (coef [..., {shape}])"
        )
    c_bs = _batch_stride(coef, 3, B, "coef")
    _cuda.check_cuda(dev, coef=coef, starts=plan.starts, tile_nj=plan.tile_nj)
    out = _launch_slice_spmv_exact(
        coef.contiguous(), c_bs, plan, x.contiguous(), max(B, 1)
    )
    slice_spmv_exact.launches += 1
    return out


def _launch_slice_spmv_exact(coef, c_bs, plan, x, B):
    """The kernel launch of `slice_spmv_exact` on checked, contiguous
    tensors."""
    y = torch.empty_like(x)
    err = torch.empty_like(x)
    _cuda.call(
        "orc_slice_spmv_exact", x.device, coef.data_ptr(), c_bs,
        plan.starts.data_ptr(), plan.tile_nj.data_ptr(), x.data_ptr(),
        y.data_ptr(), err.data_ptr(), plan.n_cells, plan.tile, plan.ntiles,
        plan.n_max, plan.pad_lo, B,
    )
    return y, err


def slice_nbr_values_plain(plan, x, interior):
    """x[c'] at interior slots, c' = starts[t, col_tile[t, k, l]] -
    pad_lo + l with c = t*T + l; x[c] elsewhere. x: [C, *rest];
    interior: [C, K] bool; returns [C, K, *rest]."""
    C, T = plan.n_cells, plan.tile
    c = torch.arange(C, device=x.device)
    t, lane = c // T, c % T
    K = plan.col_tile.shape[1]
    k = torch.arange(K, device=x.device)
    j = plan.col_tile[t[:, None], k[None, :], lane[:, None]].long()
    src = plan.starts[t[:, None], j].long() - plan.pad_lo + lane[:, None]
    return x[torch.where(interior, src, c[:, None])]


def slice_nbr_values(plan, x, interior):
    """Neighbour-cell values [C, K, *rest] of x [C, *rest] over the
    plan; the own value at slots where `interior` [C, K] is False. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if not x.is_cuda:
        return slice_nbr_values_plain(plan, x, interior)
    dev = x.device
    C, T = plan.n_cells, plan.tile
    K = plan.col_tile.shape[1]
    if x.shape[0] != C or tuple(interior.shape) != (C, K):
        raise ValueError(
            f"x {tuple(x.shape)} / interior {tuple(interior.shape)} do not "
            f"match the plan (C={C}, K={K})"
        )
    if interior.dtype != torch.bool:
        raise TypeError(f"interior must be bool, got {interior.dtype}")
    _cuda.check_cuda(
        dev, interior=interior, starts=plan.starts, col_tile=plan.col_tile
    )
    rest = tuple(x.shape[1:])
    out = _launch_slice_nbr(plan, x.reshape(C, -1).contiguous(), interior.contiguous())
    slice_nbr_values.launches += 1
    return out.reshape((C, K) + rest)


def _launch_slice_nbr(plan, flat, interior):
    """The kernel launch of `slice_nbr_values` on checked, contiguous
    tensors: flat [C, F] -> [C, K, F]."""
    C, nf = flat.shape
    K = plan.col_tile.shape[1]
    out = torch.empty((C, K, nf), dtype=flat.dtype, device=flat.device)
    _cuda.call(
        "orc_slice_nbr", flat.device, _cuda.dtype_code(flat), flat.data_ptr(),
        interior.data_ptr(), plan.starts.data_ptr(),
        plan.col_tile.data_ptr(), out.data_ptr(), C, K, nf, plan.tile,
        plan.n_max, plan.pad_lo,
    )
    return out


#: Kernel launches since the last reset (set to 0 to reset).
slice_spmv.launches = 0
slice_spmv_exact.launches = 0
slice_nbr_values.launches = 0
