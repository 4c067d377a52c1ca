"""Kernel 1: the structured-offset ELL SpMV.

Replaces orc_tpu/ops/pallas_spmv.py `_kernel` (via `shift_spmv`). On
the card `shift_spmv` launches the CUDA kernel of
``csrc/shift_spmv.cu``; on CPU tensors it runs `shift_spmv_plain`, the
torch formulation of orc_tpu's `spmv.ell_spmv` shift branch.

Unlike the TPU kernel (one [C] system, [C,K] coefficients, f32) this
one takes the split-column K-tuple as well as [C,K], a [B,C] batch of
right-hand sides sharing one matrix or, in its per-row instance, each
with its own (diag [B,C], columns [B,C]: the CD2 and in-matrix TVD
momentum systems), and float64.
"""

from __future__ import annotations

import torch

from orc_tpu_torch.ops import _cuda


def shift_spmv_plain(diag, off, offsets, x):
    """y = diag * x + sum_k off[k] * x[i + offsets[k]] with torch.roll
    (each roll writes a copy of x). Wrap-around entries meet the zero
    coefficients the EllMatrix offsets contract guarantees."""
    y = diag * x
    for k, d in enumerate(offsets):
        xk = torch.roll(x, -int(d), dims=-1) if d != 0 else x
        col = off[k] if isinstance(off, tuple) else off[..., k]
        y = y + col * xk
    return y


def shift_spmv(diag, off, offsets, x):
    """y = diag * x + sum_k off[..., k] * x[i + offsets[k]], zero beyond
    the ends.

    diag: [C] shared by every batch row, or [B,C] one row per batch row;
    off: [C,K] / [B,C,K] or a K-tuple of [C] / [B,C] columns (the same
    form as diag); offsets: K ints; x: [C] or [B,C]. CPU tensors take
    the plain version; CUDA tensors launch the kernel (its per-row
    instance for a [B,C] diag) or raise."""
    if not x.is_cuda:
        return shift_spmv_plain(diag, off, offsets, x)
    dev = x.device
    C = x.shape[-1]
    per_row = diag.ndim == 2
    if x.ndim not in (1, 2):
        raise ValueError(f"x must be [C] or [B,C], got {tuple(x.shape)}")
    row = tuple(x.shape) if per_row else (C,)
    if diag.ndim not in (1, 2) or tuple(diag.shape) != row:
        raise ValueError(
            f"shift_spmv kernel takes diag [C] shared by the batch or [B,C] "
            f"one per batch row; got diag {tuple(diag.shape)} for x "
            f"{tuple(x.shape)}"
        )
    cols = off if isinstance(off, tuple) else tuple(
        off[..., k] for k in range(off.shape[-1])
    )
    if len(cols) != len(offsets) or any(
        tuple(c.shape) != row or c.dtype != x.dtype for c in cols
    ):
        raise ValueError(
            f"off must hold one {list(row)} column per offset, x's dtype"
        )
    if diag.dtype != x.dtype:
        raise TypeError(f"diag {diag.dtype} and x {x.dtype} differ")
    _cuda.check_cuda(dev, diag=diag, **{f"off{k}": c for k, c in enumerate(cols)})
    y = _launch_shift_spmv(diag.contiguous(), cols, offsets, x.contiguous())
    if per_row:
        shift_spmv.per_row_launches += 1
    shift_spmv.launches += 1
    return y


def _launch_shift_spmv(diag, cols, offsets, x):
    """The kernel launch of `shift_spmv` on checked tensors: x
    contiguous, diag with unit row stride; the per-row instance for a
    [B,C] diag."""
    y = torch.empty_like(x)
    ptrs, strides, offs = _cuda.column_args(cols, offsets)
    C = x.shape[-1]
    B = 1 if x.ndim == 1 else x.shape[0]
    if diag.ndim == 2:
        _cuda.call(
            "orc_shift_spmv_rows", x.device, _cuda.dtype_code(x),
            diag.data_ptr(), diag.stride(0), ptrs, strides,
            _cuda.batch_strides(cols), offs, len(cols), x.data_ptr(),
            y.data_ptr(), C, B,
        )
    else:
        _cuda.call(
            "orc_shift_spmv", x.device, _cuda.dtype_code(x), diag.data_ptr(),
            ptrs, strides, offs, len(cols), x.data_ptr(), y.data_ptr(), C, B,
        )
    return y


#: Kernel launches since the last reset (set to 0 to reset).
shift_spmv.launches = 0
#: Launches of the per-row instance, counted in `launches` too.
shift_spmv.per_row_launches = 0
