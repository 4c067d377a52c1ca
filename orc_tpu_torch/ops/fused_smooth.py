"""Kernel 4: damped-Jacobi sweeps over a batch sharing one matrix.

Replaces orc_tpu/ops/pallas_smooth.py `_kernel` (via
`fused_jacobi_sweeps` -> `_fused_batched`), the momentum smoother of
`krylov.jacobi_smooth_solve`. On the card `fused_jacobi_sweeps`
launches the CUDA kernel of ``csrc/jacobi_sweeps.cu`` once per sweep;
on CPU tensors it runs `sweeps_plain`, the torch counterpart of
orc_tpu's `sweeps_xla`.
"""

from __future__ import annotations

import torch

from orc_tpu_torch.ops import _cuda


def sweeps_plain(diag, off, offsets, b, x0, sweeps: int, relaxation):
    """`sweeps` damped-Jacobi sweeps in plain torch, broadcasting over
    any leading batch dims (krylov.jacobi_smooth_solve's loop body)."""
    split = isinstance(off, tuple)
    inv_diag = 1.0 / diag
    b_prime = b * inv_diag

    def mv_off(x):
        y = diag * x
        for k, d in enumerate(offsets):
            xk = torch.roll(x, -int(d), dims=-1) if d != 0 else x
            col = off[k] if split else off[..., k]
            y = y + col * xk
        return y - diag * x

    x = x0
    for _ in range(sweeps):
        x = relaxation * (b_prime - mv_off(x) * inv_diag) + (
            1.0 - relaxation
        ) * x
    return x


def fused_jacobi_sweeps(diag, off, offsets, b, x0, sweeps: int, relaxation):
    """`sweeps` damped-Jacobi sweeps of (diag, off, offsets) on b from
    x0. diag: [C] shared; off: [C,K] or a K-tuple of [C]; b, x0: [C] or
    [B,C]. CPU tensors take the plain version; CUDA tensors launch the
    kernel (one launch per sweep, all B components per launch) or
    raise."""
    if not x0.is_cuda:
        return sweeps_plain(diag, off, offsets, b, x0, sweeps, relaxation)
    dev = x0.device
    C = x0.shape[-1]
    if diag.ndim != 1 or diag.shape[0] != C:
        raise ValueError(
            f"fused_jacobi_sweeps kernel takes one [C] diagonal shared by "
            f"the batch; got diag {tuple(diag.shape)} for x0 "
            f"{tuple(x0.shape)}"
        )
    if x0.ndim not in (1, 2) or b.shape != x0.shape:
        raise ValueError(
            f"b and x0 must both be [C] or [B,C]; got {tuple(b.shape)} "
            f"and {tuple(x0.shape)}"
        )
    if not isinstance(relaxation, (int, float)):
        raise TypeError("relaxation must be a Python number")
    if sweeps < 1:
        return x0
    cols = off if isinstance(off, tuple) else tuple(
        off[:, k] for k in range(off.shape[-1])
    )
    if len(cols) != len(offsets) or any(
        c.shape != (C,) or c.dtype != x0.dtype for c in cols
    ):
        raise ValueError("off must hold one [C] column per offset, x0's dtype")
    if diag.dtype != x0.dtype or b.dtype != x0.dtype:
        raise TypeError("diag, b and x0 must share one dtype")
    _cuda.check_cuda(
        dev, diag=diag, b=b, **{f"off{k}": c for k, c in enumerate(cols)}
    )
    diag = diag.contiguous()
    b = b.contiguous()
    x0 = x0.contiguous()
    buf0 = torch.empty_like(x0)
    buf1 = torch.empty_like(x0) if sweeps > 1 else buf0
    ptrs, strides, offs = _cuda.column_args(cols, offsets)
    B = 1 if x0.ndim == 1 else x0.shape[0]
    _cuda.call(
        "orc_jacobi_sweeps", dev, _cuda.dtype_code(x0), diag.data_ptr(),
        ptrs, strides, offs, len(cols), b.data_ptr(), x0.data_ptr(),
        buf0.data_ptr(), buf1.data_ptr(), C, B, int(sweeps),
        float(relaxation),
    )
    fused_jacobi_sweeps.launches += int(sweeps)
    return (buf0, buf1)[(sweeps - 1) % 2]


#: Kernel launches (one per sweep) since the last reset.
fused_jacobi_sweeps.launches = 0
