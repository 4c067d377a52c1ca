"""Reference arithmetic of the port's Hopper kernels for their tests
(imports neither JAX nor orc_tpu, so the card's tests can use it)."""

import torch
import torch.nn.functional as F


def slice_spmv_fma_chain(diag, coef, plan, x):
    """The float32 rounding csrc/slice_spmv.cu spells out for y = diag x +
    the slice-plan product: diag * x rounded, then fma(coef, x_slice,
    acc) per used column in order, each fused multiply-add evaluated
    exactly in float64 (a float32 product is exact there) and rounded
    once. x: [C] or [B, C]; diag [C] or [B, C]; coef [ntiles, n_max, T]
    or [B, ntiles, n_max, T]."""
    T, C = plan.tile, plan.n_cells
    xp = F.pad(x, (plan.pad_lo, plan.pad_hi))
    lanes = torch.arange(T, device=x.device)
    g = xp[..., plan.starts.long()[..., None] + lanes]
    coef = coef.expand(g.shape)
    acc = F.pad(diag * x, (0, plan.ntiles * T - C))
    acc = acc.reshape(*x.shape[:-1], plan.ntiles, T)
    used = plan.tile_nj.long()[:, None]
    for j in range(plan.n_max):
        upd = (coef[..., j, :].double() * g[..., j, :].double() + acc.double()).float()
        acc = torch.where(j < used, upd, acc)
    return acc.reshape(*x.shape[:-1], -1)[..., :C]


def shift_spmv_fma_chain(diag, cols, offsets, x):
    """The float32 rounding csrc/shift_spmv.cu spells out for y = diag x
    + sum_k col_k x[i + d_k]: diag * x rounded, then fma(col_k,
    x[i + d_k], acc) per column in order (0 outside [0, C)), each fused
    multiply-add evaluated exactly in float64 and rounded once. diag and
    cols [C] (shared) or [B, C] (per row); x [C] or [B, C]."""
    C = x.shape[-1]
    xp = F.pad(x, (C, C))
    acc = diag * x
    for col, d in zip(cols, offsets):
        xk = xp[..., C + int(d):2 * C + int(d)]
        acc = (col.double() * xk.double() + acc.double()).float()
    return acc


def jacobi_fma_chain(diag, cols, offsets, b, x0, sweeps, relaxation):
    """The float32 rounding csrc/jacobi_sweeps.cu spells out for
    `sweeps` damped-Jacobi sweeps (nvcc's contraction of the first
    design): mv = diag * x rounded, mv = fma(off_k, x[i + d_k], mv) per
    column in order (0 outside [0, C)), ax = fma(-diag, x, mv),
    r = fma(b, 1 / diag, -(ax / diag rounded)), x = fma(x, 1 - w,
    r * w rounded), each fused multiply-add evaluated in float64 (a
    float32 product is exact there) and rounded once. diag, cols [C];
    b, x0 [C] or [B, C]."""
    f32, f64 = torch.float32, torch.float64
    C = diag.shape[-1]
    relax = torch.tensor(relaxation, dtype=f32)
    omr = torch.tensor(1.0 - relaxation, dtype=f32)
    inv_d = 1.0 / diag
    fma = lambda a, b_, c: (a.to(f64) * b_.to(f64) + c.to(f64)).to(f32)  # noqa: E731
    x = x0
    for _ in range(sweeps):
        xp = F.pad(x, (C, C))
        mv = diag * x
        for col, d in zip(cols, offsets):
            mv = fma(col, xp[..., C + int(d):2 * C + int(d)], mv)
        ax = fma(-diag, x, mv)
        r = fma(b, inv_d, -(ax * inv_d))
        x = fma(x, omr, r * relax)
    return x
