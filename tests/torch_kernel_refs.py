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
