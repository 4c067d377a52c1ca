"""Mixed-precision iterative refinement: f64-accuracy linear solves from
float32 kernels (port of orc_tpu/solver/refine.py).

    split once:  A = Ah + Al,  b = bh + bl   (float32 hi/lo pairs)
    repeat refine_steps times:
        r  = b - A x          (df32 accuracy ~2^-45: ops/df32.py and the
                               exact slice product, kernel 12)
        d  = solve(Ah, r_hi)  (plain float32: the shift or slice SpMV
                               kernels under the full Krylov machinery)
        x += d                (df32 add)

Each refinement contracts the error by the inner solve's relative
accuracy; the df32 residual sets the attainable limit (~2^-45 kappa).

Opt-in: MatrixSolverSettings.precision = SolverPrecision.DF32_IR on a
float64 system; `krylov.iterative_solve` routes it here.

orc_tpu computes this residual in native f64 on its CPU backend, because
XLA:CPU rewrites the error-free transforms away under jit. Torch runs
every operation eagerly, which keeps them (tests/test_torch_df32.py), so
the port runs the df32 formulation on every device and its CPU tests
exercise the arithmetic the card runs.
"""

from __future__ import annotations

import torch

from orc_tpu_torch.ops.df32 import (
    df_add,
    df_from_f64,
    df_mul,
    df_spmv,
    df_to_f64,
)
from orc_tpu_torch.ops.slice_spmv import slice_spmv, slice_spmv_exact
from orc_tpu_torch.ops.spmv import EllMatrix
from orc_tpu_torch.utils.settings import SolverPrecision


class _DfMatrix:
    """A float64 EllMatrix split into float32 (hi, lo) planes, with a
    df32-accurate matvec for the residuals and the hi-plane float32
    matrix `A32` for the inner solves. A matrix with a slice plan is
    brought into the slice layout once, here, so the inner solves find
    `A32` prepared."""

    def __init__(self, A: EllMatrix):
        if A.plan is not None and not A.slice_layout:
            A = A.prepare()
        off = torch.stack(A.off, dim=-1) if isinstance(A.off, tuple) else A.off
        self.plan = A.plan
        self.offsets = A.offsets
        self.neighbors = A.neighbors
        self.slice_layout = A.slice_layout
        self.diag_h, self.diag_l = df_from_f64(A.diag)
        self.off_h, self.off_l = df_from_f64(off)
        self.A32 = EllMatrix(
            diag=self.diag_h,
            off=self.off_h,
            neighbors=A.neighbors,
            offsets=A.offsets,
            plan=A.plan,
            slice_layout=A.slice_layout,
        )

    def df_matvec(self, xh, xl):
        """(A x) in df32 to first order: the exact hi*hi accumulation,
        the hi*lo and lo*hi cross terms; lo*lo (~2^-48) dropped."""
        if self.slice_layout:
            zero = torch.zeros_like(self.diag_h)
            y1, e1 = slice_spmv_exact(self.off_h, self.plan, xh)
            y2 = slice_spmv(zero, self.off_h, self.plan, xl)
            y3 = slice_spmv(zero, self.off_l, self.plan, xh)
            dh, dl = df_mul(self.diag_h, self.diag_l, xh, xl)
            return df_add(y1, e1 + y2 + y3, dh, dl)
        if self.offsets is not None:
            return df_spmv(
                self.diag_h, self.diag_l, self.off_h, self.off_l,
                self.offsets, xh, xl,
            )
        # Meshes without a plan or offsets: df_spmv's sum over a gather.
        yh, yl = df_mul(self.diag_h, self.diag_l, xh, xl)
        nbr = self.neighbors.long()
        for k in range(nbr.shape[1]):
            ph, pl_ = df_mul(
                self.off_h[..., k], self.off_l[..., k],
                xh[..., nbr[:, k]], xl[..., nbr[:, k]],
            )
            yh, yl = df_add(yh, yl, ph, pl_)
        return yh, yl


def df32_ir_solve(
    A: EllMatrix, b, x0, settings, axis_sum, project, refine_steps: int = 3
):
    """f64-accuracy solve of the float64 system (A, b) by df32 iterative
    refinement with plain float32 inner solves. b, x0: [C] or [B, C];
    `axis_sum` completes the inner solves' and the final norm's sums
    (iterative_solve takes this path on a single device only).
    Returns (x float64, SolveInfo): iterations summed over the
    refinements per batch row, the residual the projected df32 final
    residual's norm (computed in float32, widened to b's dtype)."""
    from orc_tpu_torch.solver.krylov import SolveInfo, iterative_solve

    inner = settings.replace_precision(SolverPrecision.NATIVE)
    M = _DfMatrix(A)
    bh, bl = df_from_f64(b)
    xh, xl = df_from_f64(x0)
    batch = b.shape[:-1]
    it_total = torch.zeros(batch, dtype=torch.int32, device=b.device)
    diverged = torch.zeros(batch, dtype=torch.bool, device=b.device)
    for _ in range(refine_steps):
        axh, axl = M.df_matvec(xh, xl)
        rh, _rl = df_add(bh, bl, -axh, -axl)
        rh = project(rh)
        d, info = iterative_solve(
            M.A32, rh, torch.zeros_like(rh), inner, axis_sum=axis_sum,
            project=project,
        )
        xh, xl = df_add(xh, xl, d, torch.zeros_like(d))
        it_total = it_total + info.iterations
        diverged = diverged | info.diverged
    axh, axl = M.df_matvec(xh, xl)
    rh, _rl = df_add(bh, bl, -axh, -axl)
    rh = project(rh)
    rn = torch.sqrt(axis_sum(torch.sum(rh * rh, dim=-1))).to(b.dtype)
    return df_to_f64(xh, xl), SolveInfo(
        iterations=it_total, residual=rn, diverged=diverged | torch.isnan(rn)
    )
