"""Iterative sparse solvers over ELL matrices (port of
orc_tpu/solver/krylov.py, single device).

Batched systems are a leading batch dimension written out: the three
momentum systems solve as one [3,C] call, each component with its own
Krylov scalars, `done` flag and iteration count, exactly as orc_tpu's
vmapped loops. A component stops changing once it is done (its update
is masked out), so the host needs to look at the `done` flags only now
and then: the loops check them every `EXIT_CHECK_EVERY` iterations,
which gives the same iterates and counts as checking after every one,
without a device-to-host sync per iteration.

Ported: `SolveInfo`, `constant_deflation`, `jacobi_solve`,
`jacobi_smooth_solve`, `bicgstab_solve`, `gauss_seidel_solve` (multi-
colour, over a colouring from solver/coloring.py), and `iterative_solve`
for every solution method on structured, slice-plan and gather
matrices, with DF32 iterative refinement (`solver/refine.py`) for
float64 systems under `SolverPrecision.DF32_IR`, and MULTIGRID over a
geometric (`solver/gmg.py`, structured boxes) or algebraic
(`solver/amg.py`, any mesh) hierarchy. The sharded hooks of orc_tpu's
solvers (`axis_sum`, `refresh`, `mg_owned`) wait for the sharded runtime
(ROADMAP Queue 1, item 14).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orc_tpu_torch.ops.fused_smooth import fused_jacobi_sweeps
from orc_tpu_torch.ops.spmv import EllMatrix
from orc_tpu_torch.utils.settings import (
    MatrixSolverSettings,
    PreconditionMethod,
    SolutionMethod,
    SolverPrecision,
)

#: Iterations between host checks of the loops' `done` flags.
EXIT_CHECK_EVERY = 8


class SolveInfo(NamedTuple):
    iterations: torch.Tensor  # [...] int32 iterations run per system
    residual: torch.Tensor  # [...] final (preconditioned) residual norm
    diverged: torch.Tensor  # [...] bool: NaN or >1e10 blowup detected


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _wide(v):
    """Double-width view of f32 data for compensated reductions."""
    return v.double() if v.dtype == torch.float32 else v


def _norm_comp(v):
    w = _wide(v)
    return torch.sqrt(torch.sum(w * w, dim=-1)).to(v.dtype)


def _dot_comp(a, b):
    return torch.sum(_wide(a) * _wide(b), dim=-1).to(a.dtype)


def _reducers(compensated: bool):
    """(dot, norm): plain, or f64-accumulated for f32 systems."""
    return (_dot_comp, _norm_comp) if compensated else (_dot, _norm)


def _no_project(x):
    return x


def _where(cond, a, b):
    """torch.where with a per-system condition [...] broadcast over the
    trailing cell axis of [..., C] operands."""
    if a.ndim > cond.ndim:
        cond = cond[..., None]
    return torch.where(cond, a, b)


def _max_abs(x):
    return torch.amax(torch.abs(x), dim=-1)


def constant_deflation(null_scale, active=None):
    """Projection x -> x - null_scale * mean_active(x) removing the
    constant (gauge) mode of an unanchored pressure-correction system.
    `active` [C] bool masks padded rows (None: every row, the plain mean
    of the multigrid coarse levels). 1-D vectors only."""

    def project(x):
        if active is None:
            return x - null_scale * (torch.sum(x, dim=-1) / x.shape[-1])
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        n = torch.sum(active.to(x.dtype))
        mean = torch.sum(torch.where(active, x, zero)) / n
        return x - null_scale * torch.where(active, mean, zero)

    return project


def _exit_check(i: int, done) -> bool:
    return (i + 1) % EXIT_CHECK_EVERY == 0 and bool(done.all())


def jacobi_solve(
    A: EllMatrix, b, x0, iterations: int, relaxation, convergence_threshold,
    compensated: bool = False, project=_no_project,
):
    """Relaxed Jacobi with the reference's convergence semantics: the
    baseline residual is recorded after the second sweep and the loop
    exits when ||r|| / ||r_baseline|| < threshold."""
    _, norm = _reducers(compensated)
    inv_diag = 1.0 / A.diag
    b_prime = b * inv_diag
    batch = b.shape[:-1]
    dev = b.device
    x = x0
    it = torch.zeros(batch, dtype=torch.int32, device=dev)
    base_r = torch.ones(batch, dtype=b.dtype, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    diverged = torch.zeros(batch, dtype=torch.bool, device=dev)
    for i in range(iterations):
        ax_off = A.matvec(x) - A.diag * x
        x_new = relaxation * (b_prime - ax_off * inv_diag) + (
            1.0 - relaxation
        ) * x
        r = norm(b - A.matvec(x_new))
        live = ~done
        base_r = torch.where(live & (it == 1), r, base_r)
        conv = (it >= 2) & (r / base_r < convergence_threshold)
        bad = torch.isnan(r) | (_max_abs(x_new) > 1e10)
        x = _where(done, x, x_new)
        it = it + live.to(torch.int32)
        done = done | (live & (conv | bad))
        diverged = diverged | (live & bad)
        if _exit_check(i, done):
            break
    # Stationary sweeps are neutral in the constant null mode, so one
    # deflation at exit suffices.
    x = project(x)
    rn = norm(project(b - A.matvec(x)))
    return x, SolveInfo(iterations=it, residual=rn, diverged=diverged)


def jacobi_smooth_solve(
    A: EllMatrix, b, x0, iterations: int, relaxation,
    compensated: bool = False, project=_no_project,
):
    """Fixed-count damped Jacobi, the warm-started momentum smoother: no
    residual norm inside, no adaptive exit. On structured matrices the
    sweeps run as kernel 4 on the card (one launch per sweep, all batch
    components per launch); on others, as orc_tpu's sweep loop over the
    matrix's own SpMV (the slice SpMV on irregular meshes)."""
    _, norm = _reducers(compensated)
    if A.offsets is not None:
        x = fused_jacobi_sweeps(
            A.diag, A.off, A.offsets, b, x0, iterations, relaxation
        )
    else:
        inv_diag = 1.0 / A.diag
        b_prime = b * inv_diag
        x = x0
        for _ in range(iterations):
            ax_off = A.matvec(x) - A.diag * x
            x = relaxation * (b_prime - ax_off * inv_diag) + (
                1.0 - relaxation
            ) * x
    x = project(x)
    rn = norm(project(b - A.matvec(x)))
    diverged = torch.isnan(rn) | (_max_abs(x) > 1e10)
    it = torch.full(rn.shape, iterations, dtype=torch.int32, device=rn.device)
    return x, SolveInfo(iterations=it, residual=rn, diverged=diverged)


def bicgstab_solve(
    A: EllMatrix, b, x0, iterations: int, convergence_threshold: float = 1e-14,
    compensated: bool = False, project=_no_project,
):
    """BiCGSTAB with the relative-to-r0 exit (||r|| <= thresh * ||r0||),
    the roundoff floor 64 eps ||b||, the growth cap and the breakdown
    guards of orc_tpu (see its docstring for why each exists): a step
    that breaks down is discarded and the system freezes.

    b, x0: [C] or [B,C]; every scalar below has shape [B] (or []), so
    each system runs its own iteration and exit."""
    dot, norm = _reducers(compensated)
    r0 = project(b - A.matvec(x0))
    r_hat = r0
    rho = dot(r0, r_hat)
    bnorm = norm(b)
    r0norm = norm(r0)
    finfo = torch.finfo(b.dtype)
    tiny = torch.tensor(finfo.tiny, dtype=b.dtype, device=b.device)
    floor = torch.maximum(64.0 * finfo.eps * bnorm, tiny)
    done = r0norm <= floor
    r_cap = 1e6 * (bnorm + r0norm) + tiny
    one = torch.ones((), dtype=b.dtype, device=b.device)

    def safe_div(num, den):
        return num / torch.where(den == 0, one, den)

    x, r, p = x0, r0, r0
    it = torch.zeros(done.shape, dtype=torch.int32, device=b.device)
    if not bool(done.all()):
        for i in range(iterations):
            nu = project(A.matvec(p))
            d_rn = dot(r_hat, nu)
            alpha = safe_div(rho, d_rn)
            h = x + alpha[..., None] * p
            s = r - alpha[..., None] * nu
            t = project(A.matvec(s))
            d_tt = dot(t, t)
            omega = safe_div(dot(t, s), d_tt)
            x_new = h + omega[..., None] * s
            r_new = s - omega[..., None] * t
            rho_new = dot(r_hat, r_new)
            beta = safe_div(rho_new, rho) * safe_div(alpha, omega)
            p_new = r_new + beta[..., None] * (p - omega[..., None] * nu)
            rn_new = norm(r_new)
            breakdown = (
                (torch.abs(d_rn) <= tiny)
                | (d_tt <= tiny)
                | (torch.abs(omega) <= tiny)
                | (torch.abs(rho) <= tiny)
                | (rn_new > r_cap)
                | torch.isnan(rn_new)
            )
            conv = (rn_new <= convergence_threshold * r0norm) | (rn_new <= floor)
            frozen = done | breakdown
            x = _where(frozen, x, x_new)
            r = _where(frozen, r, r_new)
            p = _where(frozen, p, p_new)
            rho = torch.where(frozen, rho, rho_new)
            it = it + (~done).to(torch.int32)
            done = done | conv | breakdown
            if _exit_check(i, done):
                break
    rn = norm(project(b - A.matvec(x)))
    diverged = torch.isnan(rn) | (_max_abs(x) > 1e10)
    return x, SolveInfo(iterations=it, residual=rn, diverged=diverged)


def gauss_seidel_solve(
    A: EllMatrix, b, x0, iterations: int, relaxation, colors, n_colors: int,
    project=_no_project,
):
    """Multi-colour Gauss-Seidel: the rows of one colour update together
    from the latest values of every other colour, one SpMV per colour
    (the shift SpMV on a box, the slice SpMV on a prepared irregular
    matrix). colors: [C] int32 colour of each row (greedy_coloring)."""
    sel = [colors == c for c in range(n_colors)]
    x = x0
    for _ in range(iterations):
        for c in range(n_colors):
            ax_off = A.matvec(x) - A.diag * x
            x_gs = (1.0 - relaxation) * x + relaxation * (b - ax_off) / A.diag
            x = torch.where(sel[c], x_gs, x)
    x = project(x)
    rn = _norm(project(b - A.matvec(x)))
    diverged = torch.isnan(rn) | (_max_abs(x) > 1e10)
    it = torch.full(rn.shape, iterations, dtype=torch.int32, device=rn.device)
    return x, SolveInfo(iterations=it, residual=rn, diverged=diverged)


def iterative_solve(
    A: EllMatrix, b, x0, settings: MatrixSolverSettings, colors=None,
    n_colors: int = 0, mg_hierarchy=None, project=_no_project,
    null_scale=None,
):
    """Solver dispatch (orc_tpu's `iterative_solve`, single device).
    Matrices with a slice plan take the slice-column layout, and
    structured ones are split into their K columns, once, before the
    loop (not under MULTIGRID: its cycle keeps the array form for the
    Galerkin products); Jacobi preconditioning scales the rows by
    1/diag. `colors` / `n_colors` (solver/coloring.greedy_coloring)
    drive GAUSS_SEIDEL; `mg_hierarchy` (solver/gmg.build_mg_hierarchy:
    GmgLevels or amg.MgLevels) drives MULTIGRID; `null_scale` lets its
    coarse levels deflate the constant mode that `project` removes on
    the fine level."""
    method = settings.solver_type
    if (
        settings.precision == SolverPrecision.DF32_IR
        and A.diag.dtype == torch.float64
        and method
        in (
            SolutionMethod.BICGSTAB,
            SolutionMethod.JACOBI,
            SolutionMethod.JACOBI_SMOOTH,
        )
    ):
        # f64 accuracy by df32 iterative refinement: float32 inner solves
        # on the SpMV kernels plus one df32 residual per refinement.
        from orc_tpu_torch.solver.refine import df32_ir_solve

        return df32_ir_solve(
            A, b, x0, settings, project, refine_steps=settings.refine_steps
        )
    if A.plan is not None and method != SolutionMethod.MULTIGRID:
        A = A.prepare()
    if A.offsets is not None and method != SolutionMethod.MULTIGRID:
        A = A.split_columns()
    if settings.preconditioner == PreconditionMethod.JACOBI:
        A, inv_d = A.jacobi_preconditioned()
        b = b * inv_d
    if method == SolutionMethod.JACOBI:
        return jacobi_solve(
            A, b, x0, settings.iterations, settings.relaxation,
            settings.relative_convergence_threshold,
            compensated=settings.compensated_f32, project=project,
        )
    if method == SolutionMethod.JACOBI_SMOOTH:
        return jacobi_smooth_solve(
            A, b, x0, settings.iterations, settings.relaxation,
            compensated=settings.compensated_f32, project=project,
        )
    if method == SolutionMethod.BICGSTAB:
        return bicgstab_solve(
            A, b, x0, settings.iterations,
            convergence_threshold=settings.relative_convergence_threshold,
            compensated=settings.compensated_f32, project=project,
        )
    if method == SolutionMethod.GAUSS_SEIDEL:
        if colors is None:
            raise ValueError(
                "Gauss-Seidel needs a host-precomputed coloring; pass "
                "colors/n_colors (see orc_tpu_torch.solver.coloring)"
            )
        return gauss_seidel_solve(
            A, b, x0, settings.iterations, settings.relaxation, colors,
            n_colors, project=project,
        )
    if method == SolutionMethod.MULTIGRID:
        if mg_hierarchy is None:
            raise ValueError(
                "Multigrid needs a host-built hierarchy; pass mg_hierarchy "
                "(see orc_tpu_torch.solver.gmg.build_mg_hierarchy)"
            )
        from orc_tpu_torch.solver.gmg import GmgLevel, gmg_solve

        if len(mg_hierarchy) and isinstance(mg_hierarchy[0], GmgLevel):
            return gmg_solve(
                A, b, x0, settings, mg_hierarchy, project=project,
                null_scale=null_scale,
            )
        from orc_tpu_torch.solver.amg import multigrid_solve

        return multigrid_solve(
            A, b, x0, settings, mg_hierarchy, project=project,
            null_scale=null_scale,
        )
    raise NotImplementedError(f"solution method {method}")
