"""Per-level multigrid smoothing (port of the smoother half of
orc_tpu/solver/amg.py).

Ported: `_smooth` (the reference's MULTIGRID_SMOOTHER, Jacobi-
preconditioned BiCGSTAB sweeps per level) and `_coarse_project`, which
the geometric V-cycle of solver/gmg.py runs on every level. The
algebraic hierarchy (`build_hierarchy`, `multigrid_solve`) for meshes
without structured offsets is not ported yet (ROADMAP Queue 1, item 8).
"""

from __future__ import annotations

from orc_tpu_torch.solver.krylov import (
    _no_project,
    bicgstab_solve,
    constant_deflation,
)
from orc_tpu_torch.utils.settings import MatrixSolverSettings


def _smooth(A, b, x0, settings: MatrixSolverSettings, iterations=None,
            project=None):
    """Per-level smoother: Jacobi-preconditioned BiCGSTAB (the
    reference's MULTIGRID_SMOOTHER, linear_algebra.rs:9), for
    `iterations` or else multigrid_smoother_iterations (falling back to
    settings.iterations). `project` is the constant-nullspace deflation
    hook of singular (unanchored) pressure systems."""
    if A.plan is not None:
        A = A.prepare()
    if A.offsets is not None:
        # The cycle keeps `off` as one array for the Galerkin products;
        # the columns are split once per smooth, outside the loop.
        A = A.split_columns()
    Ap, inv_d = A.jacobi_preconditioned()
    return bicgstab_solve(
        Ap,
        b * inv_d,
        x0,
        iterations
        if iterations is not None
        else (settings.multigrid_smoother_iterations or settings.iterations),
        convergence_threshold=settings.relative_convergence_threshold,
        compensated=settings.compensated_f32,
        project=project if project is not None else _no_project,
    )


def _coarse_project(null_scale):
    """Plain-mean constant deflation for the (all-active) coarse levels
    of a V-cycle; None when no deflation was requested. The coarse null
    vector is the constant: the Galerkin product with summing
    restriction and piecewise-constant prolongation gives
    A_c 1_c = R A P 1_c = R A 1_f = 0."""
    if null_scale is None:
        return None
    return constant_deflation(null_scale)
