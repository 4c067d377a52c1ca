"""Lid-driven cavity case (port of orc_tpu/models/cavity.py, single
device): a closed box whose +y wall moves; all-wall BCs."""

from __future__ import annotations

import torch

from orc_tpu_torch.mesh.generate import structured_box_mesh
from orc_tpu_torch.mesh.zones import FaceCondition


def cavity_case(
    n: int = 64,
    nz: int = 1,
    lid_velocity: float = 1.0,
    size: float = 1.0,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
):
    """n x n x nz unit cavity on `device` (the CUDA device unless the
    caller names another); +y wall is the moving lid."""
    mesh, table = structured_box_mesh(
        n, n, nz, lengths=(size, size, size * nz / n), dtype=dtype,
        device=device,
    )
    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(lid_velocity, 0, 0))
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("INLET", FaceCondition.WALL)
    table.set("OUTLET", FaceCondition.WALL)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    return mesh, table


def default_settings():
    """solve_cavity's numerics: UD momentum, LinearWeighted faces,
    implicit relaxation (alpha_u 0.7, alpha_p 0.1), Jacobi-preconditioned
    BiCGSTAB(50) on pressure and the 6-sweep smoother on momentum."""
    from orc_tpu_torch.utils.settings import (
        MatrixSolverSettings,
        MomentumScheme,
        NumericalSettings,
        PreconditionMethod,
        PressureInterpolation,
        RelaxationMode,
        SolutionMethod,
        VelocityInterpolation,
    )

    return NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=50,
            preconditioner=PreconditionMethod.JACOBI,
        ),
        pressure_relaxation=0.1,
        momentum_relaxation=0.7,
        relaxation_mode=RelaxationMode.IMPLICIT,
    )


def flagship_settings():
    """The numerics of orc_tpu's Ghia Re=1000 flagship
    (tests/test_cavity.py): TVD_DC momentum with the UMIST limiter,
    Rhie-Chow face fluxes, LinearWeighted face pressures, implicit
    relaxation (alpha_u 0.6, alpha_p 0.03), Jacobi-preconditioned
    BiCGSTAB(50). AUTO resolves them to SIMPLE_FC."""
    from orc_tpu_torch.utils.settings import (
        MatrixSolverSettings,
        MomentumScheme,
        NumericalSettings,
        PreconditionMethod,
        PressureInterpolation,
        RelaxationMode,
        SolutionMethod,
        VelocityInterpolation,
        tvd_umist,
    )

    return NumericalSettings(
        momentum=MomentumScheme.TVD_DC,
        tvd_psi=tvd_umist,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        pressure_relaxation=0.03,
        momentum_relaxation=0.6,
        relaxation_mode=RelaxationMode.IMPLICIT,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=50,
            preconditioner=PreconditionMethod.JACOBI,
        ),
    )


def solve_cavity(
    n: int = 32,
    reynolds: float = 100.0,
    lid_velocity: float = 1.0,
    iterations: int = 500,
    reporting_interval: int = 100,
    settings=None,
    n_devices: int = 1,
    verbose: bool = True,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
):
    """Solve the cavity at a given Reynolds number (rho = 1,
    mu = U L / Re) on `device` (the CUDA device unless the caller names
    another), sharded over `n_devices` partitions when it is above 1
    (parallel/sharded.py: one per visible card on the card, cut to them;
    n_devices partitions on the CPU). Returns the result state +
    diagnostics."""
    from orc_tpu_torch.solver.simple import initial_state, solve_steady

    settings = settings or default_settings()
    rho = 1.0
    mu = lid_velocity * 1.0 / reynolds
    mesh, table = cavity_case(
        n=n, lid_velocity=lid_velocity, dtype=dtype, device=device
    )
    state = initial_state(mesh)
    if n_devices > 1:
        from orc_tpu_torch.parallel.sharded import solve_steady_sharded

        state, history = solve_steady_sharded(
            mesh, table, settings, rho, mu, state=state,
            iterations=iterations, reporting_interval=reporting_interval,
            n_devices=n_devices, verbose=verbose,
        )
    else:
        state, history = solve_steady(
            mesh, table, settings, rho, mu, state=state,
            iterations=iterations, reporting_interval=reporting_interval,
            verbose=verbose,
        )
    vel = state.vel.cpu().numpy()
    cc = mesh.cell_centroid.cpu().numpy()
    # Centerline profiles (the Ghia-style cuts).
    import numpy as np

    mid_x = np.abs(cc[:, 0] - 0.5) < 0.51 / n
    mid_y = np.abs(cc[:, 1] - 0.5) < 0.51 / n
    return dict(
        mesh=mesh,
        table=table,
        state=state,
        history=history,
        u_centerline=(cc[mid_x, 1], vel[mid_x, 0]),
        v_centerline=(cc[mid_y, 0], vel[mid_y, 1]),
    )
