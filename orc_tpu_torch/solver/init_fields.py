"""Field initialisation: Laplace pressure and potential-flow velocity
(port of orc_tpu/solver/init_fields.py).

The reference's `initialize_flow_new` (solver.rs:354-696) as orc_tpu
redesigned it: classify the boundary conditions, then

- pressure-constrained systems: solve the Laplace equation for p with
  Dirichlet values at pressure boundaries and zero normal gradient at
  walls and symmetry planes (10 Jacobi iterations);
- velocity-constrained systems: solve a potential-flow psi system with
  flux sources at velocity inlets and psi = 0 at pressure outlets (10
  BiCGSTAB iterations), then recover the velocity as the least-squares
  gradient of psi over interior neighbours;
- hybrid systems run both.

`initialize_flow_ramp` is the reference's older diffusion-ramp strategy
(solver.rs:246-352). Both solves go through `iterative_solve`: on the
card the shift SpMV (kernel row 1) on a box, the slice SpMV (row 7) on
an RCM-ordered mesh. The per-cell least-squares solve is
`torch.linalg.solve_ex` on [C, dim, dim] (orc_tpu's `jnp.linalg.solve`),
and orc_tpu's `take` is plain indexing.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from orc_tpu_torch.mesh.compile import CompiledMesh
from orc_tpu_torch.mesh.zones import BoundaryTable, FaceCondition
from orc_tpu_torch.ops.ck_ops import mesh_matrix
from orc_tpu_torch.ops.fields import (
    PRESSURE_INLET,
    PRESSURE_OUTLET,
    VELOCITY_INLET,
    device_bc,
    face_bc,
)
from orc_tpu_torch.solver.krylov import iterative_solve
from orc_tpu_torch.solver.simple import FlowState
from orc_tpu_torch.utils.settings import (
    MatrixSolverSettings,
    PreconditionMethod,
    SolutionMethod,
)


class SystemConstraint(enum.Enum):
    PRESSURE_ONLY = "pressure_only"
    VELOCITY_ONLY = "velocity_only"
    HYBRID = "hybrid"
    # Body-force-driven periodic systems: no pressure or velocity BC
    # constrains the fields. Initialisation falls back to zeros.
    UNCONSTRAINED = "unconstrained"


def check_boundary_conditions(
    mesh: CompiledMesh, table: BoundaryTable, angle_tol_deg: float = 5.0
) -> SystemConstraint:
    """Validate the BC geometry and classify the system (the reference's
    solver.rs:703-770, with the angle tolerance in radians as orc_tpu
    repaired it). Host numpy."""
    normals = mesh.face_normal.cpu().numpy()
    zone_slot = mesh.face_zone_slot.cpu().numpy()
    tol = np.sin(np.deg2rad(angle_tol_deg))

    pressure_bcs = 0
    velocity_bcs = 0
    for zid, fz in table.zones.items():
        slot = table.slot_of_zone[zid]
        faces = zone_slot == slot
        v = np.asarray(fz.vector_value)
        vnorm = np.linalg.norm(v)
        if fz.zone_type == FaceCondition.WALL and vnorm > 0:
            velocity_bcs += 1
            cosines = np.abs(normals[faces] @ (v / vnorm))
            if (cosines > tol).any():
                raise ValueError(
                    f"wall velocity must be tangent to zone '{fz.name}' "
                    f"faces (max |cos| = {cosines.max():.3f})"
                )
        elif fz.zone_type == FaceCondition.VELOCITY_INLET:
            velocity_bcs += 1
            if vnorm == 0:
                raise ValueError(
                    f"velocity inlet zone '{fz.name}' has zero velocity"
                )
            cosines = np.abs(normals[faces] @ (v / vnorm))
            if (cosines < np.cos(np.deg2rad(angle_tol_deg))).any():
                raise ValueError(
                    f"velocity-inlet velocity must be face-normal in zone "
                    f"'{fz.name}' (min |cos| = {cosines.min():.3f})"
                )
        elif fz.zone_type in (
            FaceCondition.PRESSURE_INLET,
            FaceCondition.PRESSURE_OUTLET,
        ):
            pressure_bcs += 1

    if velocity_bcs > 0:
        if pressure_bcs > 1:
            return SystemConstraint.HYBRID
        return SystemConstraint.VELOCITY_ONLY
    if pressure_bcs > 0:
        return SystemConstraint.PRESSURE_ONLY
    if _has_periodic(table):
        return SystemConstraint.UNCONSTRAINED
    raise ValueError("you must set boundary conditions")


def _has_periodic(table: BoundaryTable) -> bool:
    return any(
        fz.zone_type in (FaceCondition.PERIODIC, FaceCondition.PERIODIC_SHADOW)
        for fz in table.zones.values()
    )


def _reciprocal(v):
    """Elementwise reciprocal with 0 -> 0 (reference: lib.rs:246-252)."""
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.where(v != 0.0, 1.0 / torch.where(v == 0.0, 1.0, v), zero)


def _laplace_coeffs(mesh: CompiledMesh):
    """Per-(c,k) interior Laplacian coefficient and its boundary-face
    variant (reference: solver.rs:456-472)."""
    cf = mesh.cell_faces.long()
    sgn = mesh.cell_face_sign[..., None]
    n_out = sgn * mesh.face_normal[cf]
    av = mesh.face_area[cf] / mesh.cell_volume[:, None]
    x_c = mesh.cell_centroid[:, None, :]
    # x_c - x_nbr from the stored owner -> neighbour vectors (periodic
    # wraps see the neighbour's translated image).
    d_int = -sgn * mesh.face_r_on[cf]
    d_bnd = x_c - mesh.face_centroid[cf]
    a_int = torch.sum(_reciprocal(d_int) * n_out, dim=-1) * av
    a_bnd = torch.sum(_reciprocal(d_bnd) * n_out, dim=-1) * av
    return a_int, a_bnd


_INIT_SOLVER_P = MatrixSolverSettings(
    solver_type=SolutionMethod.JACOBI,
    iterations=10,
    relaxation=0.1,
    relative_convergence_threshold=1e-6,
    preconditioner=PreconditionMethod.JACOBI,
)
_INIT_SOLVER_PSI = MatrixSolverSettings(
    solver_type=SolutionMethod.BICGSTAB,
    iterations=10,
    relaxation=0.1,
    relative_convergence_threshold=1e-6,
    preconditioner=PreconditionMethod.JACOBI,
)


def _face_tables(mesh, table):
    """(cell_faces, mask, (code, scalar, vector) per (c,k), interior)."""
    zc, zs, zv = device_bc(table, mesh.dtype, device=mesh.device)
    fbc = face_bc(mesh, zc, zs, zv)
    cf, m = mesh.cell_faces.long(), mesh.cell_face_mask
    return cf, m, fbc.ck(mesh), mesh.face_interior[cf] & m


def initialize_pressure_field(mesh: CompiledMesh, table: BoundaryTable):
    """Solve Laplace(p) = 0 with Dirichlet pressure BCs
    (reference: solver.rs:414-509, 10 Jacobi iterations)."""
    _, m, (code, bc_scalar, _), interior = _face_tables(mesh, table)
    a_int, a_bnd = _laplace_coeffs(mesh)
    zero = torch.zeros((), dtype=a_int.dtype, device=a_int.device)
    is_pbc = ((code == PRESSURE_INLET) | (code == PRESSURE_OUTLET)) & m
    a = torch.where(interior, a_int, torch.where(is_pbc, a_bnd, zero))
    b = torch.sum(torch.where(is_pbc, a_bnd * bc_scalar, zero), dim=1)
    A = mesh_matrix(
        mesh, torch.sum(a, dim=1), torch.where(interior, -a_int, zero)
    )
    p, _ = iterative_solve(A, b, torch.zeros_like(b), _INIT_SOLVER_P)
    return p


def initialize_velocity_field(mesh: CompiledMesh, table: BoundaryTable):
    """Potential-flow velocity (reference: solver.rs:511-696): solve the
    psi system, then u = the least-squares gradient of psi over the
    interior neighbours. Returns (vel [C,3], psi [C])."""
    cf, m, (code, _, bc_vec), interior = _face_tables(mesh, table)
    a_int, a_bnd = _laplace_coeffs(mesh)
    zero = torch.zeros((), dtype=a_int.dtype, device=a_int.device)
    sgn = mesh.cell_face_sign[..., None]
    n_out = sgn * mesh.face_normal[cf]

    is_vin = (code == VELOCITY_INLET) & m
    is_pout = (code == PRESSURE_OUTLET) & m
    a = torch.where(interior, a_int, torch.where(is_pout, a_bnd, zero))
    # Inlet source: the known boundary-normal gradient of psi, scaled by
    # A/V like every other term (the reference omits the scaling).
    av = mesh.face_area[cf] / mesh.cell_volume[:, None]
    src = torch.where(is_vin, -torch.sum(bc_vec * n_out, dim=-1) * av, zero)
    b = torch.sum(src, dim=1)
    A = mesh_matrix(
        mesh, torch.sum(a, dim=1), torch.where(interior, -a_int, zero)
    )
    psi, _ = iterative_solve(A, b, torch.zeros_like(b), _INIT_SOLVER_PSI)

    # Least-squares grad(psi) over interior neighbours only, the z
    # column dropped on 2-D meshes.
    d = torch.where(interior[..., None], sgn * mesh.face_r_on[cf], zero)
    dpsi = torch.where(
        interior, psi[mesh.cell_neighbors.long()] - psi[:, None], zero
    )
    dim = mesh.dim
    dd = d[..., :dim]
    ata = torch.einsum("cka,ckb->cab", dd, dd)
    atb = torch.einsum("cka,ck->ca", dd, dpsi)
    # Ridge regularisation (orc_tpu's): cells whose interior neighbours
    # do not span every direction still recover the spanned components.
    tr = torch.diagonal(ata, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(dim, dtype=ata.dtype, device=ata.device)
    reg = (1e-10 * tr + 1e-300)[:, None, None] * eye
    g = torch.linalg.solve_ex(ata + reg, atb[..., None])[0][..., 0]
    g = torch.nan_to_num(g)
    if dim == 2:
        g = torch.nn.functional.pad(g, (0, 1))
    return g, psi


def initialize_flow(
    mesh: CompiledMesh,
    table: BoundaryTable,
    mu: float,
    rho: float,
    validate: bool = True,
) -> FlowState:
    """BC-aware field initialisation (reference: solver.rs:354-410, with
    Hybrid doing both arms)."""
    constraint = (
        check_boundary_conditions(mesh, table)
        if validate
        else _classify_only(table)
    )
    C, dt, dev = mesh.n_cells, mesh.dtype, mesh.device
    p = torch.zeros((C,), dtype=dt, device=dev)
    vel = torch.zeros((C, 3), dtype=dt, device=dev)
    if constraint in (SystemConstraint.PRESSURE_ONLY, SystemConstraint.HYBRID):
        p = initialize_pressure_field(mesh, table)
    if constraint in (SystemConstraint.VELOCITY_ONLY, SystemConstraint.HYBRID):
        vel, _ = initialize_velocity_field(mesh, table)
    return FlowState(vel=vel, p=p, mom_diag=torch.ones((3, C), dtype=dt, device=dev))


def _classify_only(table: BoundaryTable) -> SystemConstraint:
    p = sum(
        fz.zone_type
        in (FaceCondition.PRESSURE_INLET, FaceCondition.PRESSURE_OUTLET)
        for fz in table.zones.values()
    )
    v = sum(
        fz.zone_type == FaceCondition.VELOCITY_INLET
        or (
            fz.zone_type == FaceCondition.WALL
            and np.linalg.norm(fz.vector_value) > 0
        )
        for fz in table.zones.values()
    )
    if v > 0:
        return SystemConstraint.HYBRID if p > 1 else SystemConstraint.VELOCITY_ONLY
    if p > 0:
        return SystemConstraint.PRESSURE_ONLY
    if _has_periodic(table):
        return SystemConstraint.UNCONSTRAINED
    raise ValueError("you must set boundary conditions")


def initialize_flow_ramp(
    mesh: CompiledMesh,
    table: BoundaryTable,
    mu: float,
    rho: float,
    iterations: int = 200,
) -> FlowState:
    """The reference's older strategy (solver.rs:246-352): initialise the
    pressure, assemble a UD advection system at zero velocity, then solve
    momentum with the matrix blended from pure diffusion to advection +
    diffusion in steps of 0.2 (the u/v/w solves as one [3,C] batch)."""
    from orc_tpu_torch.ops.assembly import diffusion_system, momentum_system
    from orc_tpu_torch.ops.interpolation import face_flux, face_pressure
    from orc_tpu_torch.utils.settings import (
        MomentumScheme,
        NumericalSettings,
        PressureInterpolation,
        VelocityInterpolation,
    )

    zc, zs, zv = device_bc(table, mesh.dtype, device=mesh.device)
    fbc = face_bc(mesh, zc, zs, zv)
    C, dt, dev = mesh.n_cells, mesh.dtype, mesh.device
    p = initialize_pressure_field(mesh, table)
    vel = torch.zeros((C, 3), dtype=dt, device=dev)
    diff = diffusion_system(mesh, fbc, torch.tensor(mu, dtype=dt, device=dev))
    settings = NumericalSettings(
        momentum=MomentumScheme.UD,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
    )
    flux = face_flux(mesh, fbc, vel, VelocityInterpolation.LINEAR_WEIGHTED)
    p_f = face_pressure(mesh, fbc, p, PressureInterpolation.LINEAR_WEIGHTED)
    A3, b3, _ = momentum_system(mesh, fbc, settings, rho, vel, flux, p_f, diff)
    solver = MatrixSolverSettings(
        solver_type=SolutionMethod.BICGSTAB,
        iterations=iterations,
        relaxation=0.5,
        relative_convergence_threshold=1e-6,
        preconditioner=PreconditionMethod.JACOBI,
    )
    sol = vel.T  # [3,C]
    for f in np.arange(1.0, -0.1, -0.2).tolist():
        # UD assembly returns the shared-matrix form ([C] / [C,K]).
        blend = A3.with_values(
            (1.0 - f) * A3.diag + f * diff.diag, (1.0 - f) * A3.off + f * diff.off
        )
        sol, _ = iterative_solve(blend, b3, sol, solver)
    return FlowState(
        vel=sol.T, p=p, mom_diag=torch.ones((3, C), dtype=dt, device=dev)
    )
