"""Flux-corrected SIMPLE (`PressureVelocityCoupling.SIMPLE_FC`), port of
orc_tpu/solver/fc.py: the face-major step
(`simple_step_fc`) and the gather-free (c,k) one (`ck_simple_step_fc`).

The face fluxes are state (`FlowState.flux`: the owner-outward normal
velocity per face [F] on the face-major step, the outward normal
velocity per (cell, ELL slot) [C,K] on the (c,k) step). Each iteration:
- momentum advects with last iteration's corrected, conservative flux;
- the pressure equation solves for the full p (warm-started from p),
  assembled from the flux predictor `flux_h`: the Rhie-Chow flux
  without its compact pressure-difference term, which the equation
  re-adds with the new p;
- the stored flux is corrected with the unrelaxed new p through exactly
  the matrix coefficients, so div(flux) equals the linear-solve
  residual every iteration;
- p is relaxed where the next momentum solve reads it, and the cell
  velocities get the face-value correction of the relaxed increment.

orc_tpu's module docstring gives the derivation and the stability
findings. On a CUDA mesh the step runs the SIMPLE_FC assembly kernels
(`fc_momentum_assembly`, `fc_pc_assembly`) where orc_tpu runs their
Pallas counterparts, behind the same gate (solver/simple.py
`_kernel_asm_spec(..., fc=True)`). Like the parity step it takes the
transient `inertia`, the momentum source, the solver extras and the
communication context `comm` of sharded runs (a partition's stored flux
is its own: it is indexed by its local faces or (cell, slot) pairs).

Layout: on the (c,k) step the stored flux and the predictor are kept as
[C,K] views of K contiguous [C] planes (`planes`), the layout the
kernels read and write, so no [C,K] transpose runs between iterations
on the card. The face-major step assembles in plain ops, as orc_tpu's
does, but for the momentum assembly of the shared-matrix schemes, which
runs in one hand-written kernel on the card (`simple.face_momentum`),
and solves through the same kernels.
"""

from __future__ import annotations

import torch

from orc_tpu_torch.ops.assembly import (
    _gathered,
    _normal_momentum_coeff,
    apply_pressure_correction,
)
from orc_tpu_torch.ops.ck_ops import (
    ck_apply_correction,
    ck_bc,
    ck_face_pressure,
    ck_flux,
    ck_momentum,
    mesh_matrix,
    nbr_values,
    planes,
)
from orc_tpu_torch.ops.fields import (
    INTERIOR,
    PRESSURE_INLET,
    PRESSURE_OUTLET,
    SYMMETRY,
    VELOCITY_INLET,
    WALL,
    face_bc,
)
from orc_tpu_torch.ops.gradients import pressure_gradient, velocity_gradient
from orc_tpu_torch.ops.interpolation import _dot, face_flux
from orc_tpu_torch.solver import simple
from orc_tpu_torch.utils.profiling import span
from orc_tpu_torch.utils.settings import (
    PressureCorrectionForm,
    VelocityInterpolation,
)


def face_flux_h(mesh, fbc, vel, scheme, p=None, grad_p=None, mom_diag=None):
    """Flux predictor [F] of the p-form pressure equation: the face
    normal velocity without the compact pressure-difference term. For
    LINEAR / LINEAR_WEIGHTED it is face_flux; for RHIE_CHOW 0.5 (term1 +
    term3) of face_flux's formula (term2 is what the pressure equation's
    flux correction re-adds with the new p). Boundary faces keep
    face_flux's rules."""
    if scheme in (
        VelocityInterpolation.LINEAR,
        VelocityInterpolation.LINEAR_WEIGHTED,
    ):
        return face_flux(mesh, fbc, vel, scheme)
    if scheme != VelocityInterpolation.RHIE_CHOW:
        raise NotImplementedError(f"SIMPLE_FC with {scheme}")
    if p is None or grad_p is None or mom_diag is None:
        raise ValueError("Rhie-Chow flux_h requires p, grad_p, mom_diag")
    n = mesh.face_normal
    own_i = mesh.face_owner.long()
    nbr_i = mesh.face_neighbor.long()
    v_own = vel[own_i]
    a_i = torch.linalg.vector_norm(mom_diag[own_i] * n, dim=1)
    a_j = torch.linalg.vector_norm(mom_diag[nbr_i] * n, dim=1)
    voa_i = mesh.cell_volume[own_i] / a_i
    voa_j = mesh.cell_volume[nbr_i] / a_j
    term1 = _dot(v_own + vel[nbr_i], n)
    gsum = voa_i[:, None] * grad_p[own_i] + voa_j[:, None] * grad_p[nbr_i]
    term3 = _dot(gsum, mesh.face_r_on) / mesh.face_dist_on
    interior = 0.5 * (term1 + term3)
    boundary_vn = torch.where(
        fbc.is_(VELOCITY_INLET),
        _dot(fbc.vector, n),
        _dot(v_own, n),  # pressure inlet / outlet
    )
    zero = torch.zeros((), dtype=interior.dtype, device=interior.device)
    return torch.where(
        fbc.is_(WALL, SYMMETRY),
        zero,
        torch.where(fbc.is_(INTERIOR), interior, boundary_vn),
    )


def _face_d_coeffs(mesh, fbc, rho, mom_diag):
    """Per-face pressure-coupling coefficients of the flux model (mass
    flow per pressure): interior d = 0.5 rho A (V_i/a_i + V_j/a_j)/dist,
    the Rhie-Chow damping coefficient; pressure boundaries the one-sided
    d = rho A (V_c/a_c)/dist_fo; prescribed-flux boundaries 0."""
    n = mesh.face_normal
    own_i = mesh.face_owner.long()
    nbr_i = mesh.face_neighbor.long()
    a_i = _normal_momentum_coeff(mom_diag[own_i], n)
    a_j = _normal_momentum_coeff(mom_diag[nbr_i], n)
    voa_i = mesh.cell_volume[own_i] / a_i
    voa_j = mesh.cell_volume[nbr_i] / a_j
    A = mesh.face_area
    d_int = 0.5 * rho * A * (voa_i + voa_j) / mesh.face_dist_on
    d_bnd = rho * A * voa_i / mesh.face_dist_fo
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    is_p = fbc.is_(PRESSURE_INLET, PRESSURE_OUTLET)
    return torch.where(fbc.is_(INTERIOR), d_int, torch.where(is_p, d_bnd, zero))


def fc_pressure_system(mesh, fbc, rho, flux_h, d_face):
    """Full-p continuity system A p = b from the flux predictor; row c:
    sum_int d_f (p_c - p_nb) + sum_pf d_b (p_c - p_BC)
    = - sum_f sgn flux_h A rho. Prescribed-flux faces add nothing to the
    matrix; a domain without pressure BCs is singular (solved
    deflated)."""
    cf, m, (code, scalar, _), area, interior = _gathered(mesh, fbc)
    sgn = mesh.cell_face_sign
    zero = torch.zeros((), dtype=area.dtype, device=area.device)
    one = torch.ones((), dtype=area.dtype, device=area.device)
    d_ck = d_face[cf]
    is_p = ((code == PRESSURE_INLET) | (code == PRESSURE_OUTLET)) & m
    b = torch.sum(torch.where(m, -sgn * flux_h[cf] * area * rho, zero), dim=1)
    b = b + torch.sum(torch.where(is_p, d_ck * scalar, zero), dim=1)
    diag = torch.sum(torch.where(interior | is_p, d_ck, zero), dim=1)
    active = m.any(dim=1)
    diag = torch.where(active, diag, one)
    b = torch.where(active, b, zero)
    off = torch.where(interior, -d_ck, zero)
    return mesh_matrix(mesh, diag, planes(off)), b


def correct_flux(mesh, fbc, flux_h, d_face, rho, p_new):
    """Conservative flux update [F] with the unrelaxed new p:
    div(corrected flux) == b - A p_new, the linear-solve residual."""
    p_own = p_new[mesh.face_owner.long()]
    dv = d_face / (rho * torch.clamp(mesh.face_area, min=1e-300))
    delta = torch.where(
        fbc.is_(INTERIOR),
        p_own - p_new[mesh.face_neighbor.long()],
        p_own - fbc.scalar,  # d_face is 0 except at pressure faces
    )
    return flux_h + dv * delta


def simple_step_fc(
    mesh,
    zone_codes,
    zone_scalar,
    zone_vector,
    settings,
    rho,
    mu,
    diff,
    state,
    solver_extras=None,
    comm=None,
    inertia=None,
    maybe_singular: bool = True,
):
    """One flux-corrected SIMPLE iteration in the face-major formulation
    (orc_tpu's `simple_step_fc`). `state.flux` [F] must be seeded
    (simple.initial_flux); `maybe_singular` is the host fact "no
    pressure zones" (simple.table_has_pressure_bc); `solver_extras` is
    orc_tpu's: the colouring of GAUSS_SEIDEL runs, the hierarchy of
    MULTIGRID ones; `comm` the communication context."""
    comm = comm or simple.NullComm()
    with span("orc.gradients"):
        fbc = face_bc(mesh, zone_codes, zone_scalar, zone_vector)
        active = mesh.cell_face_mask.any(dim=1)
        vel = comm.refresh(state.vel)
        p = comm.refresh(state.p)
        flux = state.flux

        grad_p = (
            comm.refresh(
                pressure_gradient(mesh, fbc, p, settings.gradient_reconstruction)
            )
            if simple._needs_grad_p(settings)
            else None
        )
        grad_v = (
            comm.refresh(
                velocity_gradient(mesh, fbc, vel, settings.gradient_reconstruction)
            )
            if simple._needs_grad_vel(settings)
            else None
        )
    with span("orc.momentum_assembly"):
        A3, b3, pe = simple.face_momentum(
            mesh, fbc, settings, rho, vel, flux, p, diff, active, grad_p=grad_p,
            grad_vel=grad_v, inertia=inertia,
        )
    with span("orc.momentum_solve"):
        new_vel, new_mom_diag, info = simple._solve_momentum(
            A3, b3, vel, active, settings, solver_extras, comm
        )
    new_md_c = new_mom_diag.T

    # The pressure equation from the flux predictor (the full p).
    with span("orc.pressure_assembly"):
        flux_h = face_flux_h(
            mesh, fbc, new_vel, settings.velocity_interpolation,
            p=p, grad_p=grad_p, mom_diag=new_md_c,
        )
        d_face = _face_d_coeffs(mesh, fbc, rho, new_md_c)
        Pmat, b_p = fc_pressure_system(mesh, fbc, rho, flux_h, d_face)
    with span("orc.pressure_solve"):
        p_new, p_info = simple._solve_p_prime(
            Pmat, b_p, p, settings, active, comm, solver_extras, maybe_singular,
            x0=p,
        )

    with span("orc.correction"):
        # Conservative stored flux from the unrelaxed p_new, blended with
        # the previous one under explicit relaxation (both are
        # divergence-free).
        new_flux = correct_flux(mesh, fbc, flux_h, d_face, rho, p_new)
        beta_f = settings.resolved_fc_flux_relaxation()
        if beta_f != 1.0:
            new_flux = flux + beta_f * (new_flux - flux)

        # Relaxed pressure and the face-value velocity correction of the
        # relaxed increment (what the next momentum solve sees).
        dp = (p_new - p) * settings.pressure_relaxation
        s_corr = settings.replace(
            pressure_relaxation=1.0,
            pressure_correction_form=PressureCorrectionForm.FACE_VALUE,
        )
        vel3, p_out, (p_corr_sq, vel_corr_sq) = apply_pressure_correction(
            mesh, fbc, s_corr, comm.refresh(dp), new_md_c, new_vel, p
        )
    with span("orc.step_metrics"):
        metrics = simple._step_metrics(
            active, vel3, pe, p_corr_sq, vel_corr_sq, info, p_info, comm
        )
    new_state = simple.FlowState(
        vel=vel3, p=p_out, mom_diag=new_mom_diag, flux=new_flux
    )
    return new_state, metrics


def ck_flux_h(
    mesh, ck, bc, vel, scheme,
    p=None, grad_p=None, grad_p_nbr=None, mom_diag=None, mom_diag_nbr=None,
    vel_nbr=None,
):
    """[C,K] flux predictor: ck_flux without the Rhie-Chow compact
    term2. Both (c,k) images of an interior face evaluate commutative
    expressions against opposite normals, so they are exact negations."""
    if scheme in (
        VelocityInterpolation.LINEAR,
        VelocityInterpolation.LINEAR_WEIGHTED,
    ):
        return ck_flux(mesh, ck, bc, vel, scheme, vel_nbr=vel_nbr)
    if scheme != VelocityInterpolation.RHIE_CHOW:
        raise NotImplementedError(f"SIMPLE_FC with {scheme}")
    v_c = vel[:, None, :]
    v_n = vel_nbr if vel_nbr is not None else nbr_values(mesh, vel, ck.interior)
    md_n = (
        mom_diag_nbr if mom_diag_nbr is not None
        else nbr_values(mesh, mom_diag, ck.interior)
    )
    n_out = ck.n_out
    a_c = torch.sqrt(torch.sum((mom_diag[:, None, :] * n_out) ** 2, dim=-1))
    a_n = torch.sqrt(torch.sum((md_n * n_out) ** 2, dim=-1))
    vol = mesh.cell_volume
    voa_c = vol[:, None] / a_c
    voa_n = nbr_values(mesh, vol, ck.interior) / a_n
    gp_n = (
        grad_p_nbr if grad_p_nbr is not None
        else nbr_values(mesh, grad_p, ck.interior)
    )
    term1 = torch.sum((v_c + v_n) * n_out, dim=-1)
    gsum = voa_c[..., None] * grad_p[:, None, :] + voa_n[..., None] * gp_n
    term3 = torch.sum(gsum * ck.r_on, dim=-1) / ck.dist_on
    interior = 0.5 * (term1 + term3)
    bnd = torch.where(
        bc.is_vel_inlet,
        torch.sum(bc.vector * n_out, dim=-1),
        torch.sum(v_c * n_out, dim=-1),  # pressure BCs
    )
    zero = torch.zeros((), dtype=vel.dtype, device=vel.device)
    return torch.where(
        bc.is_wall_like,
        zero,
        torch.where(ck.interior, interior, torch.where(ck.mask, bnd, zero)),
    )


def ck_d_coeffs(mesh, ck, bc, rho, mom_diag, mom_diag_nbr=None):
    """[C,K] pressure-coupling coefficients of the flux model (mass flow
    per pressure): interior d = 0.5 rho A (V_c/a_c + V_n/a_n) / dist_on,
    the Rhie-Chow damping coefficient; pressure boundaries the one-sided
    d = rho A (V_c/a_c) / dist_fo; prescribed-flux boundaries 0.
    Symmetric across each interior face."""
    md_n = (
        mom_diag_nbr if mom_diag_nbr is not None
        else nbr_values(mesh, mom_diag, ck.interior)
    )
    n_out = ck.n_out
    one = torch.ones((), dtype=mom_diag.dtype, device=mom_diag.device)
    zero = torch.zeros((), dtype=mom_diag.dtype, device=mom_diag.device)
    a_c = torch.sqrt(torch.sum((mom_diag[:, None, :] * n_out) ** 2, dim=-1))
    a_n = torch.sqrt(torch.sum((md_n * n_out) ** 2, dim=-1))
    vol = mesh.cell_volume
    voa_c = vol[:, None] / torch.where(ck.mask, a_c, one)
    voa_n = nbr_values(mesh, vol, ck.interior) / torch.where(ck.mask, a_n, one)
    d_int = 0.5 * rho * ck.area * (voa_c + voa_n) / ck.dist_on
    d_bnd = rho * ck.area * voa_c / ck.dist_fo
    return torch.where(
        ck.interior, d_int, torch.where(bc.is_pressure, d_bnd, zero)
    )


def ck_fc_pressure_system(mesh, ck, bc, rho, flux_h, d_ck):
    """Full-p continuity system A p = b from the flux predictor; row c:
    sum_int d (p_c - p_nb) + sum_pressure d (p_c - p_BC)
    = -sum_k flux_h A rho. Prescribed-flux faces add nothing to the
    matrix; a domain without pressure BCs is singular (solved
    deflated)."""
    zero = torch.zeros((), dtype=flux_h.dtype, device=flux_h.device)
    one = torch.ones((), dtype=flux_h.dtype, device=flux_h.device)
    b = torch.sum(torch.where(ck.mask, -flux_h * ck.area * rho, zero), dim=1)
    b = b + torch.sum(torch.where(bc.is_pressure, d_ck * bc.scalar, zero), dim=1)
    diag = torch.sum(torch.where(ck.interior | bc.is_pressure, d_ck, zero), dim=1)
    active = ck.mask.any(dim=1)
    diag = torch.where(active, diag, one)
    b = torch.where(active, b, zero)
    off = torch.where(ck.interior, -d_ck, zero)
    return mesh_matrix(mesh, diag, off), b


def ck_correct_flux(mesh, ck, bc, flux_h, d_ck, rho, p_new, p_new_nbr):
    """Conservative [C,K] flux from the predictor and the unrelaxed new
    p (the planes layout of `flux_h` carries over)."""
    delta = torch.where(
        ck.interior,
        p_new[:, None] - p_new_nbr,
        p_new[:, None] - bc.scalar,  # d_ck is 0 except at pressure faces
    )
    one = torch.ones((), dtype=flux_h.dtype, device=flux_h.device)
    zero = torch.zeros((), dtype=flux_h.dtype, device=flux_h.device)
    dv = d_ck / (rho * torch.where(ck.mask, ck.area, one))
    return planes(flux_h + torch.where(ck.mask, dv * delta, zero))


def ck_initial_flux(mesh, ck, bc, settings, state):
    """Seed FlowState.flux [C,K] (planes layout) for a SIMPLE_FC run:
    the interpolated face flux of the starting fields."""
    grad_p = None
    if simple._needs_grad_p(settings):
        grad_p = simple.gradient_fns(settings)[0](mesh, ck, bc, state.p)
    return planes(
        ck_flux(
            mesh, ck, bc, state.vel, settings.velocity_interpolation,
            p=state.p, grad_p=grad_p, mom_diag=state.mom_diag.T,
        )
    )


def ck_simple_step_fc(
    mesh,
    ck,
    zone_codes,
    zone_scalar,
    zone_vector,
    settings,
    rho,
    mu,
    ck_diff,
    state,
    solver_extras=None,  # orc_tpu's: colouring or multigrid hierarchy
    inertia=None,  # (rv_dt [C], vel_n [C,3]) of a transient step
    comm=None,
    kernel_asm=None,  # (cols, AsmSpec[, box]) -> SIMPLE_FC assembly kernels
    maybe_singular: bool = True,
):
    """One flux-corrected SIMPLE iteration in the (c,k) formulation.
    `state.flux` must be seeded (ck_initial_flux); `maybe_singular` is
    the host fact "no pressure zones" (simple.table_has_pressure_bc);
    `comm` and the box in `kernel_asm` as in simple.ck_simple_step."""
    comm = comm or simple.NullComm()
    diff_diag, diff_off, diff_b = ck_diff
    with span("orc.gradients"):
        bc = ck_bc(ck, zone_codes, zone_scalar, zone_vector)
        vel = comm.refresh(state.vel)
        p = comm.refresh(state.p)
        flux = state.flux
        active = ck.mask.any(dim=1)

        # The kernels read neighbour values themselves: the [C,K(,3)]
        # neighbour tables are built only for the plain ops.
        vel_nbr = None if kernel_asm is not None else nbr_values(mesh, vel, ck.interior)
        grad_p = grad_p_nbr = None
        gp_fn, gv_fn = simple.gradient_fns(settings)
        if simple._needs_grad_p(settings):
            grad_p = comm.refresh(gp_fn(mesh, ck, bc, p))
            if kernel_asm is None:
                grad_p_nbr = nbr_values(mesh, grad_p, ck.interior)
        grad_v = (
            comm.refresh(gv_fn(mesh, ck, bc, vel, vel_nbr=vel_nbr))
            if simple._needs_grad_vel(settings)
            else None
        )

    with span("orc.momentum_assembly"):
        if kernel_asm is not None:
            from orc_tpu_torch.ops.fused_assembly import (
                bc_value_table,
                fc_momentum_assembly,
                fc_pc_assembly,
                pack_flags,
            )

            cols, aspec, box = simple._unpack_kernel_asm(kernel_asm)
            flags = pack_flags(ck.interior, ck.mask)
            bcv = bc_value_table(zone_scalar, zone_vector)
            mdiag, moff, b3 = fc_momentum_assembly(
                vel, p, flux, bcv, flags, cols, rho, mu,
                settings.momentum_relaxation,
                grad_p=grad_p, grad_vel=grad_v, inertia=inertia, spec=aspec,
                box=box,
            )
            b3 = simple._add_momentum_source(mesh, settings, b3, active)
            A3 = mesh_matrix(mesh, mdiag, moff)
            pe = simple._kernel_peclet(settings, mdiag, diff_diag, active, inertia)
        else:
            F = flux * ck.area * rho
            p_f = ck_face_pressure(
                mesh, ck, bc, p, settings.pressure_interpolation,
                grad_p=grad_p, grad_p_nbr=grad_p_nbr,
            )
            A3, b3, pe = ck_momentum(
                mesh, ck, bc, settings, rho, vel, F, p_f,
                diff_diag, diff_off, diff_b, grad_vel=grad_v, vel_nbr=vel_nbr,
                inertia=inertia,
            )

    with span("orc.momentum_solve"):
        new_vel, new_mom_diag, info = simple._solve_momentum(
            A3, b3, vel, active, settings, solver_extras, comm
        )
    with span("orc.pressure_assembly"):
        new_md_c = new_mom_diag.T  # cell-major [C,3] view
        new_md_nbr = nbr_values(mesh, new_md_c, ck.interior)
        if kernel_asm is not None:
            pdiag, poff, b_p, flux_h = fc_pc_assembly(
                new_vel, new_mom_diag[0], bcv, flags, cols, rho, grad_p=grad_p,
                spec=aspec, box=box,
            )
            Pmat = mesh_matrix(mesh, pdiag, poff)
            # d for the conservative correction, recomputed from the
            # shared momentum diagonal as orc_tpu does: it may differ from
            # the kernel's matrix coefficients by an ulp, which perturbs
            # div(flux) at rounding scale only.
            d_ck = ck_d_coeffs(mesh, ck, bc, rho, new_md_c, new_md_nbr)
        else:
            new_vel_nbr = nbr_values(mesh, new_vel, ck.interior)
            flux_h = ck_flux_h(
                mesh, ck, bc, new_vel, settings.velocity_interpolation,
                p=p, grad_p=grad_p, grad_p_nbr=grad_p_nbr,
                mom_diag=new_md_c, mom_diag_nbr=new_md_nbr, vel_nbr=new_vel_nbr,
            )
            d_ck = ck_d_coeffs(mesh, ck, bc, rho, new_md_c, new_md_nbr)
            Pmat, b_p = ck_fc_pressure_system(mesh, ck, bc, rho, flux_h, d_ck)
    with span("orc.pressure_solve"):
        p_new, p_info = simple._solve_p_prime(
            Pmat, b_p, p, settings, active, comm, solver_extras, maybe_singular,
            x0=p,
        )
    with span("orc.correction"):
        p_new_nbr = nbr_values(mesh, p_new, ck.interior)
        new_flux = ck_correct_flux(mesh, ck, bc, flux_h, d_ck, rho, p_new, p_new_nbr)
        # Stored-flux under-relaxation: a blend of two conservative
        # fluxes, alpha-consistent with the explicit velocity correction.
        beta_f = settings.resolved_fc_flux_relaxation()
        if beta_f != 1.0:
            new_flux = planes(flux + beta_f * (new_flux - flux))

        # Relaxed pressure and the face-value velocity correction of the
        # relaxed increment (what the next momentum solve sees).
        dp = (p_new - p) * settings.pressure_relaxation
        s_corr = settings.replace(
            pressure_relaxation=1.0,
            pressure_correction_form=PressureCorrectionForm.FACE_VALUE,
        )
        vel3, p_out, (p_corr_sq, vel_corr_sq) = ck_apply_correction(
            mesh, ck, bc, s_corr, comm.refresh(dp), new_md_c, new_vel, p
        )
    with span("orc.step_metrics"):
        metrics = simple._step_metrics(
            active, vel3, pe, p_corr_sq, vel_corr_sq, info, p_info, comm
        )
    new_state = simple.FlowState(
        vel=vel3, p=p_out, mom_diag=new_mom_diag, flux=new_flux
    )
    return new_state, metrics
