"""Flux-corrected SIMPLE (`PressureVelocityCoupling.SIMPLE_FC`), port of
the gather-free (c,k) half of orc_tpu/solver/fc.py.

The face fluxes are state (`FlowState.flux`, the outward normal velocity
per (cell, ELL slot) [C,K]). Each iteration:
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
transient `inertia`, the momentum source and the multigrid hierarchy.

Layout: the stored flux and the predictor are kept as [C,K] views of K
contiguous [C] planes (`planes`), the layout the kernels read and
write, so no [C,K] transpose runs between iterations on the card.

Not ported: the face-major step (`face_flux_h`, `simple_step_fc`), which
waits for the face-major SIMPLE step (ROADMAP Queue 1, item 3).
"""

from __future__ import annotations

import torch

from orc_tpu_torch.ops.ck_ops import (
    ck_apply_correction,
    ck_bc,
    ck_face_pressure,
    ck_flux,
    ck_momentum,
    mesh_matrix,
    nbr_values,
)
from orc_tpu_torch.solver import simple
from orc_tpu_torch.utils.settings import (
    PressureCorrectionForm,
    VelocityInterpolation,
)


def planes(x):
    """x [C,K] as a view of K contiguous [C] planes; no copy when x
    already has that layout."""
    return x.T.contiguous().T


_FACE_MAJOR = (
    "the face-major SIMPLE_FC step waits for the face-major SIMPLE step "
    "(ROADMAP Queue 1, item 3); use the (c,k) step"
)


def face_flux_h(mesh, fbc, vel, scheme, p=None, grad_p=None, mom_diag=None):
    raise NotImplementedError(_FACE_MAJOR)


def simple_step_fc(*args, **kwargs):
    raise NotImplementedError(_FACE_MAJOR)


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
    kernel_asm=None,  # (cols, AsmSpec) -> SIMPLE_FC assembly kernels
    maybe_singular: bool = True,
    inertia=None,  # (rv_dt [C], vel_n [C,3]) of a transient step
    mg_hierarchy=None,  # solver/gmg.py levels of MULTIGRID solves
):
    """One flux-corrected SIMPLE iteration in the (c,k) formulation.
    `state.flux` must be seeded (ck_initial_flux); `maybe_singular` is
    the host fact "no pressure zones" (simple.table_has_pressure_bc)."""
    bc = ck_bc(ck, zone_codes, zone_scalar, zone_vector)
    diff_diag, diff_off, diff_b = ck_diff
    vel, p, flux = state.vel, state.p, state.flux
    active = ck.mask.any(dim=1)

    # The kernels read neighbour values themselves: the [C,K(,3)]
    # neighbour tables are built only for the plain ops.
    vel_nbr = None if kernel_asm is not None else nbr_values(mesh, vel, ck.interior)
    grad_p = grad_p_nbr = None
    gp_fn, gv_fn = simple.gradient_fns(settings)
    if simple._needs_grad_p(settings):
        grad_p = gp_fn(mesh, ck, bc, p)
        if kernel_asm is None:
            grad_p_nbr = nbr_values(mesh, grad_p, ck.interior)
    grad_v = (
        gv_fn(mesh, ck, bc, vel, vel_nbr=vel_nbr)
        if simple._needs_grad_vel(settings)
        else None
    )

    if kernel_asm is not None:
        from orc_tpu_torch.ops.fused_assembly import (
            bc_value_table,
            fc_momentum_assembly,
            fc_pc_assembly,
            pack_flags,
        )

        cols, aspec = kernel_asm
        flags = pack_flags(ck.interior, ck.mask)
        bcv = bc_value_table(zone_scalar, zone_vector)
        mdiag, moff, b3 = fc_momentum_assembly(
            vel, p, flux, bcv, flags, cols, rho, mu,
            settings.momentum_relaxation,
            grad_p=grad_p, grad_vel=grad_v, inertia=inertia, spec=aspec,
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

    new_vel, new_mom_diag, info = simple._solve_momentum(
        A3, b3, vel, active, settings, mg_hierarchy
    )
    new_md_c = new_mom_diag.T  # cell-major [C,3] view
    new_md_nbr = nbr_values(mesh, new_md_c, ck.interior)
    if kernel_asm is not None:
        pdiag, poff, b_p, flux_h = fc_pc_assembly(
            new_vel, A3.diag, bcv, flags, cols, rho, grad_p=grad_p, spec=aspec
        )
        Pmat = mesh_matrix(mesh, pdiag, poff)
        # d for the conservative correction, recomputed from the shared
        # momentum diagonal as orc_tpu does: it may differ from the
        # kernel's matrix coefficients by an ulp, which perturbs
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
    p_new, p_info = simple._solve_p_prime(
        Pmat, b_p, p, settings, active, maybe_singular, x0=p,
        mg_hierarchy=mg_hierarchy,
    )
    p_new_nbr = nbr_values(mesh, p_new, ck.interior)
    new_flux = ck_correct_flux(mesh, ck, bc, flux_h, d_ck, rho, p_new, p_new_nbr)
    # Stored-flux under-relaxation: a blend of two conservative fluxes,
    # alpha-consistent with the explicit velocity correction.
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
        mesh, ck, bc, s_corr, dp, new_md_c, new_vel, p
    )
    metrics = simple._step_metrics(
        active, vel3, pe, p_corr_sq, vel_corr_sq, info, p_info
    )
    new_state = simple.FlowState(
        vel=vel3, p=p_out, mom_diag=new_mom_diag, flux=new_flux
    )
    return new_state, metrics
