"""Finite-volume system assembly of the face-major step as vectorized
[C,K] ops (port of orc_tpu/ops/assembly.py).

Per-face quantities (flux, face pressure) are computed once face-major;
then every (cell, face slot) pair of the padded [C,K] adjacency is
processed elementwise: gathers, `torch.where` selects and masked
reductions over K. There is no scatter, so the bits do not depend on the
order of atomic adds on the card.

Sign bookkeeping: `flux[f]` is owner-outward; the mass flow out of cell
c through slot k is ``F = sign[c,k] * flux[cf[c,k]] * area * rho``.

Layout: the matrices come in the layout the (c,k) step hands the
kernels: a shared off [C,K] over [K,C] storage (`planes`), a per-
component off [3,C,K] over [3,K,C] storage (`component_planes`), so each
column the shift SpMV and the Jacobi sweeps read is a contiguous plane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orc_tpu_torch.ops.ck_ops import (
    _zero_like as _zero,
    component_planes,
    mesh_matrix,
    planes,
)
from orc_tpu_torch.ops.fields import (
    PRESSURE_INLET,
    PRESSURE_OUTLET,
    VELOCITY_INLET,
    WALL,
    FaceBC,
    momentum_source_term,
)
from orc_tpu_torch.utils.settings import (
    MomentumScheme,
    NumericalSettings,
    PressureCorrectionForm,
    RelaxationMode,
)


class DiffusionSystem(NamedTuple):
    """Velocity-independent diffusion contributions, built once
    (reference: discretization.rs:39-131)."""

    diag: torch.Tensor  # [C]
    off: torch.Tensor  # [C,K]
    b: torch.Tensor  # [C,3] Dirichlet-velocity source


def _gathered(mesh, fbc: FaceBC):
    """Common per-(c,k) gathers: (cell_faces, mask, (code, scalar,
    vector) from the zone tables through FaceBC.ck, area, interior)."""
    cf = mesh.cell_faces.long()
    m = mesh.cell_face_mask
    code, scalar, vector = fbc.ck(mesh)
    area = mesh.face_area[cf]
    interior = mesh.face_interior[cf] & m
    return cf, m, (code, scalar, vector), area, interior


def diffusion_system(mesh, fbc: FaceBC, mu) -> DiffusionSystem:
    cf, m, (code, _, bc_vec), area, interior = _gathered(mesh, fbc)
    # Dirichlet-velocity boundaries contribute d = mu A / |x_f - x_c|
    # and a source d v_bc; zero-gradient boundaries (pressure BCs,
    # symmetry) nothing (discretization.rs:69-118).
    zero = _zero(area)
    d_bnd = mu * area / mesh.face_dist_fo[cf]
    d_int = mu * area / mesh.face_dist_on[cf]
    dirichlet = ((code == WALL) | (code == VELOCITY_INLET)) & m
    d = torch.where(interior, d_int, torch.where(dirichlet, d_bnd, zero))
    diag = torch.sum(d, dim=1)
    off = torch.where(interior, -d, zero)
    b = torch.sum(
        torch.where(dirichlet[..., None], d[..., None] * bc_vec, zero), dim=1
    )
    return DiffusionSystem(diag=diag, off=off, b=b)


def momentum_system(
    mesh,
    fbc: FaceBC,
    settings: NumericalSettings,
    rho,
    vel,  # [C,3]
    flux,  # [F] owner-outward normal velocity
    p_face,  # [F]
    diff: DiffusionSystem,
    grad_vel=None,  # [C,3,3], required for TVD, TVD_DC and CD2
    inertia=None,  # (rho V / dt [C], vel_n [C,3]) of transient runs
):
    """The three momentum systems in one pass (reference:
    discretization.rs:133-356). With `inertia` the first-order implicit
    unsteady term rho V/dt (phi - phi_n) is added.

    Returns (EllMatrix: diag [C] and off [C,K] shared by u/v/w under UD,
    CD1 and TVD_DC, or diag [3,C] and off [3,C,K] one per component under
    CD2 and TVD; b [3,C]; the per-cell Peclet array [C,3])."""
    cf, m, (code, _, bc_vec), area, interior = _gathered(mesh, fbc)
    sgn = mesh.cell_face_sign
    F = sgn * flux[cf] * area * rho  # mass flow out of c through slot k
    Fv = F[..., None]
    zero = _zero(F)
    nbr = mesh.cell_neighbors.long()

    scheme = settings.momentum
    s_dc = None  # deferred-correction source (CD2 / TVD_DC)
    if scheme == MomentumScheme.UD:
        a_nb = torch.clamp(F, max=0.0)  # [C,K], shared
    elif scheme == MomentumScheme.CD1:
        a_nb = F / 2.0  # [C,K], shared
    elif scheme == MomentumScheme.CD2:
        # The implicit CD1 stencil plus the explicit deferred correction
        # 0.5 (grad_C . r_Cf + grad_D . r_Df) (orc_tpu's CD2; the
        # reference panics on it).
        if grad_vel is None:
            raise ValueError("CD2 momentum requires grad_vel")
        a_nb = Fv / 2.0 * torch.ones((1, 1, 3), dtype=F.dtype, device=F.device)
        # Cell -> face and neighbour -> face vectors in the cell's own
        # frame, periodic images included (see orc_tpu's comment).
        r_on_face = mesh.face_r_on[cf]
        r_on_ck = sgn[..., None] * r_on_face  # c -> other
        r_f_own = (
            mesh.face_centroid - mesh.cell_centroid[mesh.face_owner.long()]
        )[cf]
        r_cf = torch.where((sgn > 0)[..., None], r_f_own, r_f_own - r_on_face)
        r_df = r_cf - r_on_ck
        g_c = torch.einsum("cij,ckj->cki", grad_vel, r_cf)
        g_d = torch.sum(grad_vel[nbr] * r_df[..., None, :], dim=-1)
        delta = 0.5 * (g_c + g_d)  # [C,K,3]
        s_dc = -torch.sum(torch.where(interior[..., None], Fv * delta, zero), dim=1)
    elif scheme == MomentumScheme.TVD:
        if settings.tvd_psi is None or grad_vel is None:
            raise ValueError("TVD momentum requires tvd_psi and grad_vel")
        psi = settings.tvd_psi
        own = torch.arange(mesh.n_cells, device=F.device)[:, None]
        downstream = torch.where(F > 0, nbr, own)
        diffv = vel[downstream] - vel[:, None, :]
        same = torch.linalg.vector_norm(diffv, dim=-1) == 0.0
        # Cell -> neighbour vector from the stored face geometry.
        r_pa = sgn[..., None] * mesh.face_r_on[cf]
        gdotr = torch.einsum("cij,ckj->cki", grad_vel, r_pa)  # [C,K,3]
        # Components with a zero difference fall back to r = 1 (CD).
        one = torch.ones((), dtype=F.dtype, device=F.device)
        safe = torch.where(diffv == 0.0, one, diffv)
        r = torch.where(diffv == 0.0, one, 2.0 * gdotr / safe - 1.0)
        a_tvd = Fv * psi(r) / 2.0
        a_cd = Fv / 2.0 * torch.ones_like(a_tvd)
        a_ud = torch.clamp(Fv, max=0.0) * torch.ones_like(a_tvd)
        a_nb = torch.where(
            interior[..., None],
            torch.where(same[..., None], a_cd, a_tvd),
            a_ud,  # boundary faces use UD (discretization.rs:235-239)
        )
    elif scheme == MomentumScheme.TVD_DC:
        # The implicit UD matrix plus the explicit limited increment,
        # taken from the upwind side of each face.
        if settings.tvd_psi is None or grad_vel is None:
            raise ValueError("TVD_DC momentum requires tvd_psi and grad_vel")
        psi = settings.tvd_psi
        a_nb = torch.clamp(F, max=0.0)  # [C,K]: the UD matrix, shared
        r_cd = sgn[..., None] * mesh.face_r_on[cf]  # c -> neighbour
        d_cd = vel[nbr] - vel[:, None, :]  # [C,K,3]
        up_is_c = (F > 0)[..., None]
        delta = torch.where(up_is_c, d_cd, -d_cd)  # phi_D - phi_U
        g_c = torch.einsum("cij,ckj->cki", grad_vel, r_cd)
        g_n = torch.sum(grad_vel[nbr] * (-r_cd)[..., None, :], dim=-1)
        gdotr = torch.where(up_is_c, g_c, g_n)  # grad_U . r_UD
        one = torch.ones((), dtype=F.dtype, device=F.device)
        safe = torch.where(delta == 0.0, one, delta)
        r = 2.0 * gdotr / safe - 1.0
        corr = torch.where(delta == 0.0, zero, psi(r) / 2.0 * delta)
        s_dc = -torch.sum(torch.where(interior[..., None], Fv * corr, zero), dim=1)
    else:
        raise NotImplementedError(f"momentum scheme {scheme}")
    shared = a_nb.ndim == 2  # component-independent matrix (UD/CD1/TVD_DC)
    if shared:
        a_nb = torch.where(m, a_nb, zero)
        a_p = torch.sum(torch.where(m, -a_nb + F, zero), dim=1)  # [C]
        a_nb_src = a_nb[..., None]  # for the Dirichlet vector source
    else:
        a_nb = torch.where(m[..., None], a_nb, zero)
        a_p = torch.sum(torch.where(m[..., None], -a_nb + Fv, zero), dim=1)  # [C,3]
        a_nb_src = a_nb

    # Pressure force s_u -= n_out p_f A (discretization.rs:290-291).
    n_out = sgn[..., None] * mesh.face_normal[cf]
    s_u = -torch.sum(
        torch.where(m[..., None], n_out * (p_face[cf] * area)[..., None], zero),
        dim=1,
    )
    # Dirichlet-velocity boundary advection source (a_nb - F) v_bc
    # (discretization.rs:294-307).
    dirichlet = ((code == WALL) | (code == VELOCITY_INLET)) & m & ~interior
    s_u = s_u + torch.sum(
        torch.where(dirichlet[..., None], (a_nb_src - Fv) * bc_vec, zero), dim=1
    )
    if s_dc is not None:
        s_u = s_u + s_dc
    if settings.momentum_source is not None:
        s_u = s_u + momentum_source_term(
            settings.momentum_source, mesh.cell_centroid, mesh.cell_volume
        )

    # Off-diagonals a_nb + the diffusion's at interior slots; diagonal
    # a_p + the diffusion's. Inactive (padded) rows get identity rows.
    active = m.any(dim=1)
    one = torch.ones((), dtype=F.dtype, device=F.device)
    safe_dd = torch.where(active, diff.diag, one)
    if inertia is not None:
        rv_dt, vel_n = inertia
        s_t = rv_dt[:, None] * vel_n
    if shared:
        off = torch.where(interior, a_nb + diff.off, zero)  # [C,K]
        diag = a_p + diff.diag  # [C]
        b = s_u + diff.b  # [C,3]
        if inertia is not None:
            diag = diag + rv_dt
            b = b + s_t
        if settings.relaxation_mode == RelaxationMode.IMPLICIT:
            alpha = settings.momentum_relaxation
            b = b + (1.0 - alpha) / alpha * diag[:, None] * vel
            diag = diag / alpha
        diag = torch.where(active, diag, one)
        b = torch.where(active[:, None], b, zero)
        pe = torch.where(
            active[:, None],
            (a_p / safe_dd)[:, None]
            * torch.ones((1, 3), dtype=a_p.dtype, device=a_p.device),
            zero,
        )
        return mesh_matrix(mesh, diag, planes(off)), b.T, pe

    off = torch.where(interior[..., None], a_nb + diff.off[..., None], zero)  # [C,K,3]
    diag = a_p + diff.diag[:, None]  # [C,3]
    b = s_u + diff.b  # [C,3]
    if inertia is not None:
        diag = diag + rv_dt[:, None]
        b = b + s_t
    if settings.relaxation_mode == RelaxationMode.IMPLICIT:
        alpha = settings.momentum_relaxation
        b = b + (1.0 - alpha) / alpha * diag * vel
        diag = diag / alpha
    diag = torch.where(active[:, None], diag, one)
    b = torch.where(active[:, None], b, zero)
    # "Peclet" per cell and component = a_p / diffusion diagonal
    # (discretization.rs:331-338).
    pe = torch.where(active[:, None], a_p / safe_dd[:, None], zero)
    return (
        mesh_matrix(mesh, diag.T.contiguous(), component_planes(off)),
        b.T,
        pe,
    )


def _normal_momentum_coeff(mom_diag_c, n):
    """|(a_u n_x, a_v n_y, a_w n_z)| (discretization.rs:14-23)."""
    return torch.linalg.vector_norm(mom_diag_c * n, dim=-1)


def pressure_correction_system(
    mesh,
    fbc: FaceBC,
    rho,
    flux,  # [F] recomputed with post-momentum velocities
    mom_diag,  # [C,3] current momentum diagonals
):
    """SIMPLE continuity system (reference: discretization.rs:358-448):
    b the net mass inflow; interior a_nb = rho A^2 / a_face with the
    two-cell averaged normal momentum coefficient. Every boundary face
    adds rho A^2 / a_cell / 2 to the diagonal: the reference's admitted
    guess (discretization.rs:434-436), which orc_tpu keeps for parity
    and the stateless loop's stability leans on (its docstring says
    why), reproduced here as it is."""
    cf, m, _, area, interior = _gathered(mesh, fbc)
    sgn = mesh.cell_face_sign
    zero = _zero(area)
    b = torch.sum(torch.where(m, -sgn * flux[cf] * area * rho, zero), dim=1)

    n = mesh.face_normal[cf]
    md = mom_diag[:, None, :]
    a_c = _normal_momentum_coeff(md, n)  # [C,K]
    a_face = 0.5 * torch.linalg.vector_norm(
        (md + mom_diag[mesh.cell_neighbors.long()]) * n, dim=-1
    )
    a_nb = rho * area**2 / a_face
    a_bnd = rho * area**2 / a_c / 2.0
    active = m.any(dim=1)
    one = torch.ones((), dtype=area.dtype, device=area.device)
    diag = torch.sum(
        torch.where(interior, a_nb, torch.where(m, a_bnd, zero)), dim=1
    )
    diag = torch.where(active, diag, one)
    b = torch.where(active, b, zero)
    off = torch.where(interior, -a_nb, zero)
    return mesh_matrix(mesh, diag, planes(off)), b


def apply_pressure_correction(
    mesh,
    fbc: FaceBC,
    settings: NumericalSettings,
    p_prime,  # [C]
    mom_diag,  # [C,3]
    vel,  # [C,3]
    p,  # [C]
):
    """SIMPLE update: p += alpha_p p'; u += alpha_u / a_diag
    sum_f (p'_c - p'_f) A n_out, the interior p'_f by
    settings.pressure_correction_form: CELL_DIFFERENCE (reference
    parity, the default) p'_f = p'_nb; FACE_VALUE p'_f the mean. Both
    take p'_f = 0 at pressure BCs and p'_f = p'_c at prescribed-flux
    BCs. Returns (vel, p, (sum p'^2, sum |u'|^2)) over the active cells."""
    cf, m, (code, _, _), area, interior = _gathered(mesh, fbc)
    sgn = mesh.cell_face_sign
    zero = _zero(p_prime)
    p_pr_nb = p_prime[mesh.cell_neighbors.long()]
    if settings.pressure_correction_form == PressureCorrectionForm.FACE_VALUE:
        p_pr_int = 0.5 * (p_prime[:, None] + p_pr_nb)
    else:
        p_pr_int = p_pr_nb
    p_pr_f = torch.where(
        interior,
        p_pr_int,
        torch.where(
            (code == PRESSURE_INLET) | (code == PRESSURE_OUTLET),
            zero,
            p_prime[:, None],  # wall / symmetry / velocity inlet
        ),
    )
    n_out = sgn[..., None] * mesh.face_normal[cf]
    scaled_n = n_out / mom_diag[:, None, :]
    dpp = (p_prime[:, None] - p_pr_f) * area
    corr = torch.sum(
        torch.where(m[..., None], scaled_n * dpp[..., None], zero), dim=1
    )  # [C,3]
    corr_factor = (
        1.0
        if settings.relaxation_mode == RelaxationMode.IMPLICIT
        else settings.momentum_relaxation
    )
    new_vel = vel + corr_factor * corr
    new_p = p + settings.pressure_relaxation * p_prime
    active = m.any(dim=1)
    p_sq = torch.sum(torch.where(active, p_prime * p_prime, zero))
    v_sq = torch.sum(torch.where(active[:, None], corr * corr, zero))
    return new_vel, new_p, (p_sq, v_sq)
