"""Gather-free (c,k)-direct physics ops (port of orc_tpu/ops/ck_ops.py).

Every face quantity is evaluated per (cell, ELL slot) [C,K]: interior
faces twice, once from each side. Static face geometry is expanded once
into [C,K] tensors (`CKGeometry`), or kept as per-column constants on
uniform boxes (`UniformCKGeometry`). Neighbor values come from shifts
of the cell fields on structured meshes, from the slice-plan gather
(kernels 10-11 on the card) on irregular ones, or from one gather over
`cell_neighbors`; BC data from a Z-way select over the zone tables. The
arithmetic follows orc_tpu term by term, so both packages agree to
roundoff.

Ported: every function of orc_tpu's module: both geometries, every
branch of `nbr_values`, `zone_sel`, `CKBC`/`ck_bc`, `ck_face_pressure`
(Linear, LinearWeighted, SecondOrder), `ck_flux` (Linear,
LinearWeighted, Rhie-Chow), `ck_pressure_gradient` and
`ck_velocity_gradient` (Green-Gauss cell), `ck_lsq_pressure_gradient`
and `ck_lsq_velocity_gradient` (least squares, ops/gradients.py),
`ck_diffusion` (a scalar or a per-(c,k) [C,K] viscosity), `ck_momentum`
(UD, CD1 and TVD_DC with one matrix shared by u/v/w; CD2 and in-matrix
TVD with one matrix per component; momentum sources and the transient
inertia term in both), `ck_pressure_correction`, `ck_apply_correction`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from orc_tpu_torch.ops.fields import (
    PRESSURE_INLET,
    PRESSURE_OUTLET,
    SYMMETRY,
    VELOCITY_INLET,
    WALL,
    momentum_source_term,
)
from orc_tpu_torch.ops.gradients import least_squares
from orc_tpu_torch.ops.slice_spmv import slice_nbr_values
from orc_tpu_torch.ops.spmv import EllMatrix
from orc_tpu_torch.utils.settings import (
    MomentumScheme,
    NumericalSettings,
    PressureCorrectionForm,
    PressureInterpolation,
    RelaxationMode,
    VelocityInterpolation,
)


@dataclasses.dataclass(frozen=True)
class CKGeometry:
    """Static per-(cell, slot) geometry, orientation folded in."""

    area: torch.Tensor  # [C,K] (0 at padded slots)
    n_out: torch.Tensor  # [C,K,3] outward from c
    w: torch.Tensor  # [C,K] phi_f = phi_c + (phi_n - phi_c) w
    r_cf: torch.Tensor  # [C,K,3] x_face - x_c
    r_on: torch.Tensor  # [C,K,3] x_nbr - x_c (boundary: x_face - x_c)
    dist_on: torch.Tensor  # [C,K] |r_on| (1 at padded slots)
    dist_fo: torch.Tensor  # [C,K] |x_face - x_c| (1 at padded slots)
    interior: torch.Tensor  # [C,K] bool
    mask: torch.Tensor  # [C,K] bool
    zone_slot: torch.Tensor  # [C,K] i32
    n_zones: int


@dataclasses.dataclass(frozen=True)
class UniformCKGeometry:
    """(c,k) geometry of a uniform structured box: every float quantity
    is constant per ELL column (mesh.ck_constants), so the [C,K(,3)]
    tables are two boolean masks plus [K]-sized constants. The per-(c,k)
    tensors are properties that broadcast the constants."""

    interior: torch.Tensor  # [C,K] bool
    mask: torch.Tensor  # [C,K] bool
    c_area: torch.Tensor  # [K]
    c_n_out: torch.Tensor  # [K,3] outward from c (column-constant)
    c_dist_fo: torch.Tensor  # [K] |x_face - x_c|
    c_dist_on: torch.Tensor  # [K] interior |x_nbr - x_c|
    c_zone: torch.Tensor  # [K] i32 boundary zone slot of the column
    int_slot: int
    n_zones: int

    def _zero(self):
        return torch.zeros((), dtype=self.c_area.dtype, device=self.c_area.device)

    @property
    def area(self):
        return torch.where(self.mask, self.c_area, self._zero())

    @property
    def n_out(self):
        return torch.where(self.mask[..., None], self.c_n_out, self._zero())

    @property
    def w(self):
        half = torch.full((), 0.5, dtype=self.c_area.dtype, device=self.c_area.device)
        return torch.where(self.interior, half, self._zero())

    @property
    def r_cf(self):
        return torch.where(
            self.mask[..., None],
            self.c_dist_fo[:, None] * self.c_n_out,
            self._zero(),
        )

    @property
    def r_on(self):
        return torch.where(
            self.interior[..., None],
            self.c_dist_on[:, None] * self.c_n_out,
            self.r_cf,
        )

    @property
    def dist_on(self):
        one = torch.ones((), dtype=self.c_area.dtype, device=self.c_area.device)
        return torch.where(
            self.interior,
            self.c_dist_on,
            torch.where(self.mask, self.c_dist_fo, one),
        )

    @property
    def dist_fo(self):
        one = torch.ones((), dtype=self.c_area.dtype, device=self.c_area.device)
        return torch.where(self.mask, self.c_dist_fo, one)

    @property
    def zone_slot(self):
        int_slot = torch.full(
            (), self.int_slot, dtype=torch.int32, device=self.c_zone.device
        )
        return torch.where(self.interior | ~self.mask, int_slot, self.c_zone)


def _expand_geometry(mesh, n_zones: int) -> CKGeometry:
    """orc_tpu's `_expand_geometry` with plain indexing: the face
    geometry of each (c,k) slot in the cell's own frame, derived from
    the stored face vectors so periodic wraps see translated images
    (owner rows: x_f - x_c = x_f - x_own, c -> nbr = +r_on; neighbour
    rows: x_f - x_c = (x_f - x_own) - r_on, c -> nbr = -r_on)."""
    cf = mesh.cell_faces.long()
    m = mesh.cell_face_mask
    sgn = mesh.cell_face_sign
    area = mesh.face_area[cf] * m
    n_out = sgn[..., None] * mesh.face_normal[cf]
    interior = mesh.face_interior[cf] & m
    r_on_face = mesh.face_r_on[cf]
    r_f_own = (
        mesh.face_centroid - mesh.cell_centroid[mesh.face_owner.long()]
    )[cf]
    r_cf = torch.where(
        (sgn > 0)[..., None], r_f_own, r_f_own - r_on_face
    ) * m[..., None]
    r_on = torch.where(interior[..., None], sgn[..., None] * r_on_face, r_cf)
    dist_on = torch.sqrt(torch.sum(r_on * r_on, dim=-1))
    dist_fo = torch.sqrt(torch.sum(r_cf * r_cf, dim=-1))
    d_nf = r_cf - r_on
    dist_nf = torch.sqrt(torch.sum(d_nf * d_nf, dim=-1))
    zero = _zero_like(area)
    one = torch.ones((), dtype=area.dtype, device=area.device)
    w = torch.where(
        interior, dist_fo / torch.clamp(dist_fo + dist_nf, min=1e-300), zero
    )
    return CKGeometry(
        area=area,
        n_out=n_out,
        w=w,
        r_cf=r_cf,
        r_on=r_on,
        dist_on=torch.where(m, dist_on, one),
        dist_fo=torch.where(m, dist_fo, one),
        interior=interior,
        mask=m,
        zone_slot=mesh.face_zone_slot[cf].to(torch.int32),
        n_zones=n_zones,
    )


def build_ck_geometry(mesh, n_zones: int):
    """One-time expansion of the face geometry to [C,K]. Uniform boxes
    (mesh.ck_constants set by structured_box_mesh) materialize only the
    interior/mask booleans and keep per-column constants
    (UniformCKGeometry); every other mesh gets the expanded CKGeometry."""
    if mesh.ck_constants is None:
        return _expand_geometry(mesh, n_zones)
    int_slot, cols = mesh.ck_constants
    dt, dev = mesh.dtype, mesh.device
    m = mesh.cell_face_mask
    interior = mesh.face_interior[mesh.cell_faces.long()] & m

    def column(j, dtype=dt):
        # Uploaded without waiting for the card (a blocking copy would
        # first drain its queue).
        return torch.tensor([c[j] for c in cols], dtype=dtype).to(dev, non_blocking=True)

    return UniformCKGeometry(
        interior=interior,
        mask=m,
        c_area=column(0),
        c_n_out=column(1),
        c_dist_fo=column(2),
        c_dist_on=column(3),
        c_zone=column(4, torch.int32),
        int_slot=int_slot,
        n_zones=n_zones,
    )


def nbr_values(mesh, x, interior):
    """Neighbor-cell values [C,K(,d)]; slots that are not interior faces
    return the cell's own value. Structured meshes: shifts along the
    cell axis. Irregular meshes with a slice plan: the slice gather
    (kernels 10-11 on the card). Meshes without one (two cells or fewer,
    no interior face, or a degenerate plan): one gather over
    `cell_neighbors` (self-index at non-interior slots)."""
    if mesh.neighbor_offsets is None:
        if mesh.slice_plan is not None:
            return slice_nbr_values(mesh.slice_plan, x, interior)
        return x[mesh.cell_neighbors.long()]
    cols = [
        torch.roll(x, -int(d), dims=0) if d != 0 else x
        for d in mesh.neighbor_offsets
    ]
    out = torch.stack(cols, dim=1)  # [C,K,...]
    own = x.unsqueeze(1)
    cond = interior.reshape(interior.shape + (1,) * (x.ndim - 1))
    return torch.where(cond, out, own)


def mesh_matrix(mesh, diag, off) -> EllMatrix:
    """An EllMatrix over the mesh's adjacency: the shift form on
    structured meshes, the neighbor table and slice plan otherwise."""
    if mesh.neighbor_offsets is not None:
        return EllMatrix(
            diag=diag, off=off, neighbors=None, offsets=mesh.neighbor_offsets
        )
    return EllMatrix(
        diag=diag, off=off, neighbors=mesh.cell_neighbors, plan=mesh.slice_plan
    )


def planes(x):
    """x [C,K] as a view of K contiguous [C] planes ([K,C] storage), the
    layout the kernels read and write; no copy when x already has it."""
    return x.T.contiguous().T


def component_planes(off):
    """Per-component coefficients off [C,K,3] as [3,C,K] over
    contiguous [3,K,C] storage: column k of component i is a contiguous
    [C] plane, and column k a [3,C] plane set (the per-row kernels'
    layout)."""
    return off.permute(2, 1, 0).contiguous().transpose(1, 2)


def zone_sel(zone_vals, zone_slot, n_zones: int):
    """Static Z-way select of per-zone values onto [C,K].

    zone_vals: [Z] or [Z,3]; returns [C,K] or [C,K,3]."""
    if zone_vals.ndim == 1:
        out = zone_vals[0].expand(zone_slot.shape)
        for z in range(1, n_zones):
            out = torch.where(zone_slot == z, zone_vals[z], out)
        return out
    out = zone_vals[0].expand(zone_slot.shape + (zone_vals.shape[-1],))
    for z in range(1, n_zones):
        out = torch.where((zone_slot == z)[..., None], zone_vals[z], out)
    return out


class CKBC(NamedTuple):
    """Per-(c,k) BC data + frequently used masks."""

    code: torch.Tensor  # [C,K] i32
    scalar: torch.Tensor  # [C,K]
    vector: torch.Tensor  # [C,K,3]
    is_wall_like: torch.Tensor  # wall | symmetry
    is_dirichlet_vel: torch.Tensor  # wall | velocity inlet
    is_pressure: torch.Tensor  # pressure inlet | outlet
    is_vel_inlet: torch.Tensor


def ck_bc(ck, zone_codes, zone_scalar, zone_vector) -> CKBC:
    slot = ck.zone_slot
    code = zone_sel(zone_codes, slot, ck.n_zones)
    scalar = zone_sel(zone_scalar, slot, ck.n_zones)
    vector = zone_sel(zone_vector, slot, ck.n_zones)
    m = ck.mask
    return CKBC(
        code=code,
        scalar=scalar,
        vector=vector,
        is_wall_like=((code == WALL) | (code == SYMMETRY)) & m,
        is_dirichlet_vel=((code == WALL) | (code == VELOCITY_INLET)) & m,
        is_pressure=((code == PRESSURE_INLET) | (code == PRESSURE_OUTLET)) & m,
        is_vel_inlet=(code == VELOCITY_INLET) & m,
    )


def _zero_like(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def ck_face_pressure(
    mesh, ck, bc: CKBC, p, scheme: PressureInterpolation,
    grad_p=None, grad_p_nbr=None,
):
    """Face pressure per (c,k) [C,K]."""
    p_c = p[:, None]
    p_n = nbr_values(mesh, p, ck.interior)
    if scheme == PressureInterpolation.LINEAR:
        interior = 0.5 * (p_c + p_n)
    elif scheme == PressureInterpolation.LINEAR_WEIGHTED:
        interior = p_c + (p_n - p_c) * ck.w
    elif scheme == PressureInterpolation.SECOND_ORDER:
        r_cf = ck.r_cf
        r_nf = r_cf - ck.r_on  # x_face - x_nbr
        g_c = torch.sum(grad_p[:, None, :] * r_cf, dim=-1)
        g_n = torch.sum(grad_p_nbr * r_nf, dim=-1)
        interior = 0.5 * ((p_c + p_n) + (g_c + g_n))
    else:
        raise NotImplementedError(f"pressure interpolation {scheme}")
    return torch.where(
        bc.is_pressure,
        bc.scalar,
        torch.where(ck.interior, interior, p_c),
    )


def ck_flux(
    mesh, ck, bc: CKBC, vel, scheme: VelocityInterpolation,
    p=None, grad_p=None, grad_p_nbr=None, mom_diag=None, mom_diag_nbr=None,
    vel_nbr=None,
):
    """Outward normal velocity per (c,k) [C,K]; Rhie-Chow with
    orc_tpu's +term3 sign (see orc_tpu interpolation.face_flux)."""
    v_c = vel[:, None, :]
    v_n = vel_nbr if vel_nbr is not None else nbr_values(mesh, vel, ck.interior)
    n_out = ck.n_out
    if scheme in (
        VelocityInterpolation.LINEAR,
        VelocityInterpolation.LINEAR_WEIGHTED,
    ):
        if scheme == VelocityInterpolation.LINEAR:
            vf = 0.5 * (v_c + v_n)
        else:
            vf = v_c + (v_n - v_c) * ck.w[..., None]
        interior = torch.sum(vf * n_out, dim=-1)
    elif scheme == VelocityInterpolation.RHIE_CHOW:
        md_n = (
            mom_diag_nbr if mom_diag_nbr is not None
            else nbr_values(mesh, mom_diag, ck.interior)
        )
        a_c = torch.sqrt(torch.sum((mom_diag[:, None, :] * n_out) ** 2, dim=-1))
        a_n = torch.sqrt(torch.sum((md_n * n_out) ** 2, dim=-1))
        vol = mesh.cell_volume
        voa_c = vol[:, None] / a_c
        voa_n = nbr_values(mesh, vol, ck.interior) / a_n
        p_n = nbr_values(mesh, p, ck.interior)
        gp_n = (
            grad_p_nbr if grad_p_nbr is not None
            else nbr_values(mesh, grad_p, ck.interior)
        )
        dist_on = ck.dist_on
        term1 = torch.sum((v_c + v_n) * n_out, dim=-1)
        term2 = (voa_c + voa_n) * (p[:, None] - p_n) / dist_on
        gsum = voa_c[..., None] * grad_p[:, None, :] + voa_n[..., None] * gp_n
        term3 = torch.sum(gsum * ck.r_on, dim=-1) / dist_on
        interior = 0.5 * (term1 + term2 + term3)
    else:
        raise NotImplementedError(f"velocity interpolation {scheme}")

    bnd = torch.where(
        bc.is_vel_inlet,
        torch.sum(bc.vector * n_out, dim=-1),
        torch.sum(v_c * n_out, dim=-1),  # pressure BCs
    )
    zero = _zero_like(vel)
    return torch.where(
        bc.is_wall_like,
        zero,
        torch.where(ck.interior, interior, torch.where(ck.mask, bnd, zero)),
    )


def ck_pressure_gradient(mesh, ck, bc: CKBC, p):
    """Green-Gauss cell gradient with Linear face pressures [C,3]."""
    pf = ck_face_pressure(mesh, ck, bc, p, PressureInterpolation.LINEAR)
    wgt = ck.area / mesh.cell_volume[:, None]
    return torch.sum((wgt * pf)[..., None] * ck.n_out, dim=1)


def ck_lsq_pressure_gradient(mesh, ck, bc: CKBC, p):
    """Least-squares cell pressure gradient [C,3]: interior rows the
    neighbour deltas, boundary rows the face deltas with the zone value
    at pressure BCs (zero delta elsewhere). `ck.r_on` is the table of
    displacement rows (interior: c -> nbr, periodic translation
    included; boundary: c -> face; padded: 0)."""
    p_c = p[:, None]
    p_n = nbr_values(mesh, p, ck.interior)
    zero = _zero_like(p)
    b = torch.where(
        ck.interior,
        p_n - p_c,
        torch.where(bc.is_pressure, bc.scalar - p_c, zero),
    )
    b = torch.where(ck.mask, b, zero)
    return least_squares(mesh.dim, ck.r_on, b)


def ck_lsq_velocity_gradient(mesh, ck, bc: CKBC, vel, vel_nbr=None):
    """Least-squares velocity gradient [C,3,3] (row i = grad of component
    i): boundary rows take the BC vector at Dirichlet-velocity faces."""
    v_c = vel[:, None, :]
    v_n = vel_nbr if vel_nbr is not None else nbr_values(mesh, vel, ck.interior)
    zero = _zero_like(vel)
    b = torch.where(
        ck.interior[..., None],
        v_n - v_c,
        torch.where(bc.is_dirichlet_vel[..., None], bc.vector - v_c, zero),
    )
    b = torch.where(ck.mask[..., None], b, zero)
    return least_squares(mesh.dim, ck.r_on, b)


def ck_velocity_gradient(mesh, ck, bc: CKBC, vel, vel_nbr=None):
    """Green-Gauss velocity gradient [C,3,3] (row i = grad of component
    i): Dirichlet-velocity faces take the BC vector, interior faces the
    mean of the two cells, other boundary faces the cell's own value."""
    v_c = vel[:, None, :]
    v_n = vel_nbr if vel_nbr is not None else nbr_values(mesh, vel, ck.interior)
    vf = torch.where(
        bc.is_dirichlet_vel[..., None],
        bc.vector,
        torch.where(ck.interior[..., None], 0.5 * (v_c + v_n), v_c),
    )
    wgt = (ck.area / mesh.cell_volume[:, None])[..., None, None]
    return torch.sum(wgt * vf[..., :, None] * ck.n_out[..., None, :], dim=1)


def ck_diffusion(mesh, ck, bc: CKBC, mu):
    """Diffusion contributions (diag [C], off [C,K], b [C,3]); `mu` a
    scalar or a per-(c,k) face viscosity [C,K] (the RANS mu + mu_t)."""
    area = ck.area
    d_bnd = mu * area / ck.dist_fo
    d_int = mu * area / ck.dist_on
    zero = _zero_like(area)
    dirichlet = bc.is_dirichlet_vel & ~ck.interior
    d = torch.where(ck.interior, d_int, torch.where(dirichlet, d_bnd, zero))
    diag = torch.sum(d, dim=1)
    off = torch.where(ck.interior, -d, zero)
    b = torch.sum(
        torch.where(dirichlet[..., None], d[..., None] * bc.vector, zero),
        dim=1,
    )
    return diag, off, b


def ck_momentum(
    mesh, ck, bc: CKBC, settings: NumericalSettings, rho,
    vel, F, p_f, diff_diag, diff_off, diff_b, grad_vel=None, vel_nbr=None,
    inertia=None,
):
    """Momentum system and RHS [3,C] from per-(c,k) mass flows
    F = flux * area * rho, plus the per-cell Peclet estimate [C,3].

    UD, CD1 and TVD_DC (the implicit UD matrix plus an explicit limited
    correction from the upwind side) give one matrix shared by u/v/w:
    diag [C], off [C,K]. CD2 (the central matrix plus an explicit
    gradient correction) and TVD (the limited coefficients in the
    matrix) give one matrix per component: diag [3,C], off [3,C,K], each
    column of off a contiguous [3,C] plane (the layout the kernels read
    after `split_columns`). TVD, TVD_DC and CD2 need `grad_vel` [C,3,3];
    TVD and TVD_DC also settings.tvd_psi. TVD keeps orc_tpu's handling
    of faces whose downstream value equals the cell's (the central
    coefficient, PARITY.md). settings.momentum_source
    (fields.momentum_source_term) is added to the RHS. `inertia` = (rv_dt
    [C], vel_n [C,3]) adds the implicit-Euler term rho V/dt to the
    diagonal and rho V/dt vel^n to the RHS, before the Patankar
    relaxation."""
    scheme = settings.momentum
    Fv = F[..., None]
    zero = _zero_like(F)
    s_dc = None
    if scheme == MomentumScheme.UD:
        a_nb = torch.clamp(F, max=0.0)
    elif scheme == MomentumScheme.CD1:
        a_nb = F / 2.0
    elif scheme == MomentumScheme.CD2:
        if grad_vel is None:
            raise ValueError("CD2 momentum requires grad_vel")
        gv_n = nbr_values(mesh, grad_vel, ck.interior)
        r_cf = ck.r_cf
        r_nf = r_cf - ck.r_on
        g_c = torch.einsum("cij,ckj->cki", grad_vel, r_cf)
        g_d = torch.sum(gv_n * r_nf[..., None, :], dim=-1)
        delta = 0.5 * (g_c + g_d)
        a_nb = Fv / 2.0 * torch.ones((1, 1, 3), dtype=F.dtype, device=F.device)
        s_dc = -torch.sum(
            torch.where(ck.interior[..., None], Fv * delta, zero), dim=1
        )
    elif scheme == MomentumScheme.TVD:
        if settings.tvd_psi is None or grad_vel is None:
            raise ValueError("TVD momentum requires tvd_psi and grad_vel")
        a_nb = _tvd_coefficients(mesh, ck, settings.tvd_psi, vel, Fv, grad_vel, vel_nbr)
    elif scheme == MomentumScheme.TVD_DC:
        if settings.tvd_psi is None or grad_vel is None:
            raise ValueError("TVD_DC momentum requires tvd_psi and grad_vel")
        a_nb = torch.clamp(F, max=0.0)  # the UD matrix, shared
        s_dc = _tvd_dc_source(
            mesh, ck, settings.tvd_psi, vel, F, grad_vel, vel_nbr
        )
    else:
        raise NotImplementedError(f"momentum scheme {scheme}")
    shared = a_nb.ndim == 2  # component-independent matrix
    mask = ck.mask
    area = ck.area
    n_out = ck.n_out
    if shared:
        a_nb = torch.where(mask, a_nb, zero)
        a_p = torch.sum(torch.where(mask, -a_nb + F, zero), dim=1)  # [C]
        a_nb_src = a_nb[..., None]
    else:
        a_nb = torch.where(mask[..., None], a_nb, zero)
        a_p = torch.sum(torch.where(mask[..., None], -a_nb + Fv, zero), dim=1)
        a_nb_src = a_nb
    s_u = -torch.sum(
        torch.where(mask[..., None], n_out * (p_f * area)[..., None], zero),
        dim=1,
    )
    dirichlet = bc.is_dirichlet_vel & ~ck.interior
    s_u = s_u + torch.sum(
        torch.where(dirichlet[..., None], (a_nb_src - Fv) * bc.vector, zero),
        dim=1,
    )
    if s_dc is not None:
        s_u = s_u + s_dc
    if settings.momentum_source is not None:
        s_u = s_u + momentum_source_term(
            settings.momentum_source, mesh.cell_centroid, mesh.cell_volume
        )
    active = mask.any(dim=1)
    one = torch.ones((), dtype=F.dtype, device=F.device)
    safe_dd = torch.where(active, diff_diag, one)
    if shared:
        off = torch.where(ck.interior, a_nb + diff_off, zero)  # [C,K]
        diag = a_p + diff_diag  # [C]
        b = s_u + diff_b  # [C,3]
        if inertia is not None:
            rv_dt, vel_n = inertia
            diag = diag + rv_dt
            b = b + rv_dt[:, None] * vel_n
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
        return mesh_matrix(mesh, diag, off), b.T, pe

    off = torch.where(ck.interior[..., None], a_nb + diff_off[..., None], zero)
    diag = a_p + diff_diag[:, None]  # [C,3]
    b = s_u + diff_b
    if inertia is not None:
        rv_dt, vel_n = inertia
        diag = diag + rv_dt[:, None]
        b = b + rv_dt[:, None] * vel_n
    if settings.relaxation_mode == RelaxationMode.IMPLICIT:
        alpha = settings.momentum_relaxation
        b = b + (1.0 - alpha) / alpha * diag * vel
        diag = diag / alpha
    diag = torch.where(active[:, None], diag, one)
    b = torch.where(active[:, None], b, zero)
    pe = torch.where(active[:, None], a_p / safe_dd[:, None], zero)
    return mesh_matrix(mesh, diag.T.contiguous(), component_planes(off)), b.T, pe


def _tvd_coefficients(mesh, ck, psi, vel, Fv, grad_vel, vel_nbr):
    """In-matrix TVD neighbour coefficients [C,K,3]: interior faces take
    F psi(r)/2 with r = 2 grad_c . r_on / (phi_down - phi_c) - 1 (r = 1
    where phi_down == phi_c), or F/2 where the downstream velocity
    equals the cell's; boundary faces take the UD coefficient. As in
    orc_tpu, an inflow face's downstream value is the cell's own, so it
    takes the central coefficient (PARITY.md)."""
    one = torch.ones((), dtype=Fv.dtype, device=Fv.device)
    v_c = vel[:, None, :]
    v_n = vel_nbr if vel_nbr is not None else nbr_values(mesh, vel, ck.interior)
    downstream = torch.where(Fv > 0, v_n, v_c)
    diffv = downstream - v_c
    same = torch.sqrt(torch.sum(diffv * diffv, dim=-1)) == 0.0
    gdotr = torch.einsum("cij,ckj->cki", grad_vel, ck.r_on)
    safe = torch.where(diffv == 0.0, one, diffv)
    r = torch.where(diffv == 0.0, one, 2.0 * gdotr / safe - 1.0)
    a_tvd = Fv * psi(r) / 2.0
    a_cd = Fv / 2.0 * torch.ones_like(a_tvd)
    a_ud = torch.clamp(Fv, max=0.0) * torch.ones_like(a_tvd)
    return torch.where(
        ck.interior[..., None], torch.where(same[..., None], a_cd, a_tvd), a_ud
    )


def _tvd_dc_source(mesh, ck, psi, vel, F, grad_vel, vel_nbr):
    """Deferred-correction source [C,3] of TVD_DC: on each interior face
    the limited increment psi(r)/2 (phi_D - phi_U) from the upwind side,
    r = 2 grad_U . r_UD / (phi_D - phi_U) - 1; faces where
    phi_D == phi_U take no correction."""
    Fv = F[..., None]
    v_c = vel[:, None, :]
    v_n = vel_nbr if vel_nbr is not None else nbr_values(mesh, vel, ck.interior)
    g_n = nbr_values(mesh, grad_vel, ck.interior)
    zero = _zero_like(F)
    one = torch.ones((), dtype=F.dtype, device=F.device)
    d_cd = v_n - v_c
    up_is_c = Fv > 0
    delta = torch.where(up_is_c, d_cd, -d_cd)  # phi_D - phi_U
    r_on = ck.r_on
    g_c = torch.einsum("cij,ckj->cki", grad_vel, r_on)
    g_nb = -torch.sum(g_n * r_on[..., None, :], dim=-1)
    gdotr = torch.where(up_is_c, g_c, g_nb)  # grad_U . r_UD
    safe = torch.where(delta == 0.0, one, delta)
    r = 2.0 * gdotr / safe - 1.0
    corr = torch.where(delta == 0.0, zero, psi(r) / 2.0 * delta)
    return -torch.sum(torch.where(ck.interior[..., None], Fv * corr, zero), dim=1)


def ck_pressure_correction(mesh, ck, bc: CKBC, rho, F2, mom_diag, mom_diag_nbr=None):
    """SIMPLE continuity system from per-(c,k) mass flows, with the
    reference's rho A^2/a/2 term on every boundary face."""
    zero = _zero_like(F2)
    mask = ck.mask
    n_out = ck.n_out
    area = ck.area
    b = torch.sum(torch.where(mask, -F2, zero), dim=1)
    md_n = (
        mom_diag_nbr if mom_diag_nbr is not None
        else nbr_values(mesh, mom_diag, ck.interior)
    )
    a_c = torch.sqrt(torch.sum((mom_diag[:, None, :] * n_out) ** 2, dim=-1))
    a_face = 0.5 * torch.sqrt(
        torch.sum(((mom_diag[:, None, :] + md_n) * n_out) ** 2, dim=-1)
    )
    a_nb = rho * area**2 / a_face
    a_bnd = rho * area**2 / a_c / 2.0
    active = mask.any(dim=1)
    diag = torch.sum(
        torch.where(ck.interior, a_nb, torch.where(mask, a_bnd, zero)), dim=1
    )
    one = torch.ones((), dtype=diag.dtype, device=diag.device)
    diag = torch.where(active, diag, one)
    b = torch.where(active, b, zero)
    off = torch.where(ck.interior, -a_nb, zero)
    return mesh_matrix(mesh, diag, off), b


def ck_apply_correction(
    mesh, ck, bc: CKBC, settings, p_prime, mom_diag, vel, p
):
    """SIMPLE update of (vel, p) from p'; returns (vel, p, (sum p'^2,
    sum |u'|^2)) over active cells. mom_diag is cell-major [C,3]."""
    pp_nb = nbr_values(mesh, p_prime, ck.interior)
    if settings.pressure_correction_form == PressureCorrectionForm.FACE_VALUE:
        pp_int = 0.5 * (p_prime[:, None] + pp_nb)
    else:  # CELL_DIFFERENCE (reference parity, the default)
        pp_int = pp_nb
    zero = _zero_like(p_prime)
    pp_f = torch.where(
        ck.interior,
        pp_int,
        torch.where(bc.is_pressure, zero, p_prime[:, None]),
    )
    scaled_n = ck.n_out / mom_diag[:, None, :]
    dpp = (p_prime[:, None] - pp_f) * ck.area
    corr = torch.sum(
        torch.where(ck.mask[..., None], scaled_n * dpp[..., None], zero), dim=1
    )
    corr_factor = (
        1.0
        if settings.relaxation_mode == RelaxationMode.IMPLICIT
        else settings.momentum_relaxation
    )
    new_vel = vel + corr_factor * corr
    new_p = p + settings.pressure_relaxation * p_prime
    active = ck.mask.any(dim=1)
    p_sq = torch.sum(torch.where(active, p_prime * p_prime, zero))
    v_sq = torch.sum(torch.where(active[:, None], corr * corr, zero))
    return new_vel, new_p, (p_sq, v_sq)
