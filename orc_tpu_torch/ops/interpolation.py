"""Face interpolation ops of the face-major step: velocity, pressure and
mass flux at faces (port of orc_tpu/ops/interpolation.py).

Each op is one vectorized map over the F faces: two cell-value gathers,
elementwise math and BC selection by `torch.where` over the face BC
codes; no scatter. Fluxes and face pressures are computed once per face
per outer iteration.

Sign convention: `face_flux` returns the normal velocity with respect to
the owner cell's outward normal; the assembly applies `cell_face_sign`
for the neighbour's side.
"""

from __future__ import annotations

import torch

from orc_tpu_torch.ops.fields import (
    INTERIOR,
    PRESSURE_INLET,
    PRESSURE_OUTLET,
    SYMMETRY,
    VELOCITY_INLET,
    WALL,
    FaceBC,
)
from orc_tpu_torch.utils.settings import PressureInterpolation, VelocityInterpolation


def _dot(a, b):
    """Row-wise dot product over the last axis."""
    return torch.sum(a * b, dim=-1)


def _interior_scalar(mesh, own, nbr, weighted: bool):
    if weighted:
        w = mesh.face_lw
        if own.ndim > 1:
            w = w[:, None]
        return own + (nbr - own) * w
    return 0.5 * (own + nbr)


def face_velocity(
    mesh,
    fbc: FaceBC,
    vel,  # [C,3]
    scheme: VelocityInterpolation = VelocityInterpolation.LINEAR,
):
    """Velocity at each face [F,3] (reference: solver.rs:952-1003)."""
    own = vel[mesh.face_owner.long()]
    nbr = vel[mesh.face_neighbor.long()]
    interior = _interior_scalar(
        mesh, own, nbr, scheme == VelocityInterpolation.LINEAR_WEIGHTED
    )
    return torch.where(
        fbc.is_(WALL, VELOCITY_INLET)[:, None],
        fbc.vector,
        torch.where(
            fbc.is_(PRESSURE_INLET, PRESSURE_OUTLET, SYMMETRY)[:, None],
            own,
            interior,
        ),
    )


def face_pressure(
    mesh,
    fbc: FaceBC,
    p,  # [C]
    scheme: PressureInterpolation,
    grad_p=None,  # [C,3], required for SECOND_ORDER
):
    """Pressure at each face [F] (reference: solver.rs:1104-1150)."""
    own_i = mesh.face_owner.long()
    nbr_i = mesh.face_neighbor.long()
    own = p[own_i]
    nbr = p[nbr_i]
    if scheme == PressureInterpolation.LINEAR:
        interior = 0.5 * (own + nbr)
    elif scheme == PressureInterpolation.LINEAR_WEIGHTED:
        interior = _interior_scalar(mesh, own, nbr, True)
    elif scheme == PressureInterpolation.SECOND_ORDER:
        if grad_p is None:
            raise ValueError("SECOND_ORDER face pressure requires grad_p")
        r0 = mesh.face_centroid - mesh.cell_centroid[own_i]
        # x_f - x_nbr through the stored owner -> neighbour vector, which
        # carries the periodic image's translation.
        r1 = r0 - mesh.face_r_on
        g0 = _dot(grad_p[own_i], r0)
        g1 = _dot(grad_p[nbr_i], r1)
        interior = 0.5 * ((own + nbr) + (g0 + g1))
    else:
        raise NotImplementedError(f"pressure interpolation {scheme}")
    return torch.where(
        fbc.is_(WALL, SYMMETRY, VELOCITY_INLET),
        own,
        torch.where(fbc.is_(PRESSURE_INLET, PRESSURE_OUTLET), fbc.scalar, interior),
    )


def face_flux(
    mesh,
    fbc: FaceBC,
    vel,  # [C,3]
    scheme: VelocityInterpolation,
    p=None,  # [C]      (Rhie-Chow)
    grad_p=None,  # [C,3]    (Rhie-Chow)
    mom_diag=None,  # [C,3] momentum-matrix diagonals (Rhie-Chow)
):
    """Normal velocity (owner-outward) at each face [F]
    (reference: solver.rs:1007-1102).

    Rhie-Chow: 0.5 [ (v_i + v_j) . n + (V_i/a_i + V_j/a_j)(p_i - p_j)/|r_ij|
    + (V_i/a_i grad p_i + V_j/a_j grad p_j) . r_ij / |r_ij| ], with
    a_c = |(a_u n_x, a_v n_y, a_w n_z)|. The gradient term is ADDED, as
    orc_tpu adds it (its docstring gives why the reference's minus sign
    is a defect)."""
    n = mesh.face_normal
    own_i = mesh.face_owner.long()
    nbr_i = mesh.face_neighbor.long()
    v_own = vel[own_i]
    v_nbr = vel[nbr_i]
    if scheme in (
        VelocityInterpolation.LINEAR,
        VelocityInterpolation.LINEAR_WEIGHTED,
    ):
        vf = _interior_scalar(
            mesh, v_own, v_nbr, scheme == VelocityInterpolation.LINEAR_WEIGHTED
        )
        interior = _dot(vf, n)
    elif scheme == VelocityInterpolation.RHIE_CHOW:
        if p is None or grad_p is None or mom_diag is None:
            raise ValueError("Rhie-Chow flux requires p, grad_p, mom_diag")
        a_i = torch.linalg.vector_norm(mom_diag[own_i] * n, dim=1)
        a_j = torch.linalg.vector_norm(mom_diag[nbr_i] * n, dim=1)
        voa_i = mesh.cell_volume[own_i] / a_i
        voa_j = mesh.cell_volume[nbr_i] / a_j
        dist = mesh.face_dist_on
        term1 = _dot(v_own + v_nbr, n)
        term2 = (voa_i + voa_j) * (p[own_i] - p[nbr_i]) / dist
        gsum = voa_i[:, None] * grad_p[own_i] + voa_j[:, None] * grad_p[nbr_i]
        term3 = _dot(gsum, mesh.face_r_on) / dist
        interior = 0.5 * (term1 + term2 + term3)
    else:
        raise NotImplementedError(f"velocity interpolation {scheme}")

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
