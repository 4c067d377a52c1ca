"""Cell gradients (port of orc_tpu/ops/gradients.py).

The face-major step's `pressure_gradient` and `velocity_gradient` take
Green-Gauss cell (face values summed against the signed face areas),
Green-Gauss node (face values interpolated through the mesh vertices,
mesh/nodes.py) or least squares; the (c,k) step calls `least_squares`
directly (ops/ck_ops.py).

For least squares each cell solves its normal equations (A^T A) g = A^T b over its ELL
slots: d [C,K,3] the displacement rows, b the value deltas, masked rows
zeroed by the caller. 2-D meshes drop the z column statically and pad
it back with zeros.

The dim x dim solves are closed forms (Cramer's rule on the symmetric
Gram matrix, its entries summed over the slots): plain elementwise
tensor arithmetic, with no pivoting and no singularity check, so no
device-to-host sync on the card (orc_tpu's `jnp.linalg.solve` never
raises either). The Gram matrix of a cell with at least `dim`
independent rows is symmetric positive definite, where the closed form
agrees with orc_tpu's LU solve to roundoff.

Least squares differs from the reference as orc_tpu does: boundary rows
use the difference phi_face - phi_cell, and 2-D meshes drop the z
column.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from orc_tpu_torch.ops.fields import PRESSURE_INLET, PRESSURE_OUTLET, FaceBC
from orc_tpu_torch.ops.interpolation import face_pressure, face_velocity
from orc_tpu_torch.utils.settings import (
    GradientReconstruction,
    PressureInterpolation,
    VelocityInterpolation,
)


def _gram(dd):
    """The unique entries {(a, b): [C]}, a <= b, of each cell's Gram
    matrix sum_k d_a d_b of its rows dd [C,K,dim]."""
    n = dd.shape[-1]
    return {
        (a, c): torch.sum(dd[..., a] * dd[..., c], dim=1)
        for a in range(n) for c in range(a, n)
    }


def _cramer(g, r):
    """x of G x = r by Cramer's rule, G symmetric n x n (n <= 3) given by
    its unique entries g {(a, b): tensor}, r a list of n right-hand
    sides broadcasting against them; returns the n components of x."""
    n = len(r)
    if n == 1:
        return [r[0] / g[0, 0]]
    if n == 2:
        g00, g01, g11 = g[0, 0], g[0, 1], g[1, 1]
        det = g00 * g11 - g01 * g01
        return [(g11 * r[0] - g01 * r[1]) / det, (g00 * r[1] - g01 * r[0]) / det]
    g00, g01, g02 = g[0, 0], g[0, 1], g[0, 2]
    g11, g12, g22 = g[1, 1], g[1, 2], g[2, 2]
    c00 = g11 * g22 - g12 * g12
    c01 = g02 * g12 - g01 * g22
    c02 = g01 * g12 - g02 * g11
    c11 = g00 * g22 - g02 * g02
    c12 = g01 * g02 - g00 * g12
    c22 = g00 * g11 - g01 * g01
    det = g00 * c00 + g01 * c01 + g02 * c02
    return [
        (c00 * r[0] + c01 * r[1] + c02 * r[2]) / det,
        (c01 * r[0] + c11 * r[1] + c12 * r[2]) / det,
        (c02 * r[0] + c12 * r[1] + c22 * r[2]) / det,
    ]


def least_squares(dim: int, d, b):
    """Per-cell least-squares gradient: d [C,K,3] displacement rows, b
    [C,K] or [C,K,3] value deltas (masked rows zeroed). Returns [C,3] or
    [C,3,3] (row i = gradient of component i). The normal equations are
    formed as per-cell sums over the K slots: as a batched matrix product
    the pressure gradient of the 1024^2 f32 cavity took 4.27 ms on an
    NVIDIA H100 80GB HBM3 (700 W), as slot sums 1.31 ms."""
    dd = d[..., :dim]
    g = _gram(dd)
    if b.ndim == 2:
        r = [torch.sum(dd[..., a] * b, dim=1) for a in range(dim)]  # [C]
        x = torch.stack(_cramer(g, r), dim=-1)  # [C,dim]
    else:
        r = [torch.sum(dd[..., a, None] * b, dim=1) for a in range(dim)]  # [C,3]
        gv = {key: v[:, None] for key, v in g.items()}
        x = torch.stack(_cramer(gv, r), dim=-1)  # [C,3,dim]
    return F.pad(x, (0, 3 - dim)) if dim < 3 else x


def _green_gauss(mesh, face_vals):
    """sum_f phi_f n_out A / V over each cell's faces: face_vals [F] ->
    [C,3]; [F,3] -> [C,3,3] with row i the gradient of component i."""
    cf = mesh.cell_faces.long()
    # [C,K] signed area / volume (0 at padded slots)
    w = mesh.cell_face_sign * mesh.face_area[cf] / mesh.cell_volume[:, None]
    n = mesh.face_normal[cf]  # [C,K,3]
    phi = face_vals[cf]
    # Slot sums, not batched products (see `least_squares`).
    if phi.ndim == 2:  # scalar field
        return torch.sum((w * phi)[..., None] * n, dim=1)
    return torch.sum(w[..., None, None] * phi[..., :, None] * n[..., None, :], dim=1)


def _ls_rows(mesh):
    """Displacement rows for least squares [C,K,3] and the interior mask
    [C,K]: interior -> the neighbour's centroid (periodic image included,
    through the stored owner -> neighbour vector), boundary -> the face
    centroid, padded -> 0."""
    cf = mesh.cell_faces.long()
    m = mesh.cell_face_mask
    interior = mesh.face_interior[cf] & m
    d_int = mesh.cell_face_sign[..., None] * mesh.face_r_on[cf]
    d_bnd = mesh.face_centroid[cf] - mesh.cell_centroid[:, None, :]
    d = torch.where(interior[..., None], d_int, d_bnd)
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    return torch.where(m[..., None], d, zero), interior


def _node_face_values(mesh, phi, phi_f_bc):
    """Vertex-interpolated face values of node-based Green-Gauss:
    interior faces average the IDW vertex values (mesh/nodes.py),
    boundary faces keep the BC-aware face value `phi_f_bc`."""
    if mesh.nodes is None:
        raise ValueError(
            "node-based Green-Gauss needs vertex tables: load the mesh "
            "with read_mesh(..., nodes=True) / compile_mesh(..., "
            "nodes=True)"
        )
    from orc_tpu_torch.mesh.nodes import node_face_values

    pf_node = node_face_values(mesh.nodes, phi)
    if pf_node.shape != phi_f_bc.shape:
        # A periodic mesh merges face pairs, so the raw face-node table
        # outnumbers the compiled faces; orc_tpu's select raises a
        # ValueError there too.
        raise ValueError(
            f"vertex face values {tuple(pf_node.shape)} do not match the "
            f"mesh's faces {tuple(phi_f_bc.shape)} (periodic face pairs are "
            "merged by compile_mesh)"
        )
    interior = mesh.face_interior
    if phi_f_bc.ndim == 2:
        interior = interior[:, None]
    return torch.where(interior, pf_node, phi_f_bc)


def pressure_gradient(
    mesh,
    fbc: FaceBC,
    p,
    scheme: GradientReconstruction = GradientReconstruction.GREEN_GAUSS_CELL,
):
    """grad p per cell [C,3] (reference: solver.rs:874-950); Green-Gauss
    takes Linear face pressures, as the reference does."""
    if scheme == GradientReconstruction.GREEN_GAUSS_CELL:
        pf = face_pressure(mesh, fbc, p, PressureInterpolation.LINEAR)
        return _green_gauss(mesh, pf)
    if scheme == GradientReconstruction.GREEN_GAUSS_NODE:
        pf = face_pressure(mesh, fbc, p, PressureInterpolation.LINEAR)
        return _green_gauss(mesh, _node_face_values(mesh, p, pf))
    if scheme == GradientReconstruction.LEAST_SQUARES:
        d, interior = _ls_rows(mesh)
        p_own = p[:, None]
        # Boundary face value: the zone pressure at pressure BCs, the
        # cell's own value (a zero delta) elsewhere.
        code, scalar_ck, _ = fbc.ck(mesh)
        is_pbc = (code == PRESSURE_INLET) | (code == PRESSURE_OUTLET)
        pf_bnd = torch.where(is_pbc, scalar_ck, p_own)
        b = torch.where(
            interior, p[mesh.cell_neighbors.long()] - p_own, pf_bnd - p_own
        )
        zero = torch.zeros((), dtype=b.dtype, device=b.device)
        b = torch.where(mesh.cell_face_mask, b, zero)
        return least_squares(mesh.dim, d, b)
    raise NotImplementedError(f"gradient scheme {scheme}")


def velocity_gradient(
    mesh,
    fbc: FaceBC,
    vel,
    scheme: GradientReconstruction = GradientReconstruction.GREEN_GAUSS_CELL,
):
    """grad of (u, v, w) per cell [C,3,3], row i the gradient of
    component i (reference: solver.rs:774-872); Green-Gauss takes Linear
    face velocities, as the reference does."""
    if scheme == GradientReconstruction.GREEN_GAUSS_CELL:
        vf = face_velocity(mesh, fbc, vel, VelocityInterpolation.LINEAR)
        return _green_gauss(mesh, vf)
    if scheme == GradientReconstruction.GREEN_GAUSS_NODE:
        vf = face_velocity(mesh, fbc, vel, VelocityInterpolation.LINEAR)
        return _green_gauss(mesh, _node_face_values(mesh, vel, vf))
    if scheme == GradientReconstruction.LEAST_SQUARES:
        d, interior = _ls_rows(mesh)
        v_own = vel[:, None, :]  # [C,1,3]
        vf = face_velocity(mesh, fbc, vel, VelocityInterpolation.LINEAR)
        b = torch.where(
            interior[..., None],
            vel[mesh.cell_neighbors.long()] - v_own,
            vf[mesh.cell_faces.long()] - v_own,
        )
        zero = torch.zeros((), dtype=b.dtype, device=b.device)
        b = torch.where(mesh.cell_face_mask[..., None], b, zero)
        return least_squares(mesh.dim, d, b)
    raise NotImplementedError(f"gradient scheme {scheme}")
