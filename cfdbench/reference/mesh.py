"""Plain finite-volume mathematics on any face list, the reference that
decides `correct` for a mesh case.

A frozen, independent restatement of the face-major SIMPLE and
SIMPLE_FC iterations of orc_tpu_torch (ops/interpolation.py,
ops/gradients.py, ops/assembly.py, solver/fc.py) for a mesh given as the
generator gives it (cfdbench/meshes): nodes, each face's nodes and two
cells, named zones. Boundary faces are walls (with a wall velocity),
symmetry planes, velocity inlets (with their velocity) or pressure
inlets and outlets (with their pressure).

Geometry, by ORC's definitions (io.rs:289-438): a face's centroid is the
mean of its nodes; its area the edge length (2-D) or the triangle fan
about the centroid (3-D); its unit normal from its first nodes, turned
out of the owner (the face's first cell); a cell's centroid the mean of
its faces' centroids; its volume sum A |(x_f - x_c) . n| / dim.

Layout: a cell field is [C], a vector field [3, C] (component first); a
face field [F] holds the value out of the face's owner. Plain torch
only; it imports nothing of the program, and the caller turns TF32 off.
"""

from __future__ import annotations

import dataclasses

import torch

from cfdbench.reference.box import LIMITERS

INTERIOR, WALL, SYMMETRY, VELOCITY_INLET, PRESSURE = range(5)
#: Boundary kinds by case-file type; a pressure inlet and a pressure
#: outlet take the same branches everywhere.
KINDS = {
    "wall": WALL,
    "symmetry": SYMMETRY,
    "velocity_inlet": VELOCITY_INLET,
    "pressure_inlet": PRESSURE,
    "pressure_outlet": PRESSURE,
}
#: TGRID condition codes of those kinds (a zone the configuration does
#: not name keeps its file's code).
CODE_KINDS = {3: WALL, 7: SYMMETRY, 10: VELOCITY_INLET, 4: PRESSURE, 5: PRESSURE}

_FLOAT_FIELDS = (
    "bc_vel", "bc_p", "area", "normal", "face_centroid", "lw", "r_on", "dist_on", "dist_fo",
    "cell_centroid", "volume",
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A face list with its geometry and boundary conditions: owner and
    neighbour [F] (-1 on the boundary), kind [F], the zone velocity
    bc_vel [F, 3] and pressure bc_p [F]; area, unit normal out of the
    owner, centroid; lw = |x_o - x_f| / (|x_o - x_f| + |x_n - x_f|),
    r_on (owner to neighbour, or to the face on the boundary), its length
    dist_on, dist_fo = |x_f - x_o|; cell centroids and volumes."""

    owner: torch.Tensor
    neighbour: torch.Tensor
    kind: torch.Tensor
    bc_vel: torch.Tensor
    bc_p: torch.Tensor
    area: torch.Tensor
    normal: torch.Tensor
    face_centroid: torch.Tensor
    lw: torch.Tensor
    r_on: torch.Tensor
    dist_on: torch.Tensor
    dist_fo: torch.Tensor
    cell_centroid: torch.Tensor
    volume: torch.Tensor
    dim: int
    dtype: torch.dtype
    device: torch.device

    @property
    def n_cells(self) -> int:
        return self.volume.shape[0]

    @property
    def interior(self):
        return self.kind == INTERIOR

    @property
    def other(self):
        """Neighbour, with the owner on boundary faces (a safe index)."""
        return torch.where(self.interior, self.neighbour, self.owner)

    def is_(self, *kinds):
        m = self.kind == kinds[0]
        for k in kinds[1:]:
            m = m | (self.kind == k)
        return m

    def to_dtype(self, dtype) -> "Mesh":
        """The same mesh with its geometry and values in `dtype`."""
        cast = {k: getattr(self, k).to(dtype) for k in _FLOAT_FIELDS}
        return dataclasses.replace(self, dtype=dtype, **cast)

    def scatter(self, on_owner, on_neighbour=None):
        """Per cell: the sum of `on_owner` [..., F] over the faces it owns
        and of `on_neighbour` over the interior faces it neighbours."""
        out = torch.zeros((*on_owner.shape[:-1], self.n_cells), dtype=on_owner.dtype, device=self.device)
        out.index_add_(out.ndim - 1, self.owner, on_owner)
        if on_neighbour is not None:
            inner = self.interior
            out.index_add_(out.ndim - 1, self.neighbour[inner], on_neighbour[..., inner])
        return out


def make_mesh(grid, boundaries, dtype=torch.float64, device="cpu") -> Mesh:
    """The reference mesh of a Grid (cfdbench/meshes) under the case-file
    boundaries {zone name: {"type", "velocity", "pressure"}}; zones the
    boundaries do not name keep their file's condition code."""
    dev = torch.device(device)
    f64 = torch.float64

    def t(x, dt=f64):
        return torch.as_tensor(x, device=dev).to(dt)

    pts = t(grid.points)
    nodes = t(grid.face_nodes, torch.long)
    cells = t(grid.face_cells, torch.long)
    own, nbr = cells[:, 0], cells[:, 1]
    dim = int(grid.dim)
    C = int(grid.n_cells)

    # Zones: kind, velocity and pressure per face.
    zk, zv, zp = [], [], []
    for name, code in grid.zones:
        spec = boundaries.get(name)
        if code == 2:
            kind = INTERIOR
        elif spec is not None:
            kind = KINDS[spec.get("type", "wall")]
        else:
            kind = CODE_KINDS[int(code)]
        zk.append(kind)
        zv.append([float(v) for v in (spec or {}).get("velocity", (0.0, 0.0, 0.0))])
        zp.append(float((spec or {}).get("pressure", 0.0)))
    zone = t(grid.face_zone, torch.long)
    kind = t(zk, torch.long)[zone]
    if bool(torch.any((kind == INTERIOR) != (nbr >= 0))):
        raise ValueError("interior zones must hold exactly the faces with two cells")

    # Face geometry.
    p = pts[nodes]  # [F, M, 3]
    xf = p.mean(dim=1)
    if dim == 2:
        tv = p[:, 1] - p[:, 0]
        raw_n = torch.stack([-tv[:, 1], tv[:, 0], torch.zeros_like(tv[:, 0])], dim=1)
        area = torch.linalg.vector_norm(tv, dim=1)
    else:
        raw_n = torch.linalg.cross(p[:, 2] - p[:, 1], p[:, 1] - p[:, 0], dim=1)
        e1 = p - xf[:, None]
        e2 = torch.roll(p, -1, dims=1) - xf[:, None]
        area = 0.5 * torch.linalg.vector_norm(torch.linalg.cross(e1, e2, dim=2), dim=2).sum(dim=1)
    n = raw_n / torch.linalg.vector_norm(raw_n, dim=1, keepdim=True)

    # Cells: the mean of their faces' centroids; normals out of the owner.
    count = torch.zeros(C, dtype=f64, device=dev)
    xc = torch.zeros((C, 3), dtype=f64, device=dev)
    inner = nbr >= 0
    for cell, sel in ((own, slice(None)), (nbr[inner], inner)):
        count.index_add_(0, cell, torch.ones_like(xf[sel][:, 0]))
        xc.index_add_(0, cell, xf[sel])
    xc = xc / count[:, None]
    n = n * torch.sign(torch.sum(n * (xf - xc[own]), dim=1))[:, None]
    vol = torch.zeros(C, dtype=f64, device=dev)
    nb = torch.where(inner, nbr, own)
    vol.index_add_(0, own, area * torch.abs(torch.sum((xf - xc[own]) * n, dim=1)) / dim)
    vol.index_add_(0, nbr[inner], (area * torch.abs(torch.sum((xf - xc[nb]) * n, dim=1)) / dim)[inner])

    # Interpolation geometry.
    dx0 = torch.linalg.vector_norm(xc[own] - xf, dim=1)
    dx1 = torch.linalg.vector_norm(xc[nb] - xf, dim=1)
    lw = torch.where(inner, dx0 / (dx0 + dx1), torch.zeros_like(dx0))
    r_on = torch.where(inner[:, None], xc[nb] - xc[own], xf - xc[own])
    mesh = Mesh(
        owner=own, neighbour=nbr, kind=kind, bc_vel=t(zv)[zone], bc_p=t(zp)[zone],
        area=area, normal=n, face_centroid=xf, lw=lw, r_on=r_on,
        dist_on=torch.linalg.vector_norm(r_on, dim=1), dist_fo=dx0,
        cell_centroid=xc, volume=vol, dim=dim, dtype=f64, device=dev,
    )
    return mesh.to_dtype(dtype)


# --- face values and gradients -----------------------------------------------


def _dot(a, b):
    """Sum over the component axis of [3, F] fields."""
    return torch.sum(a * b, dim=0)


def face_velocity_linear(m: Mesh, vel):
    """Linear face velocities [3, F]: walls and velocity inlets their zone
    velocity, pressure faces and symmetry planes the owner's."""
    own, nbr = vel[:, m.owner], vel[:, m.other]
    inner = 0.5 * (own + nbr)
    bnd = torch.where(m.is_(WALL, VELOCITY_INLET), m.bc_vel.T, own)
    return torch.where(m.interior, inner, bnd)


def face_pressure(m: Mesh, p, weighted: bool):
    """Face pressures [F]: interior the mean (weighted by lw, or not);
    pressure faces the zone pressure; other faces the owner's."""
    own, nbr = p[m.owner], p[m.other]
    inner = own + (nbr - own) * m.lw if weighted else 0.5 * (own + nbr)
    return torch.where(m.interior, inner, torch.where(m.is_(PRESSURE), m.bc_p, own))


def green_gauss(m: Mesh, phi_f):
    """sum_f phi_f n_out A / V: [F] -> [3 (axis), C]; [3, F] -> [3
    (component), 3 (axis), C]."""
    flow = phi_f[..., None, :] * (m.normal.T * m.area)  # [..., 3, F]
    return m.scatter(flow, -flow) / m.volume


def grad_scalar(m: Mesh, p):
    """Green-Gauss cell gradient of p [3, C] from linear face values."""
    return green_gauss(m, face_pressure(m, p, weighted=False))


def grad_velocity(m: Mesh, vel):
    """Green-Gauss cell gradient [3 (component), 3 (axis), C] from the
    linear face velocities."""
    return green_gauss(m, face_velocity_linear(m, vel))


def normal_coeff(md, cells, n):
    """|(a_u n_x, a_v n_y, a_w n_z)| of each face: md [3, C] the momentum
    diagonals, `cells` [F] the cells read, n [F, 3]."""
    return torch.linalg.vector_norm(md[:, cells] * n.T, dim=0)


def face_flux(m: Mesh, vel, scheme, p=None, grad_p=None, md=None, with_pressure=True):
    """Face velocities [F] out of the owner. Interior: the linear
    (`linear`, `linear_weighted`) face velocity along n, or Rhie-Chow
    0.5 (term1 + term2 + term3) (without term2 when not `with_pressure`,
    the SIMPLE_FC predictor). Boundary: 0 at walls and symmetry planes,
    the zone velocity along n at velocity inlets, the owner's at pressure
    faces."""
    n = m.normal.T  # [3, F]
    v_o, v_n = vel[:, m.owner], vel[:, m.other]
    if scheme in ("linear", "linear_weighted"):
        vf = v_o + (v_n - v_o) * m.lw if scheme == "linear_weighted" else 0.5 * (v_o + v_n)
        inner = _dot(vf, n)
    elif scheme == "rhie_chow":
        voa_o = m.volume[m.owner] / normal_coeff(md, m.owner, m.normal)
        voa_n = m.volume[m.other] / normal_coeff(md, m.other, m.normal)
        total = _dot(v_o + v_n, n)
        if with_pressure:
            total = total + (voa_o + voa_n) * (p[m.owner] - p[m.other]) / m.dist_on
        g = voa_o * grad_p[:, m.owner] + voa_n * grad_p[:, m.other]
        inner = 0.5 * (total + _dot(g, m.r_on.T) / m.dist_on)
    else:
        raise ValueError(f"the reference takes linear, linear_weighted and rhie_chow faces, not {scheme}")
    bnd = torch.where(m.is_(VELOCITY_INLET), _dot(m.bc_vel.T, n), _dot(v_o, n))
    zero = torch.zeros((), dtype=inner.dtype, device=inner.device)
    return torch.where(m.interior, inner, torch.where(m.is_(WALL, SYMMETRY), zero, bnd))


# --- momentum ------------------------------------------------------------------


@dataclasses.dataclass
class Momentum:
    """The momentum matrix shared by u, v, w: the relaxed diagonal [C];
    per interior face `up`, the owner's coefficient to the neighbour,
    and `down`, the neighbour's to the owner ([F], zero elsewhere);
    b [3, C]."""

    mesh: Mesh
    diag: torch.Tensor
    up: torch.Tensor
    down: torch.Tensor
    b: torch.Tensor

    def off_times(self, x):
        """Sum over neighbours of coefficient * x_nb for x [..., C]."""
        m = self.mesh
        return m.scatter(self.up * x[..., m.other], self.down * x[..., m.owner])


def momentum_system(m: Mesh, params, vel, p, flux, grad_v=None) -> Momentum:
    """One iteration's momentum system (ops/assembly `momentum_system`,
    UD or TVD_DC, with implicit relaxation): upwind convection by the
    face velocities `flux`, central diffusion (mu A / dist_on inside,
    mu A / dist_fo at walls and velocity inlets), the face pressure force,
    at walls and velocity inlets the diffusive source and the advective
    one (a_nb - F) v_bc = -max(F, 0) v_bc, TVD_DC's deferred correction."""
    rho, mu, alpha = params["rho"], params["mu"], params["alpha_u"]
    scheme = params["momentum"]
    psi = LIMITERS.get(scheme)
    if scheme != "ud" and psi is None:
        raise ValueError(f"the reference takes ud and tvd_dc_* momentum, not {scheme}")
    if params["relaxation_mode"] != "implicit":
        raise ValueError("the reference takes implicit relaxation only")
    if params["pressure_interpolation"] not in ("linear", "linear_weighted"):
        raise ValueError(f"the reference takes linear face pressures, not {params['pressure_interpolation']}")
    inner = m.interior
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    mf = rho * m.area * flux  # mass flow out of the owner
    d_in = mu * m.area / m.dist_on
    dirichlet = m.is_(WALL, VELOCITY_INLET)
    d_bnd = torch.where(dirichlet, mu * m.area / m.dist_fo, zero)
    out_o = torch.clamp(mf, min=0.0)
    out_n = torch.where(inner, torch.clamp(-mf, min=0.0), zero)
    a_p = m.scatter(out_o + torch.where(inner, d_in, d_bnd), out_n + torch.where(inner, d_in, zero))
    up = torch.where(inner, torch.clamp(mf, max=0.0) - d_in, zero)
    down = torch.where(inner, torch.clamp(-mf, max=0.0) - d_in, zero)
    # Right-hand side: the pressure force, the Dirichlet sources.
    force = m.normal.T * (face_pressure(m, p, params["pressure_interpolation"] == "linear_weighted") * m.area)
    src = torch.where(dirichlet, d_bnd - out_o, zero) * m.bc_vel.T
    b = m.scatter(src - force, force)
    if psi is not None:
        b = b + _tvd_dc_source(m, mf, vel, grad_v, psi)
    b = b + (1.0 - alpha) / alpha * a_p * vel
    return Momentum(mesh=m, diag=a_p / alpha, up=up, down=down, b=b)


def _tvd_dc_source(m: Mesh, mf, vel, grad_v, psi):
    """Deferred-correction source of TVD_DC: on each interior face
    q = F psi(r) / 2 (phi_D - phi_U), r = 2 grad_U . r_UD / (phi_D -
    phi_U) - 1 from the upwind cell's gradient; the owner loses q, the
    neighbour gains it."""
    own, nbr = m.owner, m.other
    pos = mf > 0
    v_o, v_n = vel[:, own], vel[:, nbr]
    delta = torch.where(pos, v_n - v_o, v_o - v_n)
    r_on = m.r_on.T[None]  # [1, 3, F]
    g_o = torch.sum(grad_v[:, :, own] * r_on, dim=1)
    g_n = -torch.sum(grad_v[:, :, nbr] * r_on, dim=1)
    gdotr = torch.where(pos, g_o, g_n)
    one = torch.ones((), dtype=m.dtype, device=m.device)
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    r = 2.0 * gdotr / torch.where(delta == 0.0, one, delta) - 1.0
    q = torch.where(m.interior, mf, zero) * torch.where(delta == 0.0, zero, psi(r) / 2.0 * delta)
    return m.scatter(-q, q)


def jacobi_smooth(mom: Momentum, x0, sweeps: int, omega: float):
    """Fixed-count damped Jacobi on u, v, w (the momentum smoother):
    x <- omega (b - off x) / diag + (1 - omega) x."""
    x = x0
    for _ in range(sweeps):
        x = omega * (mom.b - mom.off_times(x)) / mom.diag + (1.0 - omega) * x
    return x


# --- pressure systems and corrections --------------------------------------------


@dataclasses.dataclass
class Pressure:
    """A symmetric pressure system: per interior face the coefficient
    coef [F] (zero elsewhere), an extra diagonal [C], the right-hand
    side b [C]."""

    mesh: Mesh
    coef: torch.Tensor
    extra: torch.Tensor
    b: torch.Tensor

    def apply(self, x):
        """(A x) per cell: sum_faces coef (x_c - x_nb) + extra x_c."""
        m = self.mesh
        flow = self.coef * (x[m.owner] - x[m.other])
        return self.extra * x + m.scatter(flow, -flow)

    def diag(self):
        return self.extra + self.mesh.scatter(self.coef, self.coef)


def net_outflow(m: Mesh, flux, rho):
    """rho A times the sum of each cell's outward face velocities."""
    mf = rho * m.area * flux
    return m.scatter(mf, -mf)


def simple_pressure_system(m: Mesh, flux2, md, rho) -> Pressure:
    """The SIMPLE p' system (ops/assembly.pressure_correction_system):
    interior couplings rho A^2 / a_f, a_f = 0.5 |(md_o + md_n) n|; every
    boundary face adds rho A^2 / a_c / 2 to its cell's diagonal; b the
    net mass inflow."""
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    a2 = rho * m.area * m.area
    a_f = 0.5 * torch.linalg.vector_norm((md[:, m.owner] + md[:, m.other]) * m.normal.T, dim=0)
    coef = torch.where(m.interior, a2 / a_f, zero)
    bnd = torch.where(m.interior, zero, a2 / normal_coeff(md, m.owner, m.normal) / 2.0)
    return Pressure(mesh=m, coef=coef, extra=m.scatter(bnd), b=-net_outflow(m, flux2, rho))


def fc_coupling(m: Mesh, md, rho):
    """SIMPLE_FC coefficients d [F]: interior 0.5 rho A (V_o/a_o +
    V_n/a_n) / dist_on; pressure faces rho A (V_o/a_o) / dist_fo; walls,
    symmetry planes and velocity inlets 0."""
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    voa_o = m.volume[m.owner] / normal_coeff(md, m.owner, m.normal)
    voa_n = m.volume[m.other] / normal_coeff(md, m.other, m.normal)
    d_in = 0.5 * rho * m.area * (voa_o + voa_n) / m.dist_on
    d_p = rho * m.area * voa_o / m.dist_fo
    return torch.where(m.interior, d_in, torch.where(m.is_(PRESSURE), d_p, zero))


def fc_pressure_system(m: Mesh, flux_h, d, rho) -> Pressure:
    """The full-p system of SIMPLE_FC: sum_int d (p_c - p_nb) + sum_pf d
    (p_c - p_bc) = -rho A sum flux_h."""
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    d_p = torch.where(m.is_(PRESSURE), d, zero)
    b = -net_outflow(m, flux_h, rho) + m.scatter(d_p * m.bc_p)
    return Pressure(mesh=m, coef=torch.where(m.interior, d, zero), extra=m.scatter(d_p), b=b)


def correct_flux(m: Mesh, flux_h, d, rho, p_new):
    """Conservative SIMPLE_FC face velocities: flux_h + d / (rho A)
    (p_o - p_n) inside, (p_o - p_bc) at pressure faces."""
    own = p_new[m.owner]
    delta = torch.where(m.interior, own - p_new[m.other], own - m.bc_p)
    return flux_h + d / (rho * m.area) * delta


def velocity_correction(m: Mesh, pp, md, face_value: bool):
    """Cell velocity correction [3, C] of a pressure increment pp: (A /
    md) sum_f n_out (pp_c - pp_f), with pp_f inside the neighbour's
    value (cell difference) or the mean (face value), 0 at pressure
    faces, the cell's own elsewhere."""
    own, nbr = pp[m.owner], pp[m.other]
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    pf = torch.where(m.is_(PRESSURE), zero, own)
    if face_value:
        inner = 0.5 * (own - nbr)
        d_o, d_n = torch.where(m.interior, inner, own - pf), -inner
    else:
        d_o, d_n = torch.where(m.interior, own - nbr, own - pf), nbr - own
    flow = m.normal.T * m.area  # [3, F]
    return m.scatter(flow * d_o, -flow * d_n) / md


def has_pressure_faces(m: Mesh) -> bool:
    return bool(torch.any(m.is_(PRESSURE)))
