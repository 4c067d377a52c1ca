"""Plain finite-volume mathematics on a uniform box, the reference that
decides `correct`.

A frozen, independent restatement of the face-major SIMPLE and
SIMPLE_FC iterations of orc_tpu_torch (ops/interpolation.py,
ops/gradients.py, ops/assembly.py, solver/fc.py, solver/krylov.py) for
the one geometry the benchmark runs: a uniform nx x ny x nz box whose
six boundary planes are walls (with a wall velocity) or symmetry
planes, so that no mass crosses the boundary.

Layout: a cell field is [Z, Y, X] (x fastest, so a flat view is the
cell id i + nx (j + ny k)); a vector field is [3, Z, Y, X]. A face
field along axis a (0 = x, 1 = y, 2 = z) has one more entry along that
axis: entry i is the plane between cells i - 1 and i, 0 and n_a the
boundary planes. Face velocities point along +e_a. Plain torch only; it
imports nothing of the program, and the caller turns TF32 off.
"""

from __future__ import annotations

import dataclasses

import torch

WALL = "wall"
SYMMETRY = "symmetry"

#: Boundary zone names of the program's generated box, by (axis, side).
PLANE_ZONES = {
    (0, 0): "INLET",
    (0, 1): "OUTLET",
    (1, 0): "BOTTOM_WALL",
    (1, 1): "TOP_WALL",
    (2, 0): "PERIODIC_-Z",
    (2, 1): "PERIODIC_+Z",
}


@dataclasses.dataclass(frozen=True)
class Box:
    """Uniform box: dims (nx, ny, nz), spacing h per axis, and each
    boundary plane's condition {(axis, side): (kind, wall velocity)}."""

    dims: tuple
    h: tuple
    bc: dict
    dtype: torch.dtype
    device: torch.device

    @property
    def volume(self) -> float:
        return self.h[0] * self.h[1] * self.h[2]

    def area(self, a: int) -> float:
        return self.volume / self.h[a]

    def to_dtype(self, dtype) -> "Box":
        """The same box computing in `dtype`."""
        return dataclasses.replace(self, dtype=dtype)

    def zeros(self, *lead):
        nx, ny, nz = self.dims
        return torch.zeros((*lead, nz, ny, nx), dtype=self.dtype, device=self.device)


def make_box(dims, lengths, boundaries, dtype, device) -> Box:
    """Box from its dims, lengths and the case-file boundaries
    {zone name: {"type": "wall" | "symmetry", "velocity": [..]}}."""
    bc = {}
    for key, zone in PLANE_ZONES.items():
        spec = boundaries[zone]
        kind = spec.get("type", WALL)
        if kind not in (WALL, SYMMETRY):
            raise ValueError(f"the reference takes walls and symmetry planes, not {kind}")
        vw = tuple(float(v) for v in spec.get("velocity", (0.0, 0.0, 0.0)))
        bc[key] = (kind, vw)
    h = tuple(float(L) / n for L, n in zip(lengths, dims))
    return Box(tuple(int(d) for d in dims), h, bc, dtype, torch.device(device))


# --- face arrays -------------------------------------------------------------


def _d(x, a):
    """Tensor dimension of axis a in x (grid dims last, x fastest)."""
    return x.ndim - 1 - a


def _n(x, a):
    return x.shape[_d(x, a)]


def lo_cells(x, a):
    """Cell values below each interior face of axis a (cells 0 .. n-2)."""
    return x.narrow(_d(x, a), 0, _n(x, a) - 1)


def hi_cells(x, a):
    """Cell values above each interior face of axis a (cells 1 .. n-1)."""
    return x.narrow(_d(x, a), 1, _n(x, a) - 1)


def interior(f, a):
    """Interior entries (1 .. n_a - 1) of a face array."""
    return f.narrow(_d(f, a), 1, _n(f, a) - 2)


def first_plane(x, a):
    return x.narrow(_d(x, a), 0, 1)


def last_plane(x, a):
    return x.narrow(_d(x, a), _n(x, a) - 1, 1)


def with_planes(inner, lo, hi, a):
    """Face array of axis a from interior entries and both planes."""
    return torch.cat([lo, inner, hi], dim=_d(inner, a))


def closed(inner, like, a):
    """Face array with zero on both boundary planes."""
    z = torch.zeros_like(first_plane(like, a))
    return with_planes(inner, z, z, a)


def face_diff(f, a):
    """Per cell: its upper face value minus its lower one."""
    n = _n(f, a) - 1
    return f.narrow(_d(f, a), 1, n) - f.narrow(_d(f, a), 0, n)


def end_cells(a, n_a, side):
    """Index of the first (side 0) or last (side 1) cell plane of axis a
    in a [Z, Y, X] field."""
    idx = [slice(None)] * 3
    idx[2 - a] = 0 if side == 0 else n_a - 1
    return tuple(idx)


# --- interpolation and gradients -------------------------------------------


def face_scalar_linear(p, a):
    """Linear face values of a cell scalar; walls and symmetry planes
    take the owner's value."""
    inner = 0.5 * (lo_cells(p, a) + hi_cells(p, a))
    return with_planes(inner, first_plane(p, a), last_plane(p, a), a)


def face_velocity_linear(box: Box, vel, a):
    """Linear face velocities [3, ...]: walls the wall velocity,
    symmetry planes the owner's."""
    inner = 0.5 * (lo_cells(vel, a) + hi_cells(vel, a))
    planes = []
    for side, own in ((0, first_plane(vel, a)), (1, last_plane(vel, a))):
        kind, vw = box.bc[(a, side)]
        if kind == WALL:
            w = torch.tensor(vw, dtype=box.dtype, device=box.device)
            planes.append(w.view(3, 1, 1, 1) * torch.ones_like(own))
        else:
            planes.append(own)
    return with_planes(inner, planes[0], planes[1], a)


def grad_scalar(box: Box, p):
    """Green-Gauss cell gradient [3, ...] from linear face values."""
    return torch.stack([face_diff(face_scalar_linear(p, a), a) / box.h[a] for a in range(3)])


def grad_velocity(box: Box, vel):
    """Green-Gauss cell gradient [3 (component), 3 (axis), ...] from the
    linear face velocities."""
    return torch.stack(
        [face_diff(face_velocity_linear(box, vel, a), a) / box.h[a] for a in range(3)],
        dim=1,
    )


# --- limiters ----------------------------------------------------------------


def psi_umist(r):
    m = torch.minimum(
        torch.minimum(2.0 * r, (1.0 + 3.0 * r) / 4.0),
        torch.minimum((3.0 + r) / 4.0, torch.full_like(r, 2.0)),
    )
    return torch.clamp(m, min=0.0)


LIMITERS = {"tvd_dc_umist": psi_umist}


# --- momentum ------------------------------------------------------------------


@dataclasses.dataclass
class Momentum:
    """The momentum matrix shared by u, v, w and the right-hand sides:
    the relaxed diagonal [...]; per axis the interior couplings as face
    arrays, `up` the lower cell's coefficient to the upper one and
    `down` the upper cell's to the lower one; b [3, ...]."""

    diag: torch.Tensor
    up: list
    down: list
    b: torch.Tensor

    def off_times(self, x):
        """Sum over neighbours of coefficient * x_nb for x [..., Z, Y, X]."""
        out = torch.zeros_like(x)
        for a in range(3):
            if _n(x, a) < 2:
                continue
            up, down = interior(self.up[a], a), interior(self.down[a], a)
            lo_cells(out, a).add_(up * hi_cells(x, a))
            hi_cells(out, a).add_(down * lo_cells(x, a))
        return out


def momentum_system(box: Box, params, vel, p, flux, grad_v=None) -> Momentum:
    """One iteration's momentum system: UD or TVD_DC convection by the
    face velocities `flux` (one face array per axis), central diffusion,
    the linear face pressure force, implicit relaxation (ops/assembly
    `momentum_system` with walls and symmetry planes only, where the
    Dirichlet advection source is zero)."""
    rho, mu, alpha = params["rho"], params["mu"], params["alpha_u"]
    scheme = params["momentum"]
    psi = LIMITERS.get(scheme)
    if scheme != "ud" and psi is None:
        raise ValueError(f"the reference takes ud and tvd_dc_* momentum, not {scheme}")
    a_p = box.zeros()
    b = box.zeros(3)
    up, down = [], []
    for a in range(3):
        A, h, n_a = box.area(a), box.h[a], box.dims[a]
        d_int = mu * A / h
        m = rho * A * flux[a]  # mass flow along +e_a
        # Upwind outflow through each cell's upper and lower face.
        a_p = a_p + torch.clamp(m.narrow(_d(m, a), 1, n_a), min=0.0)
        a_p = a_p + torch.clamp(-m.narrow(_d(m, a), 0, n_a), min=0.0)
        m_in = interior(m, a)
        up.append(closed(torch.clamp(m_in, max=0.0) - d_int, m, a))
        down.append(closed(torch.clamp(-m_in, max=0.0) - d_int, m, a))
        # Diffusion: d_int per interior face; an end cell's boundary face
        # adds 2 mu A / h at a wall (and its wall velocity to b), nothing
        # at a symmetry plane.
        dd = torch.full_like(a_p, 2.0 * d_int)
        for side in (0, 1):
            idx = end_cells(a, n_a, side)
            kind, vw = box.bc[(a, side)]
            dd[idx] -= d_int
            if kind == WALL:
                dd[idx] += 2.0 * d_int
                for comp in range(3):
                    b[(comp, *idx)] += 2.0 * d_int * vw[comp]
        a_p = a_p + dd
        # Pressure force on component a.
        b[a] = b[a] - A * face_diff(face_scalar_linear(p, a), a)
        if psi is not None:
            b = b + _tvd_dc_source(box, a, m, vel, grad_v, psi)
    b = b + (1.0 - alpha) / alpha * a_p * vel
    return Momentum(diag=a_p / alpha, up=up, down=down, b=b)


def _tvd_dc_source(box: Box, a, m, vel, grad_v, psi):
    """Deferred-correction source of TVD_DC along axis a: on each
    interior face q = m psi(r) / 2 (phi_D - phi_U), r from the upwind
    cell's gradient; the lower cell loses q, the upper one gains it."""
    h = box.h[a]
    m_in = interior(m, a)
    v_lo, v_hi = lo_cells(vel, a), hi_cells(vel, a)
    pos = m_in > 0
    delta = torch.where(pos, v_hi - v_lo, v_lo - v_hi)
    gdotr = torch.where(pos, h * lo_cells(grad_v[:, a], a), -h * hi_cells(grad_v[:, a], a))
    one = torch.ones((), dtype=m.dtype, device=m.device)
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    r = 2.0 * gdotr / torch.where(delta == 0.0, one, delta) - 1.0
    q = m_in * torch.where(delta == 0.0, zero, psi(r) / 2.0 * delta)
    src = torch.zeros_like(vel)
    lo_cells(src, a).sub_(q)
    hi_cells(src, a).add_(q)
    return src


def jacobi_smooth(mom: Momentum, x0, sweeps: int, omega: float):
    """Fixed-count damped Jacobi on u, v, w (the momentum smoother):
    x <- omega (b - off x) / diag + (1 - omega) x."""
    x = x0
    for _ in range(sweeps):
        x = omega * (mom.b - mom.off_times(x)) / mom.diag + (1.0 - omega) * x
    return x


# --- face velocities and pressure systems ---------------------------------------


@dataclasses.dataclass
class Pressure:
    """A symmetric pressure system: per axis the interior face
    coefficient (a face array, zero on the boundary planes), an extra
    diagonal [...], the right-hand side b [...]."""

    coef: list
    extra: torch.Tensor
    b: torch.Tensor

    def apply(self, x):
        """(A x) per cell: sum_faces coef (x_c - x_nb) + extra x_c."""
        out = self.extra * x
        for a in range(3):
            if _n(x, a) < 2:
                continue
            flow = interior(self.coef[a], a) * (lo_cells(x, a) - hi_cells(x, a))
            lo_cells(out, a).add_(flow)
            hi_cells(out, a).sub_(flow)
        return out

    def diag(self):
        out = self.extra.clone()
        for a in range(3):
            n = _n(self.coef[a], a) - 1
            c = self.coef[a]
            out = out + c.narrow(_d(c, a), 0, n) + c.narrow(_d(c, a), 1, n)
        return out


def net_outflow(box: Box, flux, rho):
    """rho A times the sum of each cell's outward face velocities."""
    return sum(rho * box.area(a) * face_diff(flux[a], a) for a in range(3))


def linear_flux(vel):
    """Linear face velocities along +e_a, zero on the boundary planes."""
    return [closed(0.5 * (lo_cells(vel[a], a) + hi_cells(vel[a], a)), vel[a], a) for a in range(3)]


def rhie_chow_flux(box: Box, vel, p, grad_p, md, with_pressure: bool):
    """Rhie-Chow face velocities along +e_a, 0.5 (term1 + term2 + term3)
    of ops/interpolation.face_flux, or without term2, the SIMPLE_FC
    predictor of solver/fc.face_flux_h; zero on the boundary planes."""
    voa = box.volume / md
    out = []
    for a in range(3):
        v_lo, v_hi = lo_cells(voa, a), hi_cells(voa, a)
        total = lo_cells(vel[a], a) + hi_cells(vel[a], a)
        total = total + v_lo * lo_cells(grad_p[a], a) + v_hi * hi_cells(grad_p[a], a)
        if with_pressure:
            total = total + (v_lo + v_hi) * (lo_cells(p, a) - hi_cells(p, a)) / box.h[a]
        out.append(closed(0.5 * total, p, a))
    return out


def fc_coupling(box: Box, md, rho):
    """SIMPLE_FC coefficients d = 0.5 rho A (V/a_lo + V/a_hi) / h of the
    interior faces (walls and symmetry planes: 0)."""
    voa = box.volume / md
    return [
        closed(0.5 * rho * box.area(a) * (lo_cells(voa, a) + hi_cells(voa, a)) / box.h[a], md, a)
        for a in range(3)
    ]


def fc_pressure_system(box: Box, flux_h, d, rho) -> Pressure:
    """The full-p system of SIMPLE_FC: sum_int d (p_c - p_nb) =
    -rho A sum flux_h (walls and symmetry planes add nothing)."""
    b = -net_outflow(box, flux_h, rho)
    return Pressure(coef=d, extra=torch.zeros_like(b), b=b)


def simple_pressure_system(box: Box, flux2, md, rho) -> Pressure:
    """The SIMPLE p' system (ops/assembly.pressure_correction_system):
    interior couplings rho A^2 / (0.5 (a_lo + a_hi)), every boundary face
    rho A^2 / a_c / 2 on the diagonal, b the net mass inflow."""
    coef = []
    extra = torch.zeros_like(md)
    for a in range(3):
        A = box.area(a)
        coef.append(closed(rho * A * A / (0.5 * (lo_cells(md, a) + hi_cells(md, a))), md, a))
        bnd = rho * A * A / md / 2.0
        for side in (0, 1):
            idx = end_cells(a, box.dims[a], side)
            extra[idx] += bnd[idx]
    return Pressure(coef=coef, extra=extra, b=-net_outflow(box, flux2, rho))


def correct_flux(box: Box, flux_h, d, rho, p_new):
    """Conservative SIMPLE_FC face velocities: flux_h + d / (rho A)
    (p_lo - p_hi) on the interior faces."""
    return [
        flux_h[a]
        + closed(
            interior(d[a], a) / (rho * box.area(a)) * (lo_cells(p_new, a) - hi_cells(p_new, a)),
            p_new,
            a,
        )
        for a in range(3)
    ]


def velocity_correction(box: Box, pp, md, face_value: bool):
    """Cell velocity correction [3, ...] of a pressure increment pp:
    (A / md) sum_f n_out (pp_c - pp_f), with pp_f on interior faces the
    neighbour's value (cell difference) or the mean (face value), and
    the cell's own on walls and symmetry planes."""
    corr = []
    for a in range(3):
        upper = torch.zeros_like(pp)  # pp_c - pp_f of each cell's upper face
        lower = torch.zeros_like(pp)  # ... and of its lower face
        if _n(pp, a) > 1:
            lo, hi = lo_cells(pp, a), hi_cells(pp, a)
            if face_value:
                lo_cells(upper, a).copy_(0.5 * (lo - hi))
                hi_cells(lower, a).copy_(0.5 * (hi - lo))
            else:
                lo_cells(upper, a).copy_(lo - hi)
                hi_cells(lower, a).copy_(hi - lo)
        corr.append(box.area(a) / md * (upper - lower))
    return torch.stack(corr)


def deflate(x):
    """x minus its mean (the constant mode of a pressure system that no
    boundary anchors)."""
    return x - x.mean()


def bicgstab(sys: Pressure, x0, iterations: int, threshold: float, project):
    """Jacobi-preconditioned BiCGSTAB with the relative exit
    ||r|| <= threshold ||r0||, for the reference put in the program's
    place (the lower-precision control)."""
    inv_d = 1.0 / sys.diag()
    b = sys.b * inv_d

    def mv(v):
        return project(sys.apply(v) * inv_d)

    def dot(u, v):
        return torch.sum(u * v)

    x = x0
    r = project(b - mv(x))
    r_hat, p = r, r
    rho = dot(r, r_hat)
    r0 = torch.sqrt(dot(r, r))
    for _ in range(iterations):
        nu = mv(p)
        alpha = rho / dot(r_hat, nu)
        s = r - alpha * nu
        t = mv(s)
        omega = dot(t, s) / dot(t, t)
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho_new = dot(r_hat, r)
        p = r + (rho_new / rho) * (alpha / omega) * (p - omega * nu)
        rho = rho_new
        if not bool(torch.sqrt(dot(r, r)) > threshold * r0):
            break
    return project(x)
