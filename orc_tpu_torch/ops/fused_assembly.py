"""Fused momentum and pressure assembly kernels, parity SIMPLE and
SIMPLE_FC.

Replaces orc_tpu/ops/pallas_assembly.py:
- `_momentum_kernel`, parity branch (via `momentum_assembly` ->
  `_momentum_asm`) -> `momentum_assembly` (csrc/parity_assembly.cuh);
- `_pc_kernel` (via `pc_assembly`) -> `pc_assembly`
  (csrc/parity_assembly.cuh);
- `_momentum_kernel`, SIMPLE_FC branch (via `fc_momentum_assembly`) ->
  `fc_momentum_assembly` (csrc/assembly.cu);
- `_fc_pc_kernel` (via `fc_pc_assembly`) -> `fc_pc_assembly`
  (csrc/assembly.cu).

One pass over the cell fields of a uniform structured box writes the
shared momentum matrix (diag [C], off [C,K]) with its three right-hand
sides, or the pressure(-correction) system, keeping every per-face
intermediate in registers. On the card the wrappers launch the CUDA
kernels; on CPU tensors they run the plain versions, which compose the
ported ck ops (the oracle orc_tpu pins its kernels against) and return
the kernels' output format.

Covered, under implicit relaxation, every branch of orc_tpu's kernels:
UD / CD1 / TVD_DC advection (parity: with the face flux computed from
the velocity; SIMPLE_FC: with the stored flux), Linear[Weighted] or
Rhie-Chow face fluxes, Linear[Weighted] or SecondOrder face pressures,
for the parity kernels the Green-Gauss pressure gradient computed in the
kernel (`AsmSpec.gg`) or streamed as [C,3], and for both momentum
kernels the implicit-Euler inertia term of transient runs (`inertia` =
(rv_dt [C], vel_n [C,3])). A CUDA kernel takes no Python callable, so
the TVD limiter `AsmSpec.psi` travels as a code (`LIMITER_CODES`:
tvd_lud, tvd_quick, tvd_umist); the kernel gate returns None for any
other limiter. Momentum sources are added by the caller after the
kernel, as orc_tpu does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from orc_tpu_torch.ops import _cuda
from orc_tpu_torch.ops.ck_ops import (
    UniformCKGeometry,
    ck_bc,
    ck_diffusion,
    ck_face_pressure,
    ck_flux,
    ck_momentum,
    ck_pressure_correction,
    ck_pressure_gradient,
    nbr_values,
)
from orc_tpu_torch.ops.fields import (
    INTERIOR,
    PRESSURE_OUTLET,
    SYMMETRY,
    VELOCITY_INLET,
    WALL,
)
from orc_tpu_torch.utils.settings import (
    MomentumScheme,
    NumericalSettings,
    PressureInterpolation,
    RelaxationMode,
    VelocityInterpolation,
    tvd_lud,
    tvd_quick,
    tvd_umist,
)


class ColumnSpec(NamedTuple):
    """Static per-ELL-column description of a uniform box mesh."""

    offset: int  # flat neighbor index delta (0 for z columns of a 2D box)
    area: float
    n_out: tuple  # (nx, ny, nz) outward unit normal, column-constant
    dist_fo: float  # |x_face - x_c|
    dist_on: float  # interior |x_nbr - x_c|
    kind: str  # "wall" | "symmetry" | "pressure" | "vinlet"
    zone: int  # zone slot (row of the bc-values table)


class AsmSpec(NamedTuple):
    """Static scheme selection, as orc_tpu's AsmSpec."""

    scheme: str = "ud"  # "ud" | "cd1" | "tvd_dc"
    rc: bool = False  # Rhie-Chow face fluxes (else Linear[Weighted])
    p_so: bool = False  # SecondOrder face pressures (else Linear[W])
    psi: object = None  # TVD limiter (tvd_dc only), a key of LIMITER_CODES
    vol: float = 0.0  # uniform cell volume (Rhie-Chow, GG, FC d-coefficients)
    # Parity kernels: compute the Green-Gauss cell pressure gradient in
    # the kernel from p (two hops: a neighbour's gradient reads its
    # neighbours' p) instead of reading a streamed [C,3] grad p. The
    # SIMPLE_FC kernels always read it streamed (orc_tpu forces gg off).
    gg: bool = False


ACTIVE_BIT = 6  # flag bit marking real (non-padded) cells
_KINDS = ("wall", "symmetry", "pressure", "vinlet")  # csrc/assembly.cu Kind
_SCHEMES = {"ud": 0, "cd1": 1, "tvd_dc": 2}
#: TVD limiters the SIMPLE_FC momentum kernel evaluates, by code
#: (csrc/assembly.cu `tvd_psi`).
LIMITER_CODES = {tvd_lud: 0, tvd_quick: 1, tvd_umist: 2}


def pack_flags(interior, mask):
    """[C] int32 per-cell flags: bit k = column k interior, bit 6 =
    active row."""
    C, K = interior.shape
    if K > ACTIVE_BIT:
        raise ValueError(f"pack_flags holds at most {ACTIVE_BIT} columns")
    f = torch.zeros((C,), dtype=torch.int32, device=interior.device)
    for k in range(K):
        f = f | (interior[:, k].to(torch.int32) << k)
    return f | (mask.any(dim=1).to(torch.int32) << ACTIVE_BIT)


def column_specs(mesh, table) -> "tuple | None":
    """The static ColumnSpec tuple of a uniform mesh (ck_constants +
    zone table), or None when ineligible (non-uniform mesh, unsupported
    BC kinds, or periodic wrap columns)."""
    from orc_tpu_torch.mesh.zones import FaceCondition
    from orc_tpu_torch.solver.gmg import infer_box_dims

    if mesh.ck_constants is None or mesh.neighbor_offsets is None:
        return None
    _int_slot, colc = mesh.ck_constants
    offsets = mesh.neighbor_offsets
    if len(colc) != len(offsets):
        return None
    dims = infer_box_dims(offsets, mesh.n_cells)
    if dims is None:
        return None
    nx, ny, _nz = dims
    strides = {1, nx, nx * ny}
    slot_types = {
        table.slot_of_zone[zid]: fz.zone_type for zid, fz in table.zones.items()
    }
    kinds = {
        FaceCondition.WALL: "wall",
        FaceCondition.SYMMETRY: "symmetry",
        FaceCondition.PRESSURE_INLET: "pressure",
        FaceCondition.PRESSURE_OUTLET: "pressure",
        FaceCondition.VELOCITY_INLET: "vinlet",
    }
    cols = []
    for off, (area, n_out, dist_fo, dist_on, zslot) in zip(offsets, colc):
        if abs(off) not in strides and off != 0:
            return None  # periodic wrap column
        kind = kinds.get(slot_types.get(int(zslot)))
        if kind is None:
            return None
        cols.append(
            ColumnSpec(
                offset=int(off),
                area=float(area),
                n_out=tuple(float(c) for c in n_out),
                dist_fo=float(dist_fo),
                dist_on=float(dist_on),
                kind=kind,
                zone=int(zslot),
            )
        )
    return tuple(cols)


@functools.lru_cache(maxsize=64)
def box_dims(cols, n_cells):
    """(nx, ny, nz) of the box whose cell (x, y, z) is row
    x + nx (y + ny z), with every axis of extent 1 moved last (a 2-D
    box is (nx, ny, 1)): the tiling of the parity momentum, pressure-
    correction and SIMPLE_FC momentum kernels. Raises ValueError when
    the columns' offsets describe no box."""
    from orc_tpu_torch.solver.gmg import infer_box_dims

    dims = infer_box_dims(tuple(c.offset for c in cols), n_cells)
    if dims is None:
        raise ValueError(
            f"the column offsets {[c.offset for c in cols]} describe no box of "
            f"{n_cells} cells"
        )
    dims = [d for d in dims if d > 1]
    return tuple(dims + [1] * (3 - len(dims)))


def kernel_box(cols, n_cells, box=None):
    """(nx, ny, nz, row0) of the box the tiled kernels launch over, whose
    cell (x, y, z) is row x + nx (y + ny z) - row0: `box_dims(cols,
    n_cells)` from row 0, or the given (nx, ny, nz, row0), which must be
    the fewest planes of nx x ny cells holding rows [0, n_cells) from
    row0 on. A slab partition's window (parallel/partition.py) is such a
    box: it starts row0 cells into its first plane, and its trash row
    (the last) may end inside the last plane."""
    if box is None:
        return (*box_dims(cols, n_cells), 0)
    nx, ny, nz, row0 = (int(d) for d in box)
    plane = nx * ny
    if not (0 <= row0 < plane and nz == -(-(row0 + n_cells) // plane)):
        raise ValueError(
            f"the box {(nx, ny, nz)} from row {row0} is not the planes that "
            f"hold {n_cells} rows"
        )
    return nx, ny, nz, row0


def bc_value_table(zone_scalar, zone_vector):
    """[Z,4] (vx, vy, vz, pressure) rows of the device zone tables."""
    return torch.cat([zone_vector, zone_scalar[:, None]], dim=1)


# --- plain versions (compositions of the ck ops) ----------------------


class _Box(NamedTuple):
    """The mesh attributes the ck ops read on this path."""

    neighbor_offsets: tuple
    cell_volume: "torch.Tensor | None" = None  # read by the FC flux model


def _ck_from_columns(flags, cols, bc_values):
    """(mesh view, UniformCKGeometry, CKBC) rebuilt from the kernels'
    inputs. Interior faces select an extra zone slot Z coded INTERIOR,
    so the geometry needs nothing beyond the column specs."""
    K = len(cols)
    dt, dev = bc_values.dtype, bc_values.device
    bits = torch.arange(K, dtype=torch.int32, device=dev)
    interior = ((flags[:, None] >> bits) & 1) == 1
    active = ((flags >> ACTIVE_BIT) & 1) == 1
    mask = active[:, None].expand(-1, K)
    Z = bc_values.shape[0]
    ck = UniformCKGeometry(
        interior=interior,
        mask=mask,
        c_area=torch.tensor([c.area for c in cols], dtype=dt, device=dev),
        c_n_out=torch.tensor([c.n_out for c in cols], dtype=dt, device=dev),
        c_dist_fo=torch.tensor([c.dist_fo for c in cols], dtype=dt, device=dev),
        c_dist_on=torch.tensor([c.dist_on for c in cols], dtype=dt, device=dev),
        c_zone=torch.tensor([c.zone for c in cols], dtype=torch.int32, device=dev),
        int_slot=Z,
        n_zones=Z + 1,
    )
    code_of = {
        "wall": WALL,
        "symmetry": SYMMETRY,
        "pressure": PRESSURE_OUTLET,
        "vinlet": VELOCITY_INLET,
    }
    codes = [INTERIOR] * (Z + 1)
    for c in cols:
        codes[c.zone] = code_of[c.kind]
    zc = torch.tensor(codes, dtype=torch.int32, device=dev)
    zero = torch.zeros((1,), dtype=dt, device=dev)
    zs = torch.cat([bc_values[:, 3], zero])
    zv = torch.cat([bc_values[:, :3], zero.expand(1, 3)])
    box = _Box(neighbor_offsets=tuple(c.offset for c in cols))
    return box, ck, ck_bc(ck, zc, zs, zv)


def _check_spec(spec: AsmSpec, inertia=None, C=None):
    """Raise on what no kernel computes: an unknown scheme, TVD_DC
    without a limiter, an inertia pair that is not (rv_dt [C],
    vel_n [C,3])."""
    if spec.scheme not in _SCHEMES:
        raise ValueError(f"unknown momentum scheme {spec.scheme!r}")
    if spec.scheme == "tvd_dc" and spec.psi is None:
        raise ValueError("the tvd_dc scheme needs a limiter spec.psi")
    if inertia is not None:
        if len(inertia) != 2:
            raise ValueError("inertia must be the pair (rv_dt [C], vel_n [C,3])")
        rv_dt, vel_n = inertia
        if C is not None and (
            tuple(rv_dt.shape) != (C,) or tuple(vel_n.shape) != (C, 3)
        ):
            raise ValueError(
                f"inertia needs rv_dt [{C}] and vel_n [{C},3], got "
                f"{tuple(rv_dt.shape)} and {tuple(vel_n.shape)}"
            )


def _settings_of(spec: AsmSpec, alpha) -> NumericalSettings:
    return NumericalSettings(
        momentum={
            "ud": MomentumScheme.UD,
            "cd1": MomentumScheme.CD1,
            "tvd_dc": MomentumScheme.TVD_DC,
        }[spec.scheme],
        tvd_psi=spec.psi,
        relaxation_mode=RelaxationMode.IMPLICIT,
        momentum_relaxation=float(alpha),
    )


def _face_gradient(box, ck, bc, p, grad_p, spec: AsmSpec):
    """(grad p [C,3], its neighbour values [C,K,3]) of the parity
    kernels' Rhie-Chow and SecondOrder terms: the Green-Gauss gradient
    of p under spec.gg, else the streamed `grad_p`."""
    if spec.gg:
        grad_p = ck_pressure_gradient(box, ck, bc, p)
    return grad_p, nbr_values(box, grad_p, ck.interior)


def momentum_assembly_plain(
    vel, p, bc_values, flags, cols, rho, mu, alpha, grad_p=None,
    mom_diag=None, grad_vel=None, inertia=None, spec: AsmSpec = AsmSpec(),
):
    """Plain torch momentum assembly: (diag [C], off [C,K], b [3,C]),
    orc_tpu's ck path (ck_flux, ck_face_pressure, ck_momentum) with the
    spec's face models and, in transient runs, the inertia term."""
    _check_spec(spec, inertia, p.shape[0])
    box, ck, bc = _ck_from_columns(flags, cols, bc_values)
    box = box._replace(cell_volume=torch.full_like(p, spec.vol))
    gp = gp_nbr = md3 = None
    if spec.rc or spec.p_so:
        gp, gp_nbr = _face_gradient(box, ck, bc, p, grad_p, spec)
    if spec.rc:
        md3 = mom_diag[:, None].expand(-1, 3)
    vi = (
        VelocityInterpolation.RHIE_CHOW if spec.rc
        else VelocityInterpolation.LINEAR
    )
    flux = ck_flux(
        box, ck, bc, vel, vi, p=p, grad_p=gp, grad_p_nbr=gp_nbr, mom_diag=md3
    )
    F = flux * ck.area * rho
    pi = (
        PressureInterpolation.SECOND_ORDER if spec.p_so
        else PressureInterpolation.LINEAR
    )
    p_f = ck_face_pressure(box, ck, bc, p, pi, grad_p=gp, grad_p_nbr=gp_nbr)
    diff = ck_diffusion(box, ck, bc, mu)
    A, b, _pe = ck_momentum(
        box, ck, bc, _settings_of(spec, alpha), rho, vel, F, p_f, *diff,
        grad_vel=grad_vel, inertia=inertia,
    )
    return A.diag, A.off, b


def pc_assembly_plain(
    vel, mom_diag, bc_values, flags, cols, rho, p=None, grad_p=None,
    spec: AsmSpec = AsmSpec(),
):
    """Plain torch pressure-correction assembly: (diag, off [C,K], b),
    the face flux Linear or, under spec.rc, Rhie-Chow from the
    iteration-start p and its gradient (in-kernel GG or streamed)."""
    spec = spec._replace(gg=spec.gg and spec.rc)
    _check_spec(spec)
    box, ck, bc = _ck_from_columns(flags, cols, bc_values)
    md3 = mom_diag[:, None].expand(-1, 3)
    if spec.rc:
        box = box._replace(cell_volume=torch.full_like(mom_diag, spec.vol))
        gp, gp_nbr = _face_gradient(box, ck, bc, p, grad_p, spec)
        flux2 = ck_flux(
            box, ck, bc, vel, VelocityInterpolation.RHIE_CHOW, p=p, grad_p=gp,
            grad_p_nbr=gp_nbr, mom_diag=md3,
        )
    else:
        flux2 = ck_flux(box, ck, bc, vel, VelocityInterpolation.LINEAR)
    F2 = flux2 * ck.area * rho
    P, b = ck_pressure_correction(box, ck, bc, rho, F2, md3)
    return P.diag, P.off, b


def fc_momentum_assembly_plain(
    vel, p, flux, bc_values, flags, cols, rho, mu, alpha, grad_p=None,
    grad_vel=None, inertia=None, spec: AsmSpec = AsmSpec(),
):
    """Plain torch SIMPLE_FC momentum assembly: ck_momentum fed with the
    stored flux, F = flux * area * rho -> (diag [C], off [C,K], b [3,C]),
    with the inertia term in transient runs."""
    _check_spec(spec, inertia, p.shape[0])
    box, ck, bc = _ck_from_columns(flags, cols, bc_values)
    F = flux * ck.area * rho
    if spec.p_so:
        p_f = ck_face_pressure(
            box, ck, bc, p, PressureInterpolation.SECOND_ORDER,
            grad_p=grad_p, grad_p_nbr=nbr_values(box, grad_p, ck.interior),
        )
    else:
        p_f = ck_face_pressure(box, ck, bc, p, PressureInterpolation.LINEAR)
    diff = ck_diffusion(box, ck, bc, mu)
    A, b, _pe = ck_momentum(
        box, ck, bc, _settings_of(spec, alpha), rho, vel, F, p_f, *diff,
        grad_vel=grad_vel, inertia=inertia,
    )
    return A.diag, A.off, b


def fc_pc_assembly_plain(
    vel, mom_diag, bc_values, flags, cols, rho, grad_p=None,
    spec: AsmSpec = AsmSpec(),
):
    """Plain torch SIMPLE_FC full-p assembly: ck_flux_h + ck_d_coeffs +
    ck_fc_pressure_system -> (diag [C], off [C,K], b [C], flux_h [C,K])."""
    from orc_tpu_torch.solver.fc import (
        ck_d_coeffs,
        ck_fc_pressure_system,
        ck_flux_h,
    )

    _check_spec(spec)
    box, ck, bc = _ck_from_columns(flags, cols, bc_values)
    box = box._replace(cell_volume=torch.full_like(mom_diag, spec.vol))
    md3 = mom_diag[:, None].expand(-1, 3)
    scheme = (
        VelocityInterpolation.RHIE_CHOW if spec.rc
        else VelocityInterpolation.LINEAR
    )
    flux_h = ck_flux_h(box, ck, bc, vel, scheme, grad_p=grad_p, mom_diag=md3)
    d_ck = ck_d_coeffs(box, ck, bc, rho, md3)
    P, b = ck_fc_pressure_system(box, ck, bc, rho, flux_h, d_ck)
    return P.diag, P.off, b, flux_h


# --- kernel wrappers --------------------------------------------------


def _col_args(cols):
    K = len(cols)
    offs = (ctypes.c_longlong * K)(*(c.offset for c in cols))
    geom = (ctypes.c_double * (6 * K))(
        *(v for c in cols for v in (c.area, *c.n_out, c.dist_fo, c.dist_on))
    )
    kind = (ctypes.c_int * K)(*(_KINDS.index(c.kind) for c in cols))
    zone = (ctypes.c_int * K)(*(c.zone for c in cols))
    return offs, geom, kind, zone


def _check_inputs(vel, bc_values, flags, cols, **fields):
    C = vel.shape[0]
    if vel.shape != (C, 3):
        raise ValueError(f"vel must be [C,3], got {tuple(vel.shape)}")
    if not 1 <= len(cols) <= _cuda.MAX_K:
        raise ValueError(f"1..{_cuda.MAX_K} columns, got {len(cols)}")
    if flags.shape != (C,) or flags.dtype != torch.int32:
        raise ValueError("flags must be a [C] int32 tensor (pack_flags)")
    if bc_values.ndim != 2 or bc_values.shape[1] != 4:
        raise ValueError("bc_values must be [Z,4] (bc_value_table)")
    if any(c.zone >= bc_values.shape[0] for c in cols):
        raise ValueError("a column's zone slot lies outside bc_values")
    for name, t in dict(bc_values=bc_values, **fields).items():
        if t.dtype != vel.dtype:
            raise TypeError(f"{name} is {t.dtype}, vel is {vel.dtype}")
        if t.shape[0] != C and name != "bc_values":
            raise ValueError(f"{name} has {t.shape[0]} rows, vel has {C}")
    _cuda.check_cuda(vel.device, bc_values=bc_values, flags=flags, **fields)


def momentum_assembly(
    vel, p, bc_values, flags, cols: tuple, rho, mu, alpha, grad_p=None,
    mom_diag=None, grad_vel=None, inertia=None, spec: AsmSpec = AsmSpec(),
    box=None,
):
    """Fused momentum assembly on a uniform box.

    vel [C,3], p [C] -> (diag [C], off [C,K], b [3,C]) in the shared-
    matrix form; `cols` from column_specs, `flags` from pack_flags,
    `bc_values` [Z,4] from bc_value_table; rho / mu / alpha are Python
    numbers. Scheme-dependent extras, as orc_tpu's: `grad_p` [C,3] under
    spec.rc or spec.p_so unless spec.gg, `mom_diag` [C] (the shared
    diagonal of the previous iteration) under spec.rc, `grad_vel`
    [C,3,3] under "tvd_dc"; spec.vol is the cell volume. In transient
    runs `inertia` = (rv_dt [C], vel_n [C,3]) adds rho V/dt to the
    diagonal and rho V/dt vel^n to the RHS before the relaxation. `off`
    is a [C,K] view of K contiguous [C] planes. `box` (nx, ny, nz, row0)
    is the box the kernel tiles when it is not the one the columns'
    offsets give for C cells (see `kernel_box`). CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if not vel.is_cuda:
        return momentum_assembly_plain(
            vel, p, bc_values, flags, cols, rho, mu, alpha, grad_p, mom_diag,
            grad_vel, inertia, spec,
        )
    return _launch_momentum(
        vel, p, bc_values, flags, cols, rho, mu, alpha, grad_p, mom_diag,
        grad_vel, inertia, spec, box,
    )


def _limiter_code(spec: AsmSpec) -> int:
    if spec.scheme != "tvd_dc":
        return 0
    if spec.psi not in LIMITER_CODES:
        raise ValueError(f"limiter {spec.psi!r} has no kernel code (LIMITER_CODES)")
    return LIMITER_CODES[spec.psi]


def _inertia_ptrs(inertia, extra):
    """(rv_dt, vel_n) made contiguous and added to `extra`, the inputs
    _check_inputs holds to vel's rows, dtype and device; (None, None) in
    steady runs: the C entry points take them as nullable pointers."""
    if inertia is None:
        return None, None
    rv_dt, vel_n = (t.contiguous() for t in inertia)
    extra.update(rv_dt=rv_dt, vel_n=vel_n)
    return rv_dt, vel_n


def _need(t, shape, what):
    """`t` made contiguous, or ValueError naming `what` when it is
    missing or misshapen."""
    if t is None or tuple(t.shape) != shape:
        raise ValueError(f"{what} needs a {list(shape)} tensor")
    return t.contiguous()


def _launch_momentum(
    vel, p, bc_values, flags, cols, rho, mu, alpha, grad_p, mom_diag,
    grad_vel, inertia, spec, box=None,
):
    """The kernel launch of `momentum_assembly` (checks included)."""
    C, K = vel.shape[0], len(cols)
    _check_spec(spec, inertia, C)
    psi = _limiter_code(spec)
    gg = spec.gg and (spec.rc or spec.p_so)
    extra = dict(p=p)
    if (spec.rc or spec.p_so) and not gg:
        extra["grad_p"] = grad_p = _need(grad_p, (C, 3), "a streamed gradient")
    else:
        grad_p = None
    if spec.rc:
        extra["mom_diag"] = mom_diag = _need(mom_diag, (C,), "spec.rc")
    else:
        mom_diag = None
    if spec.scheme == "tvd_dc":
        extra["grad_vel"] = grad_vel = _need(grad_vel, (C, 3, 3), "the tvd_dc scheme")
    else:
        grad_vel = None
    if (spec.rc or gg) and not spec.vol > 0:
        raise ValueError("spec.rc / spec.gg need the cell volume spec.vol > 0")
    rv_dt, vel_n = _inertia_ptrs(inertia, extra)
    _check_inputs(vel, bc_values, flags, cols, **extra)
    vel, p, bc_values = vel.contiguous(), p.contiguous(), bc_values.contiguous()
    flags = flags.contiguous()
    diag = torch.empty((C,), dtype=vel.dtype, device=vel.device)
    off = torch.empty((K, C), dtype=vel.dtype, device=vel.device)
    b = torch.empty((3, C), dtype=vel.dtype, device=vel.device)
    _cuda.call(
        "orc_momentum_assembly", vel.device, _cuda.dtype_code(vel),
        _SCHEMES[spec.scheme], psi, int(spec.rc), int(spec.p_so), int(gg),
        *_col_args(cols), K, *kernel_box(cols, C, box), vel.data_ptr(),
        p.data_ptr(),
        _ptr(grad_p), _ptr(mom_diag), _ptr(grad_vel), _ptr(rv_dt), _ptr(vel_n),
        bc_values.data_ptr(), flags.data_ptr(), float(rho), float(mu),
        float(alpha), float(spec.vol), diag.data_ptr(), off.data_ptr(),
        b.data_ptr(), C,
    )
    momentum_assembly.launches += 1
    if inertia is not None:
        momentum_assembly.transient_launches += 1
    return diag, off.T, b


def _ptr(t):
    return None if t is None else t.data_ptr()


def fc_momentum_assembly(
    vel, p, flux, bc_values, flags, cols: tuple, rho, mu, alpha,
    grad_p=None, grad_vel=None, inertia=None, spec: AsmSpec = AsmSpec(),
    box=None,
):
    """SIMPLE_FC fused momentum assembly on a uniform box: the parity
    assembly, advected with the stored conservative flux [C,K] (best
    passed as a view of K contiguous [C] planes, solver/fc.py `planes`,
    which the kernel reads without a copy).

    -> (diag [C], off [C,K], b [3,C]); `grad_p` [C,3] is read when
    spec.p_so, `grad_vel` [C,3,3] when spec.scheme is "tvd_dc", and
    `inertia` = (rv_dt [C], vel_n [C,3]) in transient runs; `box` as in
    momentum_assembly. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if not vel.is_cuda:
        return fc_momentum_assembly_plain(
            vel, p, flux, bc_values, flags, cols, rho, mu, alpha, grad_p,
            grad_vel, inertia, spec,
        )
    return _launch_fc_momentum(
        vel, p, flux, bc_values, flags, cols, rho, mu, alpha, grad_p,
        grad_vel, inertia, spec, box,
    )


def _launch_fc_momentum(
    vel, p, flux, bc_values, flags, cols, rho, mu, alpha, grad_p, grad_vel,
    inertia, spec, box=None,
):
    C, K = vel.shape[0], len(cols)
    _check_spec(spec, inertia, C)
    if flux.shape != (C, K):
        raise ValueError(f"flux must be [C,K] = {(C, K)}, got {tuple(flux.shape)}")
    psi = _limiter_code(spec)
    extra = dict(p=p, flux=flux)
    if spec.p_so:
        extra["grad_p"] = grad_p = _need(grad_p, (C, 3), "spec.p_so")
    else:
        grad_p = None
    if spec.scheme == "tvd_dc":
        extra["grad_vel"] = grad_vel = _need(grad_vel, (C, 3, 3), "the tvd_dc scheme")
    else:
        grad_vel = None
    rv_dt, vel_n = _inertia_ptrs(inertia, extra)
    _check_inputs(vel, bc_values, flags, cols, **extra)
    vel, p, bc_values = vel.contiguous(), p.contiguous(), bc_values.contiguous()
    flags = flags.contiguous()
    flux_planes = flux.T.contiguous()  # [K,C]; a view when already planes
    diag = torch.empty((C,), dtype=vel.dtype, device=vel.device)
    off = torch.empty((K, C), dtype=vel.dtype, device=vel.device)
    b = torch.empty((3, C), dtype=vel.dtype, device=vel.device)
    _cuda.call(
        "orc_fc_momentum_assembly", vel.device, _cuda.dtype_code(vel),
        _SCHEMES[spec.scheme], psi, int(spec.p_so), *_col_args(cols), K,
        *kernel_box(cols, C, box), vel.data_ptr(), p.data_ptr(),
        flux_planes.data_ptr(), _ptr(grad_p),
        _ptr(grad_vel), _ptr(rv_dt), _ptr(vel_n), bc_values.data_ptr(),
        flags.data_ptr(), float(rho), float(mu), float(alpha), diag.data_ptr(),
        off.data_ptr(), b.data_ptr(), C,
    )
    fc_momentum_assembly.launches += 1
    if inertia is not None:
        fc_momentum_assembly.transient_launches += 1
    return diag, off.T, b


def fc_pc_assembly(
    vel, mom_diag, bc_values, flags, cols: tuple, rho, grad_p=None,
    spec: AsmSpec = AsmSpec(), box=None,
):
    """SIMPLE_FC fused full-p continuity assembly on a uniform box.

    vel [C,3] (post-momentum), mom_diag [C] (shared momentum diagonal)
    -> (diag [C], off [C,K], b [C], flux_h [C,K]); with spec.rc,
    `grad_p` [C,3] is the iteration-start pressure gradient (the
    predictor's Rhie-Chow term3); the cell volume is spec.vol. `off`
    and `flux_h` are [C,K] views of K contiguous [C] planes; `box` as in
    momentum_assembly. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if not vel.is_cuda:
        return fc_pc_assembly_plain(
            vel, mom_diag, bc_values, flags, cols, rho, grad_p, spec
        )
    return _launch_fc_pc(
        vel, mom_diag, bc_values, flags, cols, rho, grad_p, spec, box
    )


def _launch_fc_pc(
    vel, mom_diag, bc_values, flags, cols, rho, grad_p, spec, box=None
):
    """The kernel launch of `fc_pc_assembly` (checks included)."""
    _check_spec(spec)
    C, K = vel.shape[0], len(cols)
    extra = dict(mom_diag=mom_diag)
    if spec.rc:
        extra["grad_p"] = grad_p = _need(grad_p, (C, 3), "spec.rc")
    else:
        grad_p = None
    _check_inputs(vel, bc_values, flags, cols, **extra)
    vel, mom_diag = vel.contiguous(), mom_diag.contiguous()
    bc_values, flags = bc_values.contiguous(), flags.contiguous()
    diag = torch.empty((C,), dtype=vel.dtype, device=vel.device)
    off = torch.empty((K, C), dtype=vel.dtype, device=vel.device)
    b = torch.empty((C,), dtype=vel.dtype, device=vel.device)
    flux_h = torch.empty((K, C), dtype=vel.dtype, device=vel.device)
    _cuda.call(
        "orc_fc_pc_assembly", vel.device, _cuda.dtype_code(vel), int(spec.rc),
        *_col_args(cols), K, *kernel_box(cols, C, box), vel.data_ptr(),
        mom_diag.data_ptr(),
        _ptr(grad_p), bc_values.data_ptr(), flags.data_ptr(), float(rho),
        float(spec.vol), diag.data_ptr(), off.data_ptr(), b.data_ptr(),
        flux_h.data_ptr(), C,
    )
    fc_pc_assembly.launches += 1
    return diag, off.T, b, flux_h.T


def pc_assembly(
    vel, mom_diag, bc_values, flags, cols: tuple, rho, p=None, grad_p=None,
    spec: AsmSpec = AsmSpec(), box=None,
):
    """Fused pressure-correction assembly on a uniform box.

    vel [C,3] (post-momentum), mom_diag [C] (shared momentum diagonal)
    -> (diag [C], off [C,K], b [C]) matching ck_pressure_correction with
    Linear[Weighted] face fluxes or, under spec.rc, Rhie-Chow ones from
    the iteration-start `p` [C] and its gradient (in the kernel under
    spec.gg, else the streamed `grad_p` [C,3]). gg applies under
    Rhie-Chow only, as orc_tpu forces; `box` as in momentum_assembly.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise."""
    if not vel.is_cuda:
        return pc_assembly_plain(
            vel, mom_diag, bc_values, flags, cols, rho, p, grad_p, spec
        )
    return _launch_pc(
        vel, mom_diag, bc_values, flags, cols, rho, p, grad_p, spec, box
    )


def _launch_pc(
    vel, mom_diag, bc_values, flags, cols, rho, p, grad_p, spec, box=None
):
    """The kernel launch of `pc_assembly` (checks included)."""
    spec = spec._replace(gg=spec.gg and spec.rc)
    _check_spec(spec)
    C, K = vel.shape[0], len(cols)
    extra = dict(mom_diag=mom_diag)
    if spec.rc:
        extra["p"] = p = _need(p, (C,), "spec.rc")
        if not spec.vol > 0:
            raise ValueError("spec.rc needs the cell volume spec.vol > 0")
    else:
        p = None
    if spec.rc and not spec.gg:
        extra["grad_p"] = grad_p = _need(grad_p, (C, 3), "spec.rc without gg")
    else:
        grad_p = None
    _check_inputs(vel, bc_values, flags, cols, **extra)
    vel, mom_diag = vel.contiguous(), mom_diag.contiguous()
    bc_values, flags = bc_values.contiguous(), flags.contiguous()
    diag = torch.empty((C,), dtype=vel.dtype, device=vel.device)
    off = torch.empty((K, C), dtype=vel.dtype, device=vel.device)
    b = torch.empty((C,), dtype=vel.dtype, device=vel.device)
    _cuda.call(
        "orc_pc_assembly", vel.device, _cuda.dtype_code(vel), int(spec.rc),
        int(spec.gg), *_col_args(cols), K, *kernel_box(cols, C, box),
        vel.data_ptr(),
        mom_diag.data_ptr(), _ptr(p), _ptr(grad_p), bc_values.data_ptr(),
        flags.data_ptr(),
        float(rho), float(spec.vol), diag.data_ptr(), off.data_ptr(),
        b.data_ptr(), C,
    )
    pc_assembly.launches += 1
    return diag, off.T, b


#: Kernel launches since the last reset; `transient_launches` counts the
#: launches of the momentum kernels' inertia branch among them.
momentum_assembly.launches = 0
momentum_assembly.transient_launches = 0
pc_assembly.launches = 0
fc_momentum_assembly.launches = 0
fc_momentum_assembly.transient_launches = 0
fc_pc_assembly.launches = 0
