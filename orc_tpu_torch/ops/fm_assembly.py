"""The face-major momentum assembly as one hand-written kernel
(csrc/fm_assembly.cu): `face_pressure` followed by `momentum_system`
(ops/interpolation.py, ops/assembly.py) in one pass over the cells.

orc_tpu has no kernel for this phase: its face-major assembly is plain
jnp, about a hundred eager ops over [C,K] and [C,K,3] temporaries here.
The kernel takes the schemes whose u, v and w systems share one matrix
(UD, CD1, TVD_DC with a limiter of `fused_assembly.LIMITER_CODES`) under
LINEAR or LINEAR_WEIGHTED face pressures, steady or with the inertia of
a transient step, under IMPLICIT or EXPLICIT relaxation, in float32 or
float64, on any mesh: structured boxes, RCM-ordered irregular meshes and
a partition's local tables alike. It returns what the plain pair returns
less the momentum source, which the caller adds after it, as on the
(c,k) kernel path. `takes` says which configurations it computes; the
face-major steps run it on a CUDA mesh when it does
(`solver.simple.face_momentum`), `fm_momentum_plain` otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from orc_tpu_torch.ops import _cuda
from orc_tpu_torch.ops.assembly import momentum_system
from orc_tpu_torch.ops.ck_ops import mesh_matrix
from orc_tpu_torch.ops.fused_assembly import LIMITER_CODES
from orc_tpu_torch.ops.interpolation import face_pressure
from orc_tpu_torch.utils.settings import (
    MomentumScheme,
    PressureInterpolation,
    RelaxationMode,
)

#: csrc/assembly.cuh Scheme.
_SCHEMES = {MomentumScheme.UD: 0, MomentumScheme.CD1: 1, MomentumScheme.TVD_DC: 2}
_FACE_PRESSURES = (PressureInterpolation.LINEAR, PressureInterpolation.LINEAR_WEIGHTED)


def takes(settings, dtype) -> bool:
    """Whether the kernel computes the face-major momentum assembly of
    `settings` in `dtype`: a shared-matrix scheme (UD, CD1, TVD_DC with a
    limiter that has a code), LINEAR or LINEAR_WEIGHTED face pressures,
    float32 or float64."""
    return (
        settings.momentum in _SCHEMES
        and settings.pressure_interpolation in _FACE_PRESSURES
        and dtype in _cuda.DTYPE_CODES
        and (
            settings.momentum != MomentumScheme.TVD_DC
            or settings.tvd_psi in LIMITER_CODES
        )
    )


def fm_momentum_plain(
    mesh, fbc, settings, rho, vel, flux, p, diff, grad_vel=None, inertia=None,
    grad_p=None,
):
    """The plain face-major momentum assembly: `face_pressure` +
    `momentum_system`, (EllMatrix, b [3,C], pe [C,3]). The face-major
    steps run it where the kernel does not take the configuration, and
    the tests hold the kernel against it; the kernel computes the same
    less `settings.momentum_source`, which its caller adds after it."""
    p_f = face_pressure(mesh, fbc, p, settings.pressure_interpolation, grad_p=grad_p)
    return momentum_system(
        mesh, fbc, settings, rho, vel, flux, p_f, diff, grad_vel=grad_vel,
        inertia=inertia,
    )


def _ptr(t):
    return None if t is None else t.data_ptr()


def fm_momentum_assembly(
    mesh, fbc, settings, rho, vel, flux, p, diff, grad_vel=None, inertia=None
):
    """The kernel launch: `fm_momentum_plain`'s result less the momentum
    source (EllMatrix over diag [C] and off [C,K] in K contiguous [C]
    planes, b [3,C], pe [C,3]) from vel [C,3], p [C], the face flux [F]
    (owner-outward), the mesh's DiffusionSystem, grad_vel [C,3,3] under
    TVD_DC and, in transient runs, `inertia` = (rv_dt [C], vel_n [C,3]);
    `rho` a number. Every
    tensor lies on one device (a CUDA one, but for the CPU rehearsal of
    the tests); raises ValueError for a configuration `takes` refuses."""
    if not takes(settings, vel.dtype):
        raise ValueError(
            f"the face-major momentum kernel does not take {settings.momentum}, "
            f"{settings.pressure_interpolation} face pressures in {vel.dtype}"
        )
    C, K = mesh.cell_faces.shape
    dt = vel.dtype
    tvd = settings.momentum == MomentumScheme.TVD_DC
    weighted = settings.pressure_interpolation == PressureInterpolation.LINEAR_WEIGHTED
    if tuple(vel.shape) != (C, 3) or tuple(p.shape) != (C,):
        raise ValueError(f"vel must be [{C},3] and p [{C}]")
    if tuple(flux.shape) != (mesh.n_faces,):
        raise ValueError(f"flux must be [{mesh.n_faces}], got {tuple(flux.shape)}")
    if tvd and (grad_vel is None or tuple(grad_vel.shape) != (C, 3, 3)):
        raise ValueError(f"TVD_DC needs grad_vel [{C},3,3]")
    rv_dt = vel_n = None
    if inertia is not None:
        rv_dt, vel_n = inertia
        if tuple(rv_dt.shape) != (C,) or tuple(vel_n.shape) != (C, 3):
            raise ValueError(f"inertia must be (rv_dt [{C}], vel_n [{C},3])")
    i32, b8 = torch.int32, torch.bool
    inputs = {  # name: (tensor, dtype), in the kernel's order
        "cell_faces": (mesh.cell_faces, i32),
        "cell_neighbors": (mesh.cell_neighbors, i32),
        "cell_face_sign": (mesh.cell_face_sign, dt),
        "cell_face_mask": (mesh.cell_face_mask, b8),
        "diff_off": (diff.off, dt),
        "flux": (flux, dt),
        "face_area": (mesh.face_area, dt),
        "face_interior": (mesh.face_interior, b8),
        "face_zone_slot": (mesh.face_zone_slot, i32),
        "face_normal": (mesh.face_normal, dt),
        "face_r_on": (mesh.face_r_on if tvd else None, dt),
        "face_lw": (mesh.face_lw if weighted else None, dt),
        "zone_codes": (fbc.zcode, i32),
        "zone_scalar": (fbc.zscalar, dt),
        "zone_vector": (fbc.zvector, dt),
        "vel": (vel, dt),
        "p": (p, dt),
        "grad_vel": (grad_vel if tvd else None, dt),
        "diff_diag": (diff.diag, dt),
        "diff_b": (diff.b, dt),
        "rv_dt": (rv_dt, dt),
        "vel_n": (vel_n, dt),
    }
    given = {}
    for name, (t, want) in inputs.items():
        if t is not None:
            if t.dtype != want:
                raise TypeError(f"{name} is {t.dtype}, the kernel takes {want}")
            given[name] = t.contiguous()
    _cuda.check_cuda(vel.device, **given)
    diag = torch.empty((C,), dtype=dt, device=vel.device)
    off = torch.empty((K, C), dtype=dt, device=vel.device)
    b = torch.empty((3, C), dtype=dt, device=vel.device)
    pe = torch.empty((C, 3), dtype=dt, device=vel.device)
    ptrs = (ctypes.c_void_p * 26)(
        *(_ptr(given.get(k)) for k in inputs), *(t.data_ptr() for t in (diag, off, b, pe))
    )
    implicit = settings.relaxation_mode == RelaxationMode.IMPLICIT
    alpha = float(settings.momentum_relaxation)
    _cuda.call(
        "orc_fm_momentum_assembly", vel.device, _cuda.dtype_code(vel),
        _SCHEMES[settings.momentum],
        LIMITER_CODES[settings.tvd_psi] if tvd else 0, K, int(weighted),
        int(implicit), ptrs, float(rho), (1.0 - alpha) / alpha, alpha, C,
    )
    fm_momentum_assembly.launches += 1
    if inertia is not None:
        fm_momentum_assembly.transient_launches += 1
    return mesh_matrix(mesh, diag, off.T), b, pe


#: Kernel launches since the last reset; `transient_launches` counts the
#: launches with the inertia term among them.
fm_momentum_assembly.launches = 0
fm_momentum_assembly.transient_launches = 0
