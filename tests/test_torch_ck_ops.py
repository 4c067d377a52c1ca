"""Port (c,k) ops (orc_tpu_torch/ops/ck_ops.py) entry for entry against
orc_tpu's, in float64, on the 20x20 cavity, the 8^3 cavity, the 16x8
pressure-BC couette and the velocity-inlet channel of
tests/test_pallas_assembly.py, and off the uniform-box path on a
permuted 13^2 cavity (the expanded CKGeometry, the slice-plan neighbour
gather) and a graded 10^2 box (the expanded CKGeometry with shifts).

Tolerance: rtol 1e-10 (the same formulas in the same order; only sum
order may differ), plus atol 1e-13 x the largest reference magnitude
for entries that cancel to roundoff. The least-squares gradients hold
at rtol 1e-10 (closed-form solves against orc_tpu's LU), the CD2 and
in-matrix TVD systems (one matrix per component: diag [3,C], off
[3,C,K]) at rtol 1e-12."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity import CASES, IRREGULAR_CASES, both, cell_fields, np_, to_jax_settings

import jax.numpy as jnp
from orc_tpu.ops import ck_ops as jck
from orc_tpu.ops.fields import device_bc as jdevice_bc

from orc_tpu_torch.ops import ck_ops as tck
from orc_tpu_torch.ops.fields import device_bc as tdevice_bc
from orc_tpu_torch.utils import settings as tset

RTOL = 1e-10


def _close(actual, desired, name=""):
    d = np_(desired)
    scale = float(np.max(np.abs(d))) if d.size else 0.0
    np.testing.assert_allclose(
        np_(actual), d, rtol=RTOL, atol=1e-13 * scale, err_msg=name
    )


class Side:
    """One package's mesh, geometry, BCs and seeded fields of a case."""

    def __init__(self, ops, device_bc, mesh, table, arr, conv, fields):
        self.ops, self.mesh, self.arr = ops, mesh, arr
        self.conv = conv  # port settings -> this package's settings
        zc, zs, zv = device_bc(table)
        self.ck = ops.build_ck_geometry(mesh, len(table.zone_ids))
        self.bc = ops.ck_bc(self.ck, zc, zs, zv)
        vel, p, md = fields
        self.vel, self.p = arr(vel), arr(p)
        self.md3 = arr(np.repeat(md[:, None], 3, axis=1))  # cell-major [C,3]
        self.grad_p = ops.ck_pressure_gradient(mesh, self.ck, self.bc, self.p)
        self.gp_nbr = ops.nbr_values(mesh, self.grad_p, self.ck.interior)


def _f64(x):
    return torch.tensor(x, dtype=torch.float64)


def _sides(case):
    (mj, tj), (mt, tt) = both(case)
    fields = cell_fields(mj.n_cells)
    J = Side(jck, jdevice_bc, mj, tj, jnp.asarray, to_jax_settings, fields)
    T = Side(
        tck, lambda t: tdevice_bc(t, device="cpu"), mt, tt, _f64,
        lambda s: s, fields,
    )
    return J, T


def op_geometry(J, T):
    for name in ("area", "n_out", "w", "r_cf", "r_on", "dist_on", "dist_fo",
                 "zone_slot", "interior", "mask"):
        _close(getattr(T.ck, name), getattr(J.ck, name), name)


def op_bc(J, T):
    for name in type(T.bc)._fields:
        _close(getattr(T.bc, name), getattr(J.bc, name), name)


def op_nbr_values(J, T):
    for f in ("p", "vel", "grad_p"):
        _close(
            T.ops.nbr_values(T.mesh, getattr(T, f), T.ck.interior),
            J.ops.nbr_values(J.mesh, getattr(J, f), J.ck.interior),
            f,
        )


def op_face_pressure(J, T):
    for scheme in ("LINEAR", "LINEAR_WEIGHTED", "SECOND_ORDER"):
        outs = [
            S.ops.ck_face_pressure(
                S.mesh, S.ck, S.bc, S.p,
                S.conv(tset.PressureInterpolation[scheme]),
                grad_p=S.grad_p, grad_p_nbr=S.gp_nbr,
            )
            for S in (J, T)
        ]
        _close(outs[1], outs[0], scheme)


def op_flux(J, T):
    for scheme in ("LINEAR", "LINEAR_WEIGHTED", "RHIE_CHOW"):
        outs = [
            S.ops.ck_flux(
                S.mesh, S.ck, S.bc, S.vel,
                S.conv(tset.VelocityInterpolation[scheme]), p=S.p,
                grad_p=S.grad_p, grad_p_nbr=S.gp_nbr, mom_diag=S.md3,
            )
            for S in (J, T)
        ]
        _close(outs[1], outs[0], scheme)


def op_pressure_gradient(J, T):
    _close(T.grad_p, J.grad_p)


def op_diffusion(J, T):
    a = J.ops.ck_diffusion(J.mesh, J.ck, J.bc, J.arr(1e-3))
    b = T.ops.ck_diffusion(T.mesh, T.ck, T.bc, T.arr(1e-3))
    for name, x, y in zip(("diag", "off", "b"), b, a):
        _close(x, y, name)


def _momentum(S, settings, rho=1.0, mu=1e-3, grad_vel=None):
    vi = settings.velocity_interpolation
    flux = S.ops.ck_flux(S.mesh, S.ck, S.bc, S.vel, vi)
    F = flux * S.ck.area * rho
    p_f = S.ops.ck_face_pressure(
        S.mesh, S.ck, S.bc, S.p, settings.pressure_interpolation
    )
    diff = S.ops.ck_diffusion(S.mesh, S.ck, S.bc, S.arr(mu))
    return S.ops.ck_momentum(
        S.mesh, S.ck, S.bc, settings, rho, S.vel, F, p_f, *diff,
        grad_vel=grad_vel,
    )


def op_momentum(J, T):
    for scheme in (tset.MomentumScheme.UD, tset.MomentumScheme.CD1):
        for mode in tset.RelaxationMode:
            ts = tset.NumericalSettings(
                momentum=scheme,
                velocity_interpolation=tset.VelocityInterpolation.LINEAR_WEIGHTED,
                pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED,
                relaxation_mode=mode,
                momentum_relaxation=0.7,
            )
            Aj, bj, pej = _momentum(J, J.conv(ts))
            At, bt, pet = _momentum(T, T.conv(ts))
            tag = f"{scheme}/{mode}"
            assert At.offsets == Aj.offsets
            _close(At.diag, Aj.diag, tag + " diag")
            _close(At.off, Aj.off, tag + " off")
            _close(bt, bj, tag + " b")
            _close(pet, pej, tag + " pe")


def op_velocity_gradient(J, T):
    outs = [S.ops.ck_velocity_gradient(S.mesh, S.ck, S.bc, S.vel) for S in (J, T)]
    assert tuple(outs[1].shape) == outs[0].shape
    _close(outs[1], outs[0])


def op_momentum_tvd_dc(J, T):
    """TVD_DC with each limiter, both relaxation modes, the Green-Gauss
    velocity gradient of the fields and Rhie-Chow mass flows (so F
    changes sign across the box and both upwind branches run)."""
    for psi in (tset.tvd_lud, tset.tvd_quick, tset.tvd_umist):
        for mode in tset.RelaxationMode:
            ts = tset.NumericalSettings(
                momentum=tset.MomentumScheme.TVD_DC,
                tvd_psi=psi,
                pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED,
                relaxation_mode=mode,
                momentum_relaxation=0.7,
            )
            outs = []
            for S in (J, T):
                s = S.conv(ts)
                flux = S.ops.ck_flux(
                    S.mesh, S.ck, S.bc, S.vel,
                    S.conv(tset.VelocityInterpolation.RHIE_CHOW), p=S.p,
                    grad_p=S.grad_p, grad_p_nbr=S.gp_nbr, mom_diag=S.md3,
                )
                p_f = S.ops.ck_face_pressure(
                    S.mesh, S.ck, S.bc, S.p, s.pressure_interpolation
                )
                diff = S.ops.ck_diffusion(S.mesh, S.ck, S.bc, S.arr(1e-3))
                grad_v = S.ops.ck_velocity_gradient(S.mesh, S.ck, S.bc, S.vel)
                outs.append(
                    S.ops.ck_momentum(
                        S.mesh, S.ck, S.bc, s, 1.0, S.vel, flux * S.ck.area,
                        p_f, *diff, grad_vel=grad_v,
                    )
                )
            (Aj, bj, pej), (At, bt, pet) = outs
            tag = f"{psi.__name__}/{mode}"
            _close(At.diag, Aj.diag, tag + " diag")
            _close(At.off, Aj.off, tag + " off")
            _close(bt, bj, tag + " b")
            _close(pet, pej, tag + " pe")


def op_lsq_gradients(J, T):
    _close(
        T.ops.ck_lsq_pressure_gradient(T.mesh, T.ck, T.bc, T.p),
        J.ops.ck_lsq_pressure_gradient(J.mesh, J.ck, J.bc, J.p),
        "grad p",
    )
    _close(
        T.ops.ck_lsq_velocity_gradient(T.mesh, T.ck, T.bc, T.vel),
        J.ops.ck_lsq_velocity_gradient(J.mesh, J.ck, J.bc, J.vel),
        "grad vel",
    )


def _per_component_momentum(S, ts, inertia=None):
    """CD2 / TVD momentum system of S's fields with Rhie-Chow mass flows
    (F changes sign across the box) and the least-squares velocity
    gradient."""
    s = S.conv(ts)
    flux = S.ops.ck_flux(
        S.mesh, S.ck, S.bc, S.vel,
        S.conv(tset.VelocityInterpolation.RHIE_CHOW), p=S.p,
        grad_p=S.grad_p, grad_p_nbr=S.gp_nbr, mom_diag=S.md3,
    )
    p_f = S.ops.ck_face_pressure(S.mesh, S.ck, S.bc, S.p, s.pressure_interpolation)
    diff = S.ops.ck_diffusion(S.mesh, S.ck, S.bc, S.arr(1e-3))
    grad_v = S.ops.ck_lsq_velocity_gradient(S.mesh, S.ck, S.bc, S.vel)
    kw = {} if inertia is None else dict(inertia=tuple(S.arr(a) for a in inertia))
    return S.ops.ck_momentum(
        S.mesh, S.ck, S.bc, s, 1.0, S.vel, flux * S.ck.area, p_f, *diff,
        grad_vel=grad_v, **kw,
    )


def _assert_system(At, bt, pet, Aj, bj, pej, tag):
    """The port's [3,C] / [3,C,K] system against orc_tpu's at rtol 1e-12."""
    assert At.offsets == Aj.offsets
    for name, a, b in (("diag", At.diag, Aj.diag), ("off", At.off, Aj.off),
                       ("b", bt, bj), ("pe", pet, pej)):
        b = np_(b)
        assert tuple(a.shape) == b.shape, (tag, name)
        scale = float(np.max(np.abs(b)))
        np.testing.assert_allclose(
            np_(a), b, rtol=1e-12, atol=1e-13 * scale, err_msg=f"{tag} {name}"
        )


def op_momentum_per_component(J, T):
    """CD2 and TVD with each limiter, both relaxation modes, and CD2 with
    the transient inertia term: one matrix per velocity component."""
    rng = np.random.default_rng(7)
    inertia = (rng.uniform(0.5, 1.5, J.mesh.n_cells), rng.standard_normal((J.mesh.n_cells, 3)))
    runs = [("CD2", None, None), ("CD2", None, inertia)] + [
        ("TVD", psi, None) for psi in (tset.tvd_lud, tset.tvd_quick, tset.tvd_umist)
    ]
    for scheme, psi, inert in runs:
        for mode in tset.RelaxationMode:
            ts = tset.NumericalSettings(
                momentum=tset.MomentumScheme[scheme], tvd_psi=psi,
                pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED,
                relaxation_mode=mode, momentum_relaxation=0.7,
            )
            (Aj, bj, pej), (At, bt, pet) = (
                _per_component_momentum(S, ts, inert) for S in (J, T)
            )
            tag = f"{scheme}/{getattr(psi, '__name__', '')}/{mode}/{inert is not None}"
            assert At.diag.shape == (3, T.mesh.n_cells)
            _assert_system(At, bt, pet, Aj, bj, pej, tag)


def op_pressure_correction(J, T):
    outs = []
    for S in (J, T):
        flux = S.ops.ck_flux(
            S.mesh, S.ck, S.bc, S.vel,
            S.conv(tset.VelocityInterpolation.LINEAR_WEIGHTED),
        )
        F2 = flux * S.ck.area * 1.0
        outs.append(S.ops.ck_pressure_correction(S.mesh, S.ck, S.bc, 1.0, F2, S.md3))
    (Pj, bj), (Pt, bt) = outs
    _close(Pt.diag, Pj.diag, "diag")
    _close(Pt.off, Pj.off, "off")
    _close(bt, bj, "b")


def op_apply_correction(J, T):
    pp = cell_fields(J.mesh.n_cells, seed=11)[1]
    for form in tset.PressureCorrectionForm:
        for mode in tset.RelaxationMode:
            ts = tset.NumericalSettings(
                pressure_correction_form=form, relaxation_mode=mode,
                momentum_relaxation=0.7, pressure_relaxation=0.1,
            )
            outs = [
                S.ops.ck_apply_correction(
                    S.mesh, S.ck, S.bc, s, S.arr(pp), S.md3, S.vel, S.p
                )
                for S, s in ((J, J.conv(ts)), (T, T.conv(ts)))
            ]
            (vj, pj, (a, b)), (vt, pt, (c, d)) = outs
            tag = f"{form}/{mode}"
            _close(vt, vj, tag + " vel")
            _close(pt, pj, tag + " p")
            _close(c, a, tag + " p_sq")
            _close(d, b, tag + " v_sq")


OPS = {
    name[3:]: fn for name, fn in sorted(globals().items()) if name.startswith("op_")
}


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("case", sorted(CASES) + sorted(IRREGULAR_CASES))
def test_ck_op_matches_orc_tpu(case, op):
    J, T = _sides(case)
    OPS[op](J, T)


@pytest.mark.parametrize("scheme", ["CD2", "TVD"])
def test_unported_momentum_schemes_raise(scheme):
    """CD2 and in-matrix TVD on the 20^2 cavity with test_ck.py's face
    models (Linear-weighted mass flows and face pressures, the
    Green-Gauss velocity gradient): the per-component systems against
    orc_tpu's at rtol 1e-12; without their velocity gradient (or, for
    TVD, a limiter) both raise ValueError, as in orc_tpu."""
    J, T = _sides("cavity")
    ts = tset.NumericalSettings(
        momentum=tset.MomentumScheme[scheme], tvd_psi=tset.tvd_umist,
        velocity_interpolation=tset.VelocityInterpolation.LINEAR_WEIGHTED,
        pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED,
    )
    outs = []
    for S in (J, T):
        grad_v = S.ops.ck_velocity_gradient(S.mesh, S.ck, S.bc, S.vel)
        outs.append(_momentum(S, S.conv(ts), grad_vel=grad_v))
    (Aj, bj, pej), (At, bt, pet) = outs
    _assert_system(At, bt, pet, Aj, bj, pej, scheme)
    with pytest.raises(ValueError):
        _momentum(T, ts)
    if scheme == "TVD":
        with pytest.raises(ValueError):
            _momentum(T, ts.replace(tvd_psi=None), grad_vel=T.grad_p[:, None, :].expand(-1, 3, -1))


def test_tvd_dc_needs_its_gradient():
    """As orc_tpu: TVD_DC without grad_vel (or a limiter) is refused."""
    _, T = _sides("cavity")
    ts = tset.NumericalSettings(
        momentum=tset.MomentumScheme.TVD_DC, tvd_psi=tset.tvd_umist,
        velocity_interpolation=tset.VelocityInterpolation.LINEAR_WEIGHTED,
        pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED,
    )
    with pytest.raises(ValueError):
        _momentum(T, ts)


def test_nbr_values_routes_irregular_meshes_through_the_plan(monkeypatch):
    """Every irregular mesh with a slice plan reads neighbour values
    through slice_nbr_values (the kernel on the card), never through a
    plain gather beside it."""
    _, (mesh, _) = both("permuted")
    assert mesh.slice_plan is not None
    calls = []
    real = tck.slice_nbr_values

    def spy(plan, x, interior):
        calls.append(plan)
        return real(plan, x, interior)

    monkeypatch.setattr(tck, "slice_nbr_values", spy)
    interior = mesh.face_interior[mesh.cell_faces.long()] & mesh.cell_face_mask
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((mesh.n_cells, 3)))
    got = tck.nbr_values(mesh, x, interior)
    assert calls == [mesh.slice_plan]
    assert torch.equal(got, x[mesh.cell_neighbors.long()])


#: A fresh process (no JAX): torch.sqrt recorded while orc_tpu_torch is
#: imported.
_WARM_SCRIPT = """
import torch
calls = []
real = torch.sqrt
def sqrt(x, *a, **k):
    calls.append((str(x.dtype), x.numel(), str(x.device)))
    return real(x, *a, **k)
torch.sqrt = sqrt
import orc_tpu_torch
print(calls)
"""


def test_import_makes_the_first_threaded_cpu_sqrt_a_discarded_one():
    """Importing the package makes a threaded torch.sqrt of float64 and
    of float32 values on the CPU (utils.device.warm_cpu_vector_math).
    This checks only that the call is made; it does not show the fault
    the call guards against (MKL's first threaded sqrt of a process off
    in the second thread's half, behind the flake of
    tests/test_torch_kernels.py's pc_assembly test), which is too rare
    to reproduce in a test. The evidence is in ROADMAP Queue 3."""
    out = subprocess.run(
        [sys.executable, "-c", _WARM_SCRIPT], capture_output=True, text=True,
        timeout=300, cwd=pathlib.Path(__file__).resolve().parents[1],
        env=dict(os.environ, PYTHONPATH=str(pathlib.Path(__file__).resolve().parents[1])),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    calls = eval(out.stdout.strip().splitlines()[-1])
    big = {dtype for dtype, n, device in calls if n >= 2048 and device == "cpu"}
    assert big == {"torch.float64", "torch.float32"}, calls
