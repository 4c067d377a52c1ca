"""Port face-major ops (orc_tpu_torch/ops/fields.py `face_bc`,
ops/interpolation.py, ops/gradients.py, ops/assembly.py) entry for entry
against orc_tpu's, in float64, on the boxes of tests/torch_parity.py
(20x20 cavity, 8^3 cavity, pressure-BC couette, velocity-inlet channel),
the permuted 13^2 cavity (RCM order, slice plan) and the graded 10^2 box.

Tolerance: rtol 1e-10 (the same formulas in the same order; only sum
order may differ), plus atol 1e-13 x the largest reference magnitude for
entries that cancel to roundoff. The same systems are also held to the
NumPy transliteration of the reference's formulas (`RefAssembler` of
tests/test_reference_parity.py) at that file's tolerances, and the
signatures of every ported face-major function to orc_tpu's.
"""

import inspect

import numpy as np
import pytest
import torch

from torch_parity import CASES, IRREGULAR_CASES, both, cell_fields, np_, to_jax_settings

import jax.numpy as jnp
from orc_tpu.ops import assembly as jasm
from orc_tpu.ops import fields as jfields
from orc_tpu.ops import gradients as jgrad
from orc_tpu.ops import interpolation as jint

from orc_tpu_torch.ops import assembly as tasm
from orc_tpu_torch.ops import fields as tfields
from orc_tpu_torch.ops import gradients as tgrad
from orc_tpu_torch.ops import interpolation as tint
from orc_tpu_torch.utils import settings as tset

RTOL = 1e-10
ALL_CASES = sorted(CASES) + sorted(IRREGULAR_CASES)


def _close(actual, desired, name="", rtol=RTOL):
    d = np_(desired)
    scale = float(np.max(np.abs(d))) if d.size else 0.0
    np.testing.assert_allclose(
        np_(actual), d, rtol=rtol, atol=1e-13 * scale, err_msg=name
    )


class Side:
    """One package's mesh, face BCs and seeded fields of a case."""

    def __init__(self, pkg, mesh, table, arr, conv, fields):
        self.mesh, self.arr, self.conv = mesh, arr, conv
        self.fields, self.grad, self.interp, self.asm = pkg
        if arr is jnp.asarray:
            zc, zs, zv = self.fields.device_bc(table, dtype=mesh.dtype)
        else:
            zc, zs, zv = self.fields.device_bc(table, dtype=mesh.dtype, device="cpu")
        self.fbc = self.fields.face_bc(mesh, zc, zs, zv)
        vel, p, md = fields
        self.vel, self.p = arr(vel), arr(p)
        self.md3 = arr(md[:, None] * np.array([1.0, 1.1, 0.9]))  # [C,3]
        self.grad_p = self.grad.pressure_gradient(mesh, self.fbc, self.p)
        self.grad_v = self.grad.velocity_gradient(mesh, self.fbc, self.vel)
        self.diff = self.asm.diffusion_system(mesh, self.fbc, 0.7)


def _f64(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _sides(case):
    (mj, tj), (mt, tt) = both(case)
    fields = cell_fields(mj.n_cells)
    J = Side((jfields, jgrad, jint, jasm), mj, tj, jnp.asarray, to_jax_settings, fields)
    T = Side((tfields, tgrad, tint, tasm), mt, tt, _f64, lambda s: s, fields)
    return J, T


def op_face_bc(J, T):
    for name in ("code", "scalar", "vector", "zcode", "zscalar", "zvector"):
        _close(getattr(T.fbc, name), getattr(J.fbc, name), name)
    for got, want in zip(T.fbc.ck(T.mesh), J.fbc.ck(J.mesh)):
        _close(got, want, "ck")
    codes = (tfields.WALL, tfields.PRESSURE_OUTLET, tfields.INTERIOR)
    _close(T.fbc.is_(*codes), J.fbc.is_(*codes), "is_")


def op_face_velocity(J, T):
    for scheme in ("LINEAR", "LINEAR_WEIGHTED", "RHIE_CHOW"):
        outs = [
            S.interp.face_velocity(
                S.mesh, S.fbc, S.vel, S.conv(tset.VelocityInterpolation[scheme])
            )
            for S in (J, T)
        ]
        _close(outs[1], outs[0], scheme)


def op_face_pressure(J, T):
    for scheme in ("LINEAR", "LINEAR_WEIGHTED", "SECOND_ORDER"):
        outs = [
            S.interp.face_pressure(
                S.mesh, S.fbc, S.p, S.conv(tset.PressureInterpolation[scheme]),
                grad_p=S.grad_p,
            )
            for S in (J, T)
        ]
        _close(outs[1], outs[0], scheme)


def op_face_flux(J, T):
    for scheme in ("LINEAR", "LINEAR_WEIGHTED", "RHIE_CHOW"):
        outs = [
            S.interp.face_flux(
                S.mesh, S.fbc, S.vel, S.conv(tset.VelocityInterpolation[scheme]),
                p=S.p, grad_p=S.grad_p, mom_diag=S.md3,
            )
            for S in (J, T)
        ]
        _close(outs[1], outs[0], scheme)


def op_gradients(J, T):
    for scheme in ("GREEN_GAUSS_CELL", "LEAST_SQUARES"):
        for fn, f in (("pressure_gradient", "p"), ("velocity_gradient", "vel")):
            outs = [
                getattr(S.grad, fn)(
                    S.mesh, S.fbc, getattr(S, f),
                    S.conv(tset.GradientReconstruction[scheme]),
                )
                for S in (J, T)
            ]
            _close(outs[1], outs[0], f"{fn} {scheme}")


def op_diffusion(J, T):
    for name in ("diag", "off", "b"):
        _close(getattr(T.diff, name), getattr(J.diff, name), name)


def op_pressure_correction(J, T):
    for scheme in ("LINEAR_WEIGHTED", "RHIE_CHOW"):
        outs = []
        for S in (J, T):
            flux = S.interp.face_flux(
                S.mesh, S.fbc, S.vel, S.conv(tset.VelocityInterpolation[scheme]),
                p=S.p, grad_p=S.grad_p, mom_diag=S.md3,
            )
            outs.append(S.asm.pressure_correction_system(S.mesh, S.fbc, 1.3, flux, S.md3))
        (Aj, bj), (At, bt) = outs
        _close(At.diag, Aj.diag, f"{scheme} diag")
        _close(At.off, Aj.off, f"{scheme} off")
        _close(bt, bj, f"{scheme} b")


def op_apply_correction(J, T):
    rng = np.random.default_rng(11)
    pp = rng.standard_normal(J.mesh.n_cells) * 0.01
    for form in ("CELL_DIFFERENCE", "FACE_VALUE"):
        for mode in ("EXPLICIT", "IMPLICIT"):
            s = tset.NumericalSettings(
                pressure_correction_form=tset.PressureCorrectionForm[form],
                relaxation_mode=tset.RelaxationMode[mode],
                momentum_relaxation=0.6, pressure_relaxation=0.2,
            )
            outs = [
                S.asm.apply_pressure_correction(
                    S.mesh, S.fbc, S.conv(s), S.arr(pp), S.md3, S.vel, S.p
                )
                for S in (J, T)
            ]
            (vj, pj, (psj, vsj)), (vt, pt, (pst, vst)) = outs
            for got, want, name in ((vt, vj, "vel"), (pt, pj, "p"),
                                    (pst, psj, "p_sq"), (vst, vsj, "v_sq")):
                _close(got, want, f"{form} {mode} {name}")


def _fc_mod(S):
    if S.arr is jnp.asarray:
        from orc_tpu.solver import fc, simple
    else:
        from orc_tpu_torch.solver import fc, simple
    return fc, simple


def op_fc_flux_model(J, T):
    """face_flux_h, _face_d_coeffs, fc_pressure_system and correct_flux
    of the face-major SIMPLE_FC step."""
    p_new = cell_fields(J.mesh.n_cells, seed=11)[1]
    outs = []
    for S in (J, T):
        fc, _ = _fc_mod(S)
        hs = [
            fc.face_flux_h(
                S.mesh, S.fbc, S.vel, S.conv(tset.VelocityInterpolation[scheme]),
                p=S.p, grad_p=S.grad_p, mom_diag=S.md3,
            )
            for scheme in ("LINEAR", "LINEAR_WEIGHTED", "RHIE_CHOW")
        ]
        d = fc._face_d_coeffs(S.mesh, S.fbc, 1000.0, S.md3)
        P, b = fc.fc_pressure_system(S.mesh, S.fbc, 1000.0, hs[-1], d)
        flux = fc.correct_flux(S.mesh, S.fbc, hs[-1], d, 1000.0, S.arr(p_new))
        outs.append(hs + [d, P.diag, P.off, b, flux])
    names = ("flux_h linear", "flux_h lw", "flux_h rc", "d", "diag", "off", "b", "flux")
    for got, want, name in zip(outs[1], outs[0], names):
        _close(got, want, name)


def op_initial_flux(J, T):
    settings = tset.NumericalSettings(
        velocity_interpolation=tset.VelocityInterpolation.RHIE_CHOW,
        pressure_interpolation=tset.PressureInterpolation.SECOND_ORDER,
        relaxation_mode=tset.RelaxationMode.IMPLICIT,
    )
    outs = []
    for S in (J, T):
        _, simple = _fc_mod(S)
        zc, zs, zv = S.fbc.zcode, S.fbc.zscalar, S.fbc.zvector
        state = simple.initial_state(S.mesh, vel=S.vel, p=S.p)
        outs.append(simple.initial_flux(S.mesh, zc, zs, zv, S.conv(settings), state))
    _close(outs[1], outs[0])


OPS = {
    name[3:]: fn for name, fn in dict(globals()).items() if name.startswith("op_")
}


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("case", ALL_CASES)
def test_face_major_op_matches_orc_tpu(case, op):
    J, T = _sides(case)
    OPS[op](J, T)


# --- the momentum systems -----------------------------------------------

SCHEMES = {
    "ud": dict(momentum="UD"),
    "cd1": dict(momentum="CD1"),
    "cd2": dict(momentum="CD2"),
    "tvd": dict(momentum="TVD", tvd_psi=tset.tvd_umist),
    "tvd_dc": dict(momentum="TVD_DC", tvd_psi=tset.tvd_umist),
}


def _source(cc, vol):
    return torch.stack([vol * 2.0, vol * 0.0 - 0.3 * vol, cc[:, 0] * vol], dim=1)


def _jsource(cc, vol):
    return jnp.stack([vol * 2.0, vol * 0.0 - 0.3 * vol, cc[:, 0] * vol], axis=1)


def _momentum(S, scheme, variant, relaxation):
    kw = dict(SCHEMES[scheme])
    kw["momentum"] = tset.MomentumScheme[kw["momentum"]]
    s = tset.NumericalSettings(
        relaxation_mode=tset.RelaxationMode[relaxation], momentum_relaxation=0.7,
        velocity_interpolation=tset.VelocityInterpolation.RHIE_CHOW,
        pressure_interpolation=tset.PressureInterpolation.SECOND_ORDER, **kw,
    )
    s = S.conv(s)
    if variant == "source":
        s = s.replace(momentum_source=_jsource if S.arr is jnp.asarray else _source)
    flux = S.interp.face_flux(
        S.mesh, S.fbc, S.vel, s.velocity_interpolation,
        p=S.p, grad_p=S.grad_p, mom_diag=S.md3,
    )
    p_f = S.interp.face_pressure(S.mesh, S.fbc, S.p, s.pressure_interpolation, grad_p=S.grad_p)
    inertia = None
    if variant == "inertia":
        rv_dt = 1.3 * S.mesh.cell_volume / 0.01
        inertia = (rv_dt, S.vel * 0.5)
    return S.asm.momentum_system(
        S.mesh, S.fbc, s, 1.3, S.vel, flux, p_f, S.diff, grad_vel=S.grad_v,
        inertia=inertia,
    )


@pytest.mark.parametrize("variant", ["steady", "inertia", "source"])
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("case", ["cavity", "couette", "permuted"])
def test_momentum_system_matches_orc_tpu(case, scheme, variant):
    J, T = _sides(case)
    relaxation = "IMPLICIT" if variant == "inertia" else "EXPLICIT"
    (Aj, bj, pej), (At, bt, pet) = (
        _momentum(S, scheme, variant, relaxation) for S in (J, T)
    )
    shared = scheme in ("ud", "cd1", "tvd_dc")
    assert At.diag.ndim == (1 if shared else 2)
    _close(At.diag, Aj.diag, "diag")
    _close(At.off, Aj.off, "off")
    _close(bt, bj, "b")
    _close(pet, pej, "pe")
    # The kernels' layout: every column a contiguous [C] plane.
    col = At.off[..., 0]
    assert col.stride(-1) == 1
    if not shared:
        assert At.off.stride()[-2:] == (1, T.mesh.n_cells)


def test_systems_hand_the_kernels_contiguous_planes():
    T = _sides("cavity")[1]
    flux = torch.zeros(T.mesh.n_faces, dtype=torch.float64)
    Pmat, _ = tasm.pressure_correction_system(T.mesh, T.fbc, 1.0, flux, T.md3)
    assert all(c.is_contiguous() for c in Pmat.split_columns().off)


# --- the NumPy oracle of the reference's formulas -----------------------


@pytest.fixture(scope="module")
def oracle():
    from orc_tpu_torch.mesh.generate import structured_box_mesh
    from orc_tpu_torch.mesh.zones import FaceCondition

    from test_reference_parity import RefAssembler

    mesh, table = structured_box_mesh(3, 4, 2, lengths=(1.5, 1.0, 0.8), device="cpu")
    table.set("INLET", FaceCondition.VELOCITY_INLET, vector_value=(0.7, 0.1, -0.2))
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.3)
    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(0.5, 0.0, 0.0))
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.PRESSURE_INLET, scalar_value=1.2)
    zc, zs, zv = tfields.device_bc(table, dtype=mesh.dtype, device="cpu")
    fbc = tfields.face_bc(mesh, zc, zs, zv)
    ref = RefAssembler(mesh, fbc)
    rng = np.random.default_rng(42)
    fields = dict(
        vel=rng.normal(size=(ref.C, 3)),
        p=rng.normal(size=ref.C),
        mom_diag=1.0 + rng.uniform(size=(ref.C, 3)),
        p_prime=rng.normal(size=ref.C),
    )
    return mesh, fbc, ref, fields


def _dense(A, mesh):
    from test_reference_parity import dense_from_ell

    return dense_from_ell(
        type("E", (), dict(diag=np_(A.diag), off=np_(A.off), neighbors=np_(mesh.cell_neighbors)))
    )


def test_diffusion_matches_reference_oracle(oracle):
    mesh, fbc, ref, _ = oracle
    diff = tasm.diffusion_system(mesh, fbc, 0.7)
    A_ref, b_ref = ref.diffusion(0.7)
    np.testing.assert_allclose(_dense(diff, mesh), A_ref, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np_(diff.b), b_ref, rtol=1e-12, atol=1e-14)


def test_gradients_match_reference_oracle(oracle):
    mesh, fbc, ref, fl = oracle
    gp = tgrad.pressure_gradient(mesh, fbc, _f64(fl["p"]))
    gv = tgrad.velocity_gradient(mesh, fbc, _f64(fl["vel"]))
    gp_ref = np.stack([ref.pressure_gradient(c, fl["p"]) for c in range(ref.C)])
    gv_ref = np.stack([ref.velocity_gradient(c, fl["vel"]) for c in range(ref.C)])
    np.testing.assert_allclose(np_(gp), gp_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np_(gv), gv_ref, rtol=1e-10, atol=1e-12)


ORACLE_CONFIGS = [
    ("UD", "LINEAR", "LINEAR"),
    ("CD1", "LINEAR_WEIGHTED", "LINEAR_WEIGHTED"),
    ("TVD", "LINEAR", "LINEAR"),
    ("CD1", "RHIE_CHOW", "SECOND_ORDER"),
]


@pytest.mark.parametrize("scheme,vi,pi", ORACLE_CONFIGS)
def test_momentum_matches_reference_oracle(oracle, scheme, vi, pi):
    mesh, fbc, ref, fl = oracle
    settings = tset.NumericalSettings(
        momentum=tset.MomentumScheme[scheme],
        tvd_psi=tset.tvd_quick if scheme == "TVD" else None,
        velocity_interpolation=tset.VelocityInterpolation[vi],
        pressure_interpolation=tset.PressureInterpolation[pi],
        relaxation_mode=tset.RelaxationMode.EXPLICIT,
    )
    vel, p, md = _f64(fl["vel"]), _f64(fl["p"]), _f64(fl["mom_diag"])
    diff = tasm.diffusion_system(mesh, fbc, 0.7)
    grad_p = tgrad.pressure_gradient(mesh, fbc, p)
    grad_v = tgrad.velocity_gradient(mesh, fbc, vel)
    flux = tint.face_flux(
        mesh, fbc, vel, settings.velocity_interpolation, p=p, grad_p=grad_p, mom_diag=md
    )
    p_face = tint.face_pressure(mesh, fbc, p, settings.pressure_interpolation, grad_p=grad_p)
    A, b, pe = tasm.momentum_system(
        mesh, fbc, settings, 1.3, vel, flux, p_face, diff, grad_vel=grad_v
    )
    A_di, b_di = ref.diffusion(0.7)
    psi = (lambda r: (3.0 + r) / 4.0) if scheme == "TVD" else None
    A_ref, b_ref, pe_ref = ref.momentum(
        fl["vel"], fl["p"], fl["mom_diag"], A_di, b_di, 1.3, scheme.lower(),
        vi.lower(), pi.lower(), psi,
    )
    A_dense = _dense(A, mesh)
    if A_dense.ndim == 2:
        A_dense = np.broadcast_to(A_dense, A_ref.shape)
    np.testing.assert_allclose(A_dense, A_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np_(b), b_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np_(pe), pe_ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("vi", ["LINEAR_WEIGHTED", "RHIE_CHOW"])
def test_pressure_correction_matches_reference_oracle(oracle, vi):
    mesh, fbc, ref, fl = oracle
    vel, p, md = _f64(fl["vel"]), _f64(fl["p"]), _f64(fl["mom_diag"])
    grad_p = tgrad.pressure_gradient(mesh, fbc, p)
    flux = tint.face_flux(
        mesh, fbc, vel, tset.VelocityInterpolation[vi], p=p, grad_p=grad_p, mom_diag=md
    )
    A, b = tasm.pressure_correction_system(mesh, fbc, 1.3, flux, md)
    A_ref, b_ref = ref.pressure_correction(fl["vel"], fl["p"], fl["mom_diag"], 1.3, vi.lower())
    np.testing.assert_allclose(_dense(A, mesh), A_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np_(b), b_ref, rtol=1e-10, atol=1e-12)


def test_apply_correction_matches_reference_oracle(oracle):
    mesh, fbc, ref, fl = oracle
    settings = tset.NumericalSettings(
        relaxation_mode=tset.RelaxationMode.EXPLICIT,
        momentum_relaxation=0.5,
        pressure_relaxation=0.01,
    )
    new_vel, new_p, (p_sq, v_sq) = tasm.apply_pressure_correction(
        mesh, fbc, settings, _f64(fl["p_prime"]), _f64(fl["mom_diag"]),
        _f64(fl["vel"]), _f64(fl["p"]),
    )
    ref_vel, ref_p, ref_vsq = ref.apply_correction(
        fl["p_prime"], fl["mom_diag"], fl["vel"], fl["p"], 0.5, 0.01
    )
    np.testing.assert_allclose(np_(new_vel), ref_vel, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np_(new_p), ref_p, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(float(p_sq), fl["p_prime"] @ fl["p_prime"], rtol=1e-12)
    np.testing.assert_allclose(float(v_sq), ref_vsq, rtol=1e-10)


# --- signatures ---------------------------------------------------------

#: Parameters only the port has: its explicit device (and dtype, where
#: orc_tpu has none). orc_tpu's sharded hooks (comm, axis_sum, refresh)
#: are the port's too, in orc_tpu's positions.
PORT_ADDED = {"device", "dtype"}


def _signature_pairs():
    import orc_tpu.mesh.compile as jc
    import orc_tpu.mesh.nodes as jn
    import orc_tpu.mesh.tgrid as jt
    import orc_tpu.solver.fc as jf
    import orc_tpu.solver.simple as js
    import orc_tpu.solver.transient as jtr

    import orc_tpu_torch.mesh.compile as tc
    import orc_tpu_torch.mesh.nodes as tn
    import orc_tpu_torch.mesh.tgrid as tt
    import orc_tpu_torch.solver.fc as tf
    import orc_tpu_torch.solver.simple as ts
    import orc_tpu_torch.solver.transient as ttr

    names = {
        (jfields, tfields): ["face_bc", "FaceBC.is_", "FaceBC.ck"],
        (jint, tint): ["_interior_scalar", "face_velocity", "face_pressure", "face_flux"],
        (jgrad, tgrad): [
            "_green_gauss", "_ls_rows", "_node_face_values",
            "pressure_gradient", "velocity_gradient",
        ],
        (jasm, tasm): [
            "_gathered", "diffusion_system", "momentum_system",
            "_normal_momentum_coeff", "pressure_correction_system",
            "apply_pressure_correction",
        ],
        (js, ts): ["save_history", "initial_flux", "simple_step", "solve_steady"],
        (jf, tf): [
            "face_flux_h", "_face_d_coeffs", "fc_pressure_system", "correct_flux",
            "simple_step_fc",
        ],
        (jtr, ttr): ["solve_transient"],
        (jn, tn): ["build_node_interp", "node_face_values"],
        (jc, tc): ["compile_mesh"],
        (jt, tt): ["read_mesh"],
    }
    for (jm, tm), fns in names.items():
        for fn in fns:
            yield f"{tm.__name__.split('.', 1)[1]}.{fn}", jm, tm, fn


def _attr(mod, dotted):
    obj = mod
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


SIGNATURES = list(_signature_pairs())


@pytest.mark.parametrize(
    "label,jm,tm,fn", SIGNATURES, ids=[s[0] for s in SIGNATURES]
)
def test_signature_matches_orc_tpu(label, jm, tm, fn):
    """Every parameter of orc_tpu's function is the port's, in orc_tpu's
    order, the sharded hooks included; only the port's device / dtype
    differ."""
    j = list(inspect.signature(_attr(jm, fn)).parameters)
    t = [
        n for n in inspect.signature(_attr(tm, fn)).parameters
        if n not in PORT_ADDED or n in j
    ]
    assert j == t, (j, t)
    assert list(tasm.DiffusionSystem._fields) == list(jasm.DiffusionSystem._fields)
