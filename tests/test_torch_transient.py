"""The transient slice: orc_tpu_torch's implicit-Euler time marching,
momentum sources and the momentum kernels' inertia branch against
orc_tpu on CPU (JAX x64; the port in float64 unless stated).

- ck_momentum with inertia = (rho V/dt, vel^n) and a one-argument, a
  two-argument and a default-argument-closure momentum source, on the
  13^2 cavity, a permuted 12^2 cavity and a graded 10^2 box: rtol 1e-10
  (the same formulas, sums in another order);
- the plain momentum_assembly / fc_momentum_assembly with inertia
  against orc_tpu's ck_momentum in float64 at rtol 1e-10, and against
  orc_tpu's interpret-mode kernels in float32 at 1e-5 of each output's
  largest value (UD; CD1 + SecondOrder + Rhie-Chow with the in-kernel
  gradient; TVD_DC);
- solve_transient: the impulsively started couette of
  tests/test_transient.py (every step's metrics at rtol 1e-6, equal
  inner iteration counts, the analytical error below 0.06), metric
  shapes, the 32^2 Taylor-Green vortex (AUTO -> SIMPLE_FC, BiCGSTAB:
  the exact-decay bars of orc_tpu's test and the end state within the
  gap measured against orc_tpu, TG_GAP), a permuted 12^2 cavity (the
  irregular path, tracking orc_tpu at rtol 1e-6), and float32 runs that
  are bitwise equal with compensated_state on and off (the transient
  loop does not compensate);
- courant_numbers against orc_tpu at rtol 1e-12, the exact 0.5 case
  included.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import (
    DTYPES,
    _cavity,
    _from_arrays,
    cell_fields,
    graded_arrays,
    np_,
    permuted_arrays,
    to_jax_settings,
)
from test_torch_kernels import (
    _ck_oracle_flux,
    _fc_inputs,
    _fc_mom_args,
    _parity_inputs,
    _parity_mom_kw,
)

import jax.numpy as jnp
from orc_tpu.mesh import structured_box_mesh as jbox
from orc_tpu.mesh.zones import FaceCondition as JFC
from orc_tpu.ops import ck_ops as jck
from orc_tpu.ops import pallas_assembly as jasm
from orc_tpu.ops.fields import device_bc as jdevice_bc
from orc_tpu.solver import simple as js
from orc_tpu.solver import transient as jt

from orc_tpu_torch.mesh.generate import structured_box_mesh as tbox
from orc_tpu_torch.mesh.zones import FaceCondition as TFC
from orc_tpu_torch.ops import ck_ops as tck
from orc_tpu_torch.ops import fused_assembly as tasm
from orc_tpu_torch.ops.fields import device_bc as tdevice_bc
from orc_tpu_torch.solver import simple as ts
from orc_tpu_torch.solver import transient as tt
from orc_tpu_torch.utils import settings as tset

H = 1e-3  # couette channel height [m]
U = 1e-3  # wall velocity [m/s]
RHO, MU = 1000.0, 0.001


def _scale_close(actual, desired, rel, name=""):
    d = np.asarray(desired, dtype=np.float64)
    np.testing.assert_allclose(
        np.asarray(actual, dtype=np.float64), d, rtol=rel,
        atol=rel * float(np.max(np.abs(d))), err_msg=name,
    )


def _close(actual, desired, rtol, name=""):
    d = np_(desired)
    np.testing.assert_allclose(
        np_(actual), d, rtol=rtol, atol=1e-13 * float(np.max(np.abs(d))),
        err_msg=name,
    )


# --- ck_momentum: inertia and momentum sources -------------------------

#: name -> make(pkg, dtype) -> (mesh, table).
MESHES = {
    "cavity13": lambda pkg, dt: _cavity(pkg, 13, dt),
    "permuted12": lambda pkg, dt: _from_arrays(pkg, dt, permuted_arrays(12, seed=2)[0]),
    "graded10": lambda pkg, dt: _from_arrays(pkg, dt, graded_arrays(10)),
}


def _sources(xp):
    """(one-argument, two-argument, default-argument closure) sources
    written for the array module `xp` (jax.numpy or torch)."""

    def stack(cols):
        return xp.stack(cols, -1)

    def one(cc):
        return stack([0.3 * cc[:, 1], -0.2 * cc[:, 0], 0.0 * cc[:, 0] + 0.1])

    def two(cc, vol):
        return vol[:, None] * stack([xp.sin(cc[:, 0]), xp.cos(cc[:, 1]), 0.0 * cc[:, 2]])

    def closure(cc, _g=2.5):
        return stack([_g * cc[:, 0] * cc[:, 1], 0.0 * cc[:, 0], 0.0 * cc[:, 0]])

    return {"one_arg": one, "two_arg": two, "closure": closure}


@pytest.mark.parametrize("source", ["one_arg", "two_arg", "closure", "none"])
@pytest.mark.parametrize("case", sorted(MESHES))
def test_ck_momentum_inertia_and_sources(case, source):
    jd, td = DTYPES["f64"]
    (mj, tj), (mt, ttab) = MESHES[case]("jax", jd), MESHES[case]("torch", td)
    C = mj.n_cells
    vel, p, _md = cell_fields(C, seed=4)
    rng = np.random.default_rng(9)
    vel_n = rng.standard_normal((C, 3)) * 0.1
    base = tset.NumericalSettings(
        momentum=tset.MomentumScheme.UD,
        velocity_interpolation=tset.VelocityInterpolation.LINEAR_WEIGHTED,
        pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED,
        relaxation_mode=tset.RelaxationMode.IMPLICIT,
        momentum_relaxation=0.7,
    )
    outs = []
    for pkg, ops, dbc, mesh, table, arr, xp in (
        ("jax", jck, jdevice_bc, mj, tj, jnp.asarray, jnp),
        ("torch", tck, lambda t: tdevice_bc(t, device="cpu"), mt, ttab,
         lambda a: torch.tensor(np.asarray(a)), torch),
    ):
        settings = base if pkg == "torch" else to_jax_settings(base)
        if source != "none":
            settings = settings.replace(momentum_source=_sources(xp)[source])
        zc, zs, zv = dbc(table)
        ck = ops.build_ck_geometry(mesh, len(table.zone_ids))
        bc = ops.ck_bc(ck, zc, zs, zv)
        v = arr(vel)
        flux = ops.ck_flux(mesh, ck, bc, v, settings.velocity_interpolation)
        p_f = ops.ck_face_pressure(mesh, ck, bc, arr(p), settings.pressure_interpolation)
        diff = ops.ck_diffusion(mesh, ck, bc, arr(1e-3))
        rv_dt = RHO * mesh.cell_volume / 0.01
        outs.append(ops.ck_momentum(
            mesh, ck, bc, settings, RHO, v, flux * ck.area * RHO, p_f, *diff,
            inertia=(rv_dt, arr(vel_n)),
        ))
    (Aj, bj, pej), (At, bt, pet) = outs
    for name, a, r in (("diag", At.diag, Aj.diag), ("off", At.off, Aj.off),
                       ("b", bt, bj), ("pe", pet, pej)):
        _close(a, r, 1e-10, name)


# --- the momentum kernels' inertia branch (plain versions) -------------


def _inertia(S, dtype):
    """Seeded (rv_dt [C], vel_n [C,3]) in `S`'s array type."""
    C = S["vel"].shape[0]
    rng = np.random.default_rng(6)
    rv = rng.uniform(50.0, 150.0, C)
    vn = rng.standard_normal((C, 3)) * 0.1
    if isinstance(S["vel"], torch.Tensor):
        td = DTYPES[dtype][1]
        return torch.tensor(rv, dtype=td), torch.tensor(vn, dtype=td)
    jd = DTYPES[dtype][0]
    return jnp.asarray(rv, jd), jnp.asarray(vn, jd)


@pytest.mark.parametrize("gg", [True, False], ids=["gg", "streamed"])
@pytest.mark.parametrize("scheme", ["default", "tvd_dc-rc", "p_so"])
@pytest.mark.parametrize("case", ["cavity3d", "couette"])
def test_parity_inertia_matches_ck_oracle(case, scheme, gg):
    """float64 at 1e-10: the plain momentum_assembly with inertia
    against orc_tpu's ck path with the same inertia."""
    J, T = _parity_inputs(case, scheme, "f64", gg)
    mj, ck, bc, st = J["mesh"], J["ck"], J["bc"], J["settings"]
    flux, gp, gp_nbr, _md3 = _ck_oracle_flux(J, st.velocity_interpolation)
    p_f = jck.ck_face_pressure(
        mj, ck, bc, J["p"], st.pressure_interpolation, grad_p=gp, grad_p_nbr=gp_nbr
    )
    diff = jck.ck_diffusion(mj, ck, bc, jnp.asarray(1e-3))
    A, b, _ = jck.ck_momentum(
        mj, ck, bc, st, 1.0, J["vel"], flux * ck.area, p_f, *diff,
        grad_vel=J["grad_vel"], inertia=_inertia(J, "f64"),
    )
    got = tasm.momentum_assembly(
        T["vel"], T["p"], T["bcv"], T["flags"], T["cols"], 1.0, 1e-3, 0.7,
        inertia=_inertia(T, "f64"), **_parity_mom_kw(T),
    )
    for name, a, r in zip(("diag", "off", "b"), got, (A.diag, A.off, b)):
        _close(a, r, 1e-10, name)


@pytest.mark.parametrize("scheme", ["ud-linear", "default", "tvd_dc-rc"])
@pytest.mark.parametrize("case", ["cavity", "vinlet"])
def test_fc_inertia_matches_ck_oracle(case, scheme):
    """float64 at 1e-10: the plain fc_momentum_assembly with inertia
    against orc_tpu's ck_momentum fed with the stored flux."""
    J, T = _fc_inputs(case, scheme, "f64")
    mj, ck, bc, st = J["mesh"], J["ck"], J["bc"], J["settings"]
    gp_nbr = jck.nbr_values(mj, J["grad_p"], ck.interior)
    p_f = jck.ck_face_pressure(
        mj, ck, bc, J["p"], st.pressure_interpolation,
        grad_p=J["grad_p"], grad_p_nbr=gp_nbr,
    )
    diff = jck.ck_diffusion(mj, ck, bc, jnp.asarray(1e-3))
    A, b, _ = jck.ck_momentum(
        mj, ck, bc, st, 1.0, J["vel"], J["flux"] * ck.area, p_f, *diff,
        grad_vel=J["grad_vel"], inertia=_inertia(J, "f64"),
    )
    got = tasm.fc_momentum_assembly(
        *_fc_mom_args(T), grad_p=T["grad_p"], grad_vel=T["grad_vel"],
        inertia=_inertia(T, "f64"), spec=T["spec"],
    )
    for name, a, r in zip(("diag", "off", "b"), got, (A.diag, A.off, b)):
        _close(a, r, 1e-10, name)


def _scaled_err(got, ref):
    return [
        float(np.max(np.abs(np_(a).astype(np.float64) - np_(r))) / np.max(np.abs(np_(r))))
        for a, r in zip(got, ref)
    ]


#: (kernel, case, scheme, gg) of the interpret-mode comparisons (each an
#: interpret-mode compile of orc_tpu's transient kernel).
INERTIA_PALLAS = [
    ("parity", "cavity", "ud-linear", False),
    ("parity", "couette", "default", True),
    ("parity", "vinlet", "tvd_dc-rc", False),
    ("fc", "cavity", "tvd_dc-rc", False),
]


@pytest.mark.parametrize("kernel,case,scheme,gg", INERTIA_PALLAS)
def test_inertia_matches_pallas_kernel(kernel, case, scheme, gg):
    """float32: the plain versions with inertia against orc_tpu's
    interpret-mode _momentum_kernel with its transient branch, each
    output to 1e-5 of its largest value."""
    J, T = _parity_inputs(case, scheme, "f32", gg)
    if kernel == "parity":
        args = lambda S: (S["vel"], S["p"], S["bcv"], S["flags"], S["cols"], 1.0, 1e-3, 0.7)  # noqa: E731
        ref = jasm.momentum_assembly(
            *args(J), inertia=_inertia(J, "f32"), interpret=True, **_parity_mom_kw(J)
        )
        got = tasm.momentum_assembly(*args(T), inertia=_inertia(T, "f32"), **_parity_mom_kw(T))
    else:
        kw = lambda S: dict(grad_p=S["grad_p"], grad_vel=S["grad_vel"], spec=S["spec"])  # noqa: E731
        ref = jasm.fc_momentum_assembly(
            *_fc_mom_args(J), inertia=_inertia(J, "f32"), interpret=True, **kw(J)
        )
        got = tasm.fc_momentum_assembly(*_fc_mom_args(T), inertia=_inertia(T, "f32"), **kw(T))
    for name, a, r in zip(("diag", "off", "b"), got, ref):
        assert tuple(a.shape) == r.shape, name
    errs = _scaled_err(got, ref)
    assert max(errs) <= 1e-5, errs


def test_inertia_needs_its_shapes():
    _, T = _fc_inputs("cavity", "ud-linear", "f64")
    rv, vn = _inertia(T, "f64")
    for bad in ((rv[:-1], vn), (rv, vn[:, :2]), (rv,)):
        with pytest.raises(ValueError):
            tasm.fc_momentum_assembly(*_fc_mom_args(T), inertia=bad, spec=T["spec"])


# --- solve_transient ----------------------------------------------------


def _couette(pkg, ny=16):
    box, FC = (jbox, JFC) if pkg == "jax" else (tbox, TFC)
    kw = {} if pkg == "jax" else dict(device="cpu")
    mesh, table = box(4, ny, 1, lengths=(4e-4, H, 1e-4), **kw)
    table.set("TOP_WALL", FC.WALL, vector_value=(U, 0, 0))
    table.set("BOTTOM_WALL", FC.WALL)
    table.set("INLET", FC.PRESSURE_INLET, scalar_value=0.0)
    table.set("OUTLET", FC.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FC.SYMMETRY)
    table.set("PERIODIC_+Z", FC.SYMMETRY)
    return mesh, table


#: tests/test_transient.py::test_couette_startup's settings.
COUETTE_SETTINGS = tset.NumericalSettings(
    momentum=tset.MomentumScheme.UD,
    pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED,
    velocity_interpolation=tset.VelocityInterpolation.LINEAR_WEIGHTED,
    matrix_solver=tset.MatrixSolverSettings(
        solver_type=tset.SolutionMethod.BICGSTAB,
        iterations=40,
        preconditioner=tset.PreconditionMethod.JACOBI,
    ),
    momentum_relaxation=0.8,
    pressure_relaxation=0.2,
)


def couette_startup_analytical(y, t, n_terms=200):
    """u(y,t) for the top wall impulsively started at t=0."""
    nu = MU / RHO
    u = y / H
    for n in range(1, n_terms + 1):
        u = u + (2.0 * (-1) ** n / (n * np.pi)) * np.exp(
            -(n**2) * np.pi**2 * nu * t / H**2
        ) * np.sin(n * np.pi * y / H)
    return U * u


def _assert_metrics_track(hj, ht):
    for f in hj._fields:
        a, b = np.asarray(getattr(hj, f)), np_(getattr(ht, f))
        assert a.shape == b.shape, f
        if f in ("mom_iters", "pc_iters", "diverged"):
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            d = a.astype(np.float64)
            np.testing.assert_allclose(
                b, d, rtol=1e-6, atol=1e-12 * float(np.max(np.abs(d))), err_msg=f
            )


def test_couette_startup_tracks_orc_tpu():
    t_end, n_steps = 0.1, 20
    kw = dict(dt=t_end / n_steps, n_steps=n_steps, inner_iterations=15, verbose=False)
    mj, tj = _couette("jax")
    sj, hj = jt.solve_transient(mj, tj, to_jax_settings(COUETTE_SETTINGS), RHO, MU, **kw)
    mt, ttab = _couette("torch")
    st, ht = tt.solve_transient(mt, ttab, COUETTE_SETTINGS, RHO, MU, **kw)
    _assert_metrics_track(hj, ht)
    _scale_close(np_(st.vel), np.asarray(sj.vel), 1e-8, "vel")
    _scale_close(np_(st.p), np.asarray(sj.p), 1e-8, "p")
    cc = np_(mt.cell_centroid)
    col = np.abs(cc[:, 0] - cc[:, 0].mean()) < 6e-5
    y = cc[col, 1]
    u_ana = couette_startup_analytical(y, t_end)
    assert np.abs(u_ana - U * y / H).max() > 0.2 * U  # still developing
    err = np.abs(np_(st.vel)[col, 0] - u_ana).max() / U
    assert err < 0.06, err


@pytest.mark.parametrize("form", ["keyword", "positional"])
def test_report_interval_is_accepted_and_ignored(form):
    """orc_tpu's `report_interval` sits between `state` and `verbose`;
    the single-device march ignores it, so the couette startup with it,
    by keyword or at its position, equals the run without it bitwise."""
    mesh, table = _couette("torch")
    dt, n_steps, inner = 0.1 / 20, 6, 5
    s0, h0 = tt.solve_transient(
        mesh, table, COUETTE_SETTINGS, RHO, MU, dt, n_steps, inner, verbose=False
    )
    if form == "keyword":
        s1, h1 = tt.solve_transient(
            mesh, table, COUETTE_SETTINGS, RHO, MU, dt, n_steps, inner,
            report_interval=5, verbose=False,
        )
    else:
        s1, h1 = tt.solve_transient(
            mesh, table, COUETTE_SETTINGS, RHO, MU, dt, n_steps, inner, None, 5,
            False, True, "auto",
        )
    for s in (s0, h0):
        for f in dataclasses.fields(s):
            a, b = getattr(s, f.name), getattr(s1 if s is s0 else h1, f.name)
            assert (a is None) == (b is None), f.name
            assert a is None or torch.equal(a, b), f.name


def test_transient_metrics_shape():
    mesh, table = tbox(4, 4, 1, lengths=(1e-3, 1e-3, 1e-4), device="cpu")
    table.set("TOP_WALL", TFC.WALL, vector_value=(1e-3, 0, 0))
    table.set("BOTTOM_WALL", TFC.WALL)
    table.set("INLET", TFC.PRESSURE_INLET)
    table.set("OUTLET", TFC.PRESSURE_OUTLET)
    table.set("PERIODIC_-Z", TFC.SYMMETRY)
    table.set("PERIODIC_+Z", TFC.SYMMETRY)
    settings = COUETTE_SETTINGS.replace(
        matrix_solver=tset.MatrixSolverSettings(
            solver_type=tset.SolutionMethod.BICGSTAB, iterations=20
        )
    )
    state, metrics = tt.solve_transient(
        mesh, table, settings, RHO, MU, dt=0.01, n_steps=5, inner_iterations=4,
        verbose=False,
    )
    assert tuple(metrics.vel_avg.shape) == (5, 3)
    assert tuple(metrics.pc_iters.shape) == (5,)
    assert torch.isfinite(state.vel).all()


#: Largest end-state difference, relative to the field's scale, allowed
#: between the port's and orc_tpu's 32^2 Taylor-Green runs (20 steps x 10
#: inner SIMPLE_FC iterations, BiCGSTAB(50) pressure solves, which amplify
#: roundoff: ROADMAP Queue 3; the pressure iteration counts part after
#: the first step). Measured on the CPU: vel 1.16e-9, p 7.98e-9, flux
#: 3.06e-10; held at ten times the largest.
TG_GAP = 8e-8


def _taylor_green(pkg):
    N = 32
    if pkg == "jax":
        mesh, table = jbox(
            N, N, 1, lengths=(2 * np.pi, 2 * np.pi, 1.0), periodic=("x", "y"),
            dtype=jnp.float64,
        )
    else:
        mesh, table = tbox(
            N, N, 1, lengths=(2 * np.pi, 2 * np.pi, 1.0), periodic=("x", "y"),
            device="cpu",
        )
    cc = np_(mesh.cell_centroid)
    x, y = cc[:, 0], cc[:, 1]
    u0, v0 = np.sin(x) * np.cos(y), -np.cos(x) * np.sin(y)
    p0 = 1.0 / 4.0 * (np.cos(2 * x) + np.cos(2 * y))
    return mesh, table, (u0, v0, p0)


TG_SETTINGS = tset.NumericalSettings(
    momentum=tset.MomentumScheme.CD1,
    pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED,
    velocity_interpolation=tset.VelocityInterpolation.RHIE_CHOW,
    pressure_relaxation=0.3,
    momentum_relaxation=0.7,
    relaxation_mode=tset.RelaxationMode.IMPLICIT,
    matrix_solver=tset.MatrixSolverSettings(
        solver_type=tset.SolutionMethod.BICGSTAB,
        iterations=50,
        preconditioner=tset.PreconditionMethod.JACOBI,
    ),
)


def test_taylor_green_decay_tracks_orc_tpu():
    """tests/test_transient.py::test_taylor_green_vortex_decay in the
    port: the exact e^(-2 nu t) decay to 5e-3 (pointwise and kinetic
    energy), and the end state held to orc_tpu's at TG_GAP."""
    assert TG_SETTINGS.resolved_coupling() == tset.PressureVelocityCoupling.SIMPLE_FC
    rho, mu, dt, nsteps = 1.0, 0.02, 0.05, 20
    kw = dict(inner_iterations=10, verbose=False)
    mj, tj, (u0, v0, p0) = _taylor_green("jax")
    sj0 = js.initial_state(mj)
    sj0 = dataclasses.replace(
        sj0, vel=jnp.asarray(np.stack([u0, v0, 0 * u0], -1)), p=jnp.asarray(p0)
    )
    sj, _ = jt.solve_transient(
        mj, tj, to_jax_settings(TG_SETTINGS), rho, mu, dt, nsteps, state=sj0, **kw
    )
    mt, ttab, _ = _taylor_green("torch")
    st0 = ts.initial_state(mt, vel=np.stack([u0, v0, 0 * u0], -1), p=p0)
    st, ht = tt.solve_transient(mt, ttab, TG_SETTINGS, rho, mu, dt, nsteps, state=st0, **kw)
    decay = np.exp(-2 * (mu / rho) * dt * nsteps)
    u, v = np_(st.vel[:, 0]), np_(st.vel[:, 1])
    err = max(np.abs(u - u0 * decay).max(), np.abs(v - v0 * decay).max())
    assert err < 5e-3, err
    e_ratio = np.sum(u * u + v * v) / (decay**2 * np.sum(u0**2 + v0**2))
    assert abs(e_ratio - 1.0) < 5e-3, e_ratio
    for name in ("vel", "p", "flux"):
        _scale_close(np_(getattr(st, name)), np.asarray(getattr(sj, name)), TG_GAP, name)
    assert not ht.diverged.any()


def test_permuted_cavity_tracks_orc_tpu():
    """The irregular path (RCM order, slice plan, plain (c,k) assembly):
    a permuted 12^2 cavity with solve_cavity's numerics, 3 steps x 4
    inner iterations, tracking orc_tpu at rtol 1e-6."""
    from orc_tpu_torch.models.cavity import default_settings

    kw, _perm = permuted_arrays(12, seed=5)
    (mj, tj), (mt, ttab) = _from_arrays("jax", jnp.float64, kw), _from_arrays("torch", torch.float64, kw)
    assert mt.slice_plan is not None
    settings = default_settings()
    run = dict(dt=0.05, n_steps=3, inner_iterations=4, verbose=False)
    sj, hj = jt.solve_transient(mj, tj, to_jax_settings(settings), 1.0, 0.01, **run)
    st, ht = tt.solve_transient(mt, ttab, settings, 1.0, 0.01, **run)
    _assert_metrics_track(hj, ht)
    _scale_close(np_(st.vel), np.asarray(sj.vel), 1e-8, "vel")


def test_f32_transient_is_not_compensated():
    """orc_tpu's transient scan calls the step with no Kahan-compensated
    accumulation: compensated_state on and off give bitwise-equal float32
    runs."""
    from orc_tpu_torch.models.cavity import cavity_case, default_settings

    mesh, table = cavity_case(n=12, dtype=torch.float32, device="cpu")
    out = []
    for comp in (True, False):
        settings = default_settings().replace(compensated_state=comp)
        state, hist = tt.solve_transient(
            mesh, table, settings, 1.0, 0.01, dt=0.05, n_steps=3,
            inner_iterations=4, verbose=False,
        )
        out.append((state, hist))
    (s1, h1), (s2, h2) = out
    assert s1.vel.dtype == torch.float32
    assert torch.equal(s1.vel, s2.vel) and torch.equal(s1.p, s2.p)
    assert torch.equal(h1.pc_iters, h2.pc_iters)


# --- courant_numbers -----------------------------------------------------


def test_courant_numbers_exact_case():
    """tests/test_transient.py::test_courant_numbers: uniform u through a
    unit-cell box gives Co = dt |u| / h = 0.5 in every cell."""
    u0, dt = 2.0, 0.25
    outs = []
    for pkg in ("jax", "torch"):
        box, FC = (jbox, JFC) if pkg == "jax" else (tbox, TFC)
        kw = {} if pkg == "jax" else dict(device="cpu")
        mesh, table = box(4, 4, 1, lengths=(4.0, 4.0, 1.0), **kw)
        table.set("INLET", FC.VELOCITY_INLET, vector_value=(u0, 0, 0))
        table.set("OUTLET", FC.PRESSURE_OUTLET)
        vel = np.tile([u0, 0.0, 0.0], (mesh.n_cells, 1))
        if pkg == "jax":
            outs.append(jt.courant_numbers(mesh, table, jnp.asarray(vel), dt))
        else:
            outs.append(tt.courant_numbers(mesh, table, torch.tensor(vel), dt))
    for j, t in zip(*outs):
        np.testing.assert_allclose(float(t), 0.5, rtol=1e-12)
        np.testing.assert_allclose(float(t), float(j), rtol=1e-12)


@pytest.mark.parametrize("case", sorted(MESHES))
def test_courant_numbers_match_orc_tpu(case):
    jd, td = DTYPES["f64"]
    (mj, tj), (mt, ttab) = MESHES[case]("jax", jd), MESHES[case]("torch", td)
    vel, _p, _md = cell_fields(mj.n_cells, seed=8)
    j = jt.courant_numbers(mj, tj, jnp.asarray(vel), 0.02)
    t = tt.courant_numbers(mt, ttab, torch.tensor(vel), 0.02)
    for name, a, r in zip(("avg", "min", "max"), t, j):
        np.testing.assert_allclose(float(a), float(r), rtol=1e-12, err_msg=name)
