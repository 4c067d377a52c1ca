"""k-epsilon RANS: orc_tpu_torch/solver/turbulence.py against orc_tpu's
solver/turbulence.py on the CPU, float64, on the rigs of
tests/test_turbulence.py.

- initial_turbulence: the levels of test_initial_turbulence_levels, and
  equal to orc_tpu's.
- The developing inlet-driven channel 16x12 (Re_h = 2e5, parity SIMPLE,
  explicit relaxation, BiCGSTAB(30)): every StepMetrics field of the
  first 12 outer iterations at rtol 1e-6 (absolute floor 1e-12 x the
  field's largest magnitude), equal inner iteration counts through
  iteration 30, and vel, p, k, eps and mu_t after 30 iterations to 1e-6
  of their scale. The measured gap beyond (ROADMAP Queue 3): the final
  residuals of the inner solves leave rtol 1e-6 first, at iteration 15;
  the fields stay within 1e-8 of scale through iteration 30, then part
  about tenfold every four iterations (1.7e-6 at iteration 40), the
  first inner count differs at iteration 49, and the runs stay within a
  few 1e-3 of each other after that. The port's 200-iteration run is
  held to orc_tpu's own physics bars, as is the MULTIGRID twin.
- The Re_tau = 590 body-force channel at ny = 16 and 10 (800 iterations):
  the DNS bars of test_channel_re_tau_590, and the final profile against
  orc_tpu's at rtol 1e-6. Under SIMPLE_FC (implicit 0.6 / 0.3) the first
  20 iterations track orc_tpu at rtol 1e-6, and the profile chip_smoke.py
  holds the card's 800-iteration FC run to is recomputed from orc_tpu.
- rans_outer_step's interface: orc_tpu's parameter names where both
  packages have the parameter, and a call by keyword (ckg=...) equal to
  solve_steady_turbulent's first iteration.
- Gauss-Seidel solves and MULTIGRID on an irregular mesh (the algebraic
  hierarchy) track orc_tpu, and the sharded loop runs, equal to the
  single-device one.
"""

import importlib.util
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import both, np_, to_jax_settings

import jax.numpy as jnp
from orc_tpu.mesh import structured_box_mesh as jbox
from orc_tpu.mesh.zones import FaceCondition as JFC
from orc_tpu.solver import simple as js
from orc_tpu.solver import turbulence as jt

from orc_tpu_torch import TurbState, initial_turbulence, solve_steady_turbulent
from orc_tpu_torch.interop import turb_state_from_numpy
from orc_tpu_torch.mesh.generate import structured_box_mesh as tbox
from orc_tpu_torch.mesh.zones import FaceCondition as TFC
from orc_tpu_torch.solver import simple as ts
from orc_tpu_torch.solver import turbulence as tt
from orc_tpu_torch.utils import settings as tset

REPO = Path(__file__).resolve().parent.parent

#: tests/test_turbulence.py SETTINGS.
SETTINGS = tset.NumericalSettings(
    momentum=tset.MomentumScheme.UD,
    pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED,
    velocity_interpolation=tset.VelocityInterpolation.LINEAR_WEIGHTED,
    matrix_solver=tset.MatrixSolverSettings(
        solver_type=tset.SolutionMethod.BICGSTAB,
        iterations=30,
        preconditioner=tset.PreconditionMethod.JACOBI,
    ),
    momentum_relaxation=0.6,
    pressure_relaxation=0.05,
)
CHANNEL_KW = dict(u_ref=1.0, intensity=0.05, length_scale=0.14, verbose=False)
RE_TAU, H = 590.0, 2.0
RE_MU = H / 2 / RE_TAU  # rho = u_tau = 1
RE_G = 1.0 / (H / 2)
RE_KW = dict(u_ref=18.0, intensity=0.05, length_scale=0.2 * H, verbose=False)


def smoke_module():
    path = REPO / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def channel(pkg, nx=16, ny=12):
    """tests/test_turbulence.py channel(): the developing channel."""
    box, fc = (jbox, JFC) if pkg == "jax" else (tbox, TFC)
    kw = {} if pkg == "jax" else dict(device="cpu")
    mesh, table = box(nx, ny, 1, lengths=(8.0, 2.0, 0.5), **kw)
    table.set("TOP_WALL", fc.WALL)
    table.set("BOTTOM_WALL", fc.WALL)
    table.set("INLET", fc.VELOCITY_INLET, vector_value=(1.0, 0, 0))
    table.set("OUTLET", fc.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", fc.SYMMETRY)
    table.set("PERIODIC_+Z", fc.SYMMETRY)
    return mesh, table


def re_tau_channel(pkg, ny):
    """The Re_tau = 590 streamwise-periodic channel, 4 x ny, and the
    body force G V of each package's momentum source."""
    box, fc = (jbox, JFC) if pkg == "jax" else (tbox, TFC)
    kw = {} if pkg == "jax" else dict(device="cpu")
    mesh, table = box(4, ny, 1, lengths=(4.0, H, 0.2), periodic=("x",), **kw)
    table.set("BOTTOM_WALL", fc.WALL)
    table.set("TOP_WALL", fc.WALL)
    table.set("PERIODIC_-Z", fc.SYMMETRY)
    table.set("PERIODIC_+Z", fc.SYMMETRY)
    force = RE_G * float(np_(mesh.cell_volume)[0])
    if pkg == "jax":
        def source(cc):
            return jnp.zeros_like(cc).at[:, 0].set(force)
    else:
        def source(cc):
            s = torch.zeros_like(cc)
            s[:, 0] = force
            return s
    return mesh, table, source


def re_tau_settings(fc=False):
    """test_channel_re_tau_590's numerics, or (fc) those of
    test_sharded_turbulent_fc_matches_single_device: SIMPLE_FC, implicit
    relaxation 0.6 / 0.3."""
    s = tset.NumericalSettings(
        momentum=tset.MomentumScheme.UD,
        pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=tset.VelocityInterpolation.RHIE_CHOW,
        matrix_solver=tset.MatrixSolverSettings(
            solver_type=tset.SolutionMethod.BICGSTAB, iterations=30
        ),
    )
    if fc:
        s = s.replace(
            pressure_velocity_coupling=tset.PressureVelocityCoupling.SIMPLE_FC,
            relaxation_mode=tset.RelaxationMode.IMPLICIT,
            momentum_relaxation=0.6,
            pressure_relaxation=0.3,
        )
    return s


def run_re_tau(pkg, ny, iterations, fc=False):
    mesh, table, source = re_tau_channel(pkg, ny)
    s = re_tau_settings(fc)
    kw = dict(RE_KW, iterations=iterations, reporting_interval=iterations)
    if pkg == "jax":
        s = to_jax_settings(s).replace(momentum_source=source)
        return jt.solve_steady_turbulent(mesh, table, s, 1.0, RE_MU, **kw)
    return solve_steady_turbulent(
        mesh, table, s.replace(momentum_source=source), 1.0, RE_MU, **kw
    )


def _assert_tracks(hj, ht, n=None, skip=()):
    """Every StepMetrics field but `skip` of the first n iterations at rtol 1e-6
    (absolute floor 1e-12 x the field's largest magnitude), inner counts
    equal. A field that is roundoff in orc_tpu's run (every entry below
    1e-12: the pressure correction of a channel driven by a body force
    alone, whose p stays 0) must be roundoff in the port's too."""
    for f in hj._fields:
        if f in skip:
            continue
        a = np.asarray(getattr(hj, f))[:n]
        b = np.asarray(getattr(ht, f))[:n]
        assert a.shape == b.shape, f
        if f in ("mom_iters", "pc_iters", "diverged"):
            np.testing.assert_array_equal(b, a, err_msg=f)
            continue
        d = a.astype(np.float64)
        scale = float(np.max(np.abs(d)))
        if scale < 1e-12:
            assert float(np.max(np.abs(b))) < 1e-12, f
            continue
        np.testing.assert_allclose(b, d, rtol=1e-6, atol=1e-12 * scale, err_msg=f)


def _assert_turb_close(tj, tt_, rtol):
    for f in ("k", "eps", "mu_t"):
        np.testing.assert_allclose(
            np_(getattr(tt_, f)), np.asarray(getattr(tj, f)), rtol=rtol, err_msg=f
        )


def test_initial_turbulence_levels():
    (mj, _), (mt, _) = channel("jax", 4, 4), channel("torch", 4, 4)
    t = initial_turbulence(mt, u_ref=2.0, intensity=0.1, length_scale=0.5, rho=1.0)
    assert isinstance(t, TurbState)
    assert np.isclose(float(t.k[0]), 1.5 * (0.1 * 2.0) ** 2)
    assert float(t.mu_t[0]) > 0
    r = jt.initial_turbulence(mj, u_ref=2.0, intensity=0.1, length_scale=0.5, rho=1.0)
    _assert_turb_close(r, t, 1e-15)


def test_developing_channel_tracks_orc_tpu():
    n = 30
    kw = dict(CHANNEL_KW, iterations=n, reporting_interval=10)
    fj, tj, hj = jt.solve_steady_turbulent(
        *channel("jax"), to_jax_settings(SETTINGS), 1.0, 1e-5, **kw
    )
    ft, tt_, ht = solve_steady_turbulent(*channel("torch"), SETTINGS, 1.0, 1e-5, **kw)
    assert len(ht) == 3
    hj, ht = js.stack_history(hj), ts.stack_history(ht)
    _assert_tracks(hj, ht, n=12)
    for f in ("mom_iters", "pc_iters"):
        np.testing.assert_array_equal(getattr(ht, f), np.asarray(getattr(hj, f)), f)
    for f, a, b in (
        ("vel", fj.vel, ft.vel), ("p", fj.p, ft.p), ("k", tj.k, tt_.k),
        ("eps", tj.eps, tt_.eps), ("mu_t", tj.mu_t, tt_.mu_t),
    ):
        a = np.asarray(a)
        np.testing.assert_allclose(
            np_(b), a, rtol=0, atol=1e-6 * float(np.abs(a).max()), err_msg=f
        )


def test_developing_channel_continues_from_orc_tpu_state():
    """orc_tpu's flow and turbulence state after 10 iterations, carried
    over with interop, continue in the port along orc_tpu's trajectory."""
    from orc_tpu_torch.interop import flow_state_from_numpy

    kw = dict(CHANNEL_KW, iterations=10, reporting_interval=10)
    mj, tabj = channel("jax")
    fj, tj, _ = jt.solve_steady_turbulent(mj, tabj, to_jax_settings(SETTINGS), 1.0, 1e-5, **kw)
    fj2, tj2, hj = jt.solve_steady_turbulent(
        mj, tabj, to_jax_settings(SETTINGS), 1.0, 1e-5, state=fj, turb=tj, **kw
    )
    flow = flow_state_from_numpy(
        np.asarray(fj.vel), np.asarray(fj.p), np.asarray(fj.mom_diag), device="cpu"
    )
    turb = turb_state_from_numpy(
        np.asarray(tj.k), np.asarray(tj.eps), np.asarray(tj.mu_t), device="cpu"
    )
    _, tt_, ht = solve_steady_turbulent(
        *channel("torch"), SETTINGS, 1.0, 1e-5, state=flow, turb=turb, **kw
    )
    _assert_tracks(js.stack_history(hj), ts.stack_history(ht))
    _assert_turb_close(tj2, tt_, 1e-6)


@pytest.mark.parametrize("solver", ["bicgstab", "multigrid"])
def test_turbulent_channel_develops(solver):
    """test_turbulent_channel_develops and test_turbulent_channel_multigrid
    on the port: 200 iterations, finite positive fields, mu_t far above
    mu, bulk velocity within 0.15 of the inlet's."""
    s = SETTINGS
    if solver == "multigrid":
        s = s.replace(
            matrix_solver=tset.MatrixSolverSettings(
                solver_type=tset.SolutionMethod.MULTIGRID,
                iterations=30,
                multigrid_levels=3,
                multigrid_smoother_iterations=4,
                preconditioner=tset.PreconditionMethod.JACOBI,
            )
        )
    flow, turb, _ = solve_steady_turbulent(
        *channel("torch"), s, 1.0, 1e-5,
        **dict(CHANNEL_KW, iterations=200, reporting_interval=200),
    )
    k, eps, mu_t, vel = (np_(x) for x in (turb.k, turb.eps, turb.mu_t, flow.vel))
    assert np.isfinite(vel).all() and np.isfinite(k).all()
    assert (k > 0).all() and (eps > 0).all() and (mu_t >= 0).all()
    if solver == "bicgstab":
        assert mu_t.max() / 1e-5 > 50.0, mu_t.max() / 1e-5
    assert abs(vel[:, 0].mean() - 1.0) < 0.15, vel[:, 0].mean()


@pytest.mark.parametrize("ny", [16, 10])
def test_channel_re_tau_590(ny):
    """test_channel_re_tau_590's DNS bars (Moser, Kim & Mansour 1999:
    U_b+ 18.5 within 10%, U_c+ 21.26 within 5%, the wall cell on the log
    law within 5%, its k at 1/sqrt(C_mu) within 10%, a streamwise-
    invariant, symmetric profile) on the port, and its final profile
    against orc_tpu's at rtol 1e-6."""
    flow, turb, _ = run_re_tau("torch", ny, 800)
    u = np_(flow.vel)[:, 0].reshape(ny, 4)
    u_prof = u.mean(axis=1)
    U_b, U_c = u_prof.mean(), u_prof.max()
    assert abs(U_b - 18.5) / 18.5 < 0.10, f"U_b+ = {U_b:.2f}"
    assert abs(U_c - 21.26) / 21.26 < 0.05, f"U_c+ = {U_c:.2f}"
    yp1 = RE_TAU * (H / ny) / 2
    assert abs(u_prof[0] - np.log(tt.E_WALL * yp1) / tt.KAPPA) < 0.05 * u_prof[0]
    k1 = np_(turb.k).reshape(ny, 4).mean(axis=1)[0]
    assert abs(k1 - 0.09**-0.5) / 0.09**-0.5 < 0.10, k1
    assert np.abs(u.std(axis=1)).max() < 1e-3
    np.testing.assert_allclose(u_prof, u_prof[::-1], rtol=1e-3)
    fj, tj, _ = run_re_tau("jax", ny, 800)
    ref = np.asarray(fj.vel)[:, 0].reshape(ny, 4).mean(axis=1)
    np.testing.assert_allclose(u_prof, ref, rtol=1e-6)
    _assert_turb_close(tj, turb, 1e-4)


#: The metrics of the pressure solve, noise in a SIMPLE_FC body-force
#: channel: without pressure zones the full-p system is solved deflated
#: and its right-hand side is roundoff (p stays 0), so its BiCGSTAB's
#: counts and residuals differ between any two implementations.
FC_PRESSURE_NOISE = ("p_corr_norm", "pc_residual", "pc_iters")


def test_channel_re_tau_590_fc_tracks_orc_tpu():
    """Under SIMPLE_FC the velocity and turbulence metrics of the first
    20 iterations track orc_tpu (the pressure solve's are noise:
    FC_PRESSURE_NOISE), and so do the fields after them."""
    fj, tj, hj = run_re_tau("jax", 16, 20, fc=True)
    ft, tt_, ht = run_re_tau("torch", 16, 20, fc=True)
    _assert_tracks(
        js.stack_history(hj), ts.stack_history(ht), skip=FC_PRESSURE_NOISE
    )
    assert float(np.abs(np_(ft.p)).max()) < 1e-12
    _assert_turb_close(tj, tt_, 1e-6)
    a = np.asarray(fj.vel)
    np.testing.assert_allclose(np_(ft.vel), a, rtol=0, atol=1e-9 * float(np.abs(a).max()))


def test_re_tau_fc_reference_profile():
    """chip_smoke.py holds the card's SIMPLE_FC Re_tau = 590 channel (ny =
    16, 800 iterations) to orc_tpu's u profile; recompute it from
    orc_tpu."""
    flow, _, _ = run_re_tau("jax", 16, 800, fc=True)
    prof = np.asarray(flow.vel)[:, 0].reshape(16, 4).mean(axis=1)
    np.testing.assert_allclose(
        prof, smoke_module().ORC_TPU_RE_TAU_FC_U_PROFILE_800, rtol=1e-9
    )


def test_rans_outer_step_signature_matches_orc_tpu():
    """The parameters both packages' rans_outer_step take have orc_tpu's
    names, in orc_tpu's order, `solver_extras` and the sharded hook
    `comm` included."""
    j = list(inspect.signature(jt.rans_outer_step).parameters)
    t = list(inspect.signature(tt.rans_outer_step).parameters)
    assert j == t
    assert t[1] == "ckg" and "comm" in t


def test_rans_outer_step_takes_its_arguments_by_keyword():
    """One outer iteration of the 16x12 developing channel, every
    argument passed by keyword (ckg=...), equals solve_steady_turbulent's
    first iteration bit for bit."""
    from orc_tpu_torch.ops.ck_ops import build_ck_geometry, ck_bc
    from orc_tpu_torch.ops.fields import WALL, device_bc
    from orc_tpu_torch.solver.simple import initial_state

    mesh, table = channel("torch")
    flow, turb, _ = solve_steady_turbulent(
        mesh, table, SETTINGS, 1.0, 1e-5, iterations=1, reporting_interval=1, **CHANNEL_KW
    )
    zc, zs, zv = device_bc(table, dtype=mesh.dtype, device=mesh.device)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc0 = ck_bc(ck, zc, zs, zv)
    has_wall, y_p = tt._wall_adjacent(ck, bc0)
    k_in = 1.5 * (CHANNEL_KW["intensity"] * CHANNEL_KW["u_ref"]) ** 2
    tb0 = initial_turbulence(mesh, CHANNEL_KW["u_ref"], CHANNEL_KW["intensity"],
                             CHANNEL_KW["length_scale"], 1.0)
    (flow1, turb1), metrics = tt.rans_outer_step(
        mesh=mesh, ckg=ck, bc0=bc0, zc=zc, zs=zs, zv=zv, settings=SETTINGS, rho=1.0,
        mu=1e-5, k_in=k_in, eps_in=tt.C_MU ** 0.75 * k_in ** 1.5 / CHANNEL_KW["length_scale"],
        has_wall=has_wall, y_p=y_p, is_wall_face=(bc0.code == WALL) & ck.mask & ~ck.interior,
        carry=(initial_state(mesh), tb0),
    )
    for a, b in ((flow1.vel, flow.vel), (flow1.p, flow.p), (turb1.k, turb.k),
                 (turb1.eps, turb.eps), (turb1.mu_t, turb.mu_t)):
        assert torch.equal(a, b)
    assert int(metrics.pc_iters) > 0


def _rans_both(jcase, tcase, settings, iterations):
    kw = dict(iterations=iterations, reporting_interval=iterations, **RE_KW)
    fj, tj, hj = jt.solve_steady_turbulent(
        *jcase, to_jax_settings(settings), 1.0, 1e-5, **kw
    )
    ft, tt_, ht = solve_steady_turbulent(*tcase, settings, 1.0, 1e-5, **kw)
    _assert_tracks(js.stack_history(hj), ts.stack_history(ht))
    _assert_turb_close(tj, tt_, 1e-6)
    for f in ("vel", "p"):
        a = np.asarray(getattr(fj, f))
        np.testing.assert_allclose(
            np_(getattr(ft, f)), a, rtol=0, atol=1e-8 * float(np.abs(a).max())
        )


def test_unported_paths_raise():
    """The paths this test once refused now run and track orc_tpu for 3
    iterations: Gauss-Seidel solves on the 6x4 channel (explicit
    relaxation, so the momentum and k/eps solves take the colouring
    too) and MULTIGRID on the permuted cavity (the algebraic
    hierarchy). The sharded loop, which this test once held to raise,
    runs the 6x4 channel over 2 partitions equal to one device."""
    gs = SETTINGS.replace(
        matrix_solver=tset.MatrixSolverSettings(
            solver_type=tset.SolutionMethod.GAUSS_SEIDEL
        )
    )
    _rans_both(channel("jax", 6, 4), channel("torch", 6, 4), gs, 3)
    mg = SETTINGS.replace(
        matrix_solver=tset.MatrixSolverSettings(solver_type=tset.SolutionMethod.MULTIGRID)
    )
    jcase, tcase = both("permuted")
    _rans_both(jcase, tcase, mg, 3)
    mesh, table = channel("torch", 6, 4)
    kw = dict(iterations=2, reporting_interval=2, **CHANNEL_KW)
    f1, t1, _ = solve_steady_turbulent(mesh, table, SETTINGS, 1.0, 1e-5, **kw)
    f2, t2, _ = tt.solve_steady_turbulent_sharded(
        mesh, table, SETTINGS, 1.0, 1e-5, n_devices=2, **kw
    )
    for a, b in ((f2.vel, f1.vel), (f2.p, f1.p), (t2.k, t1.k), (t2.mu_t, t1.mu_t)):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-8, atol=1e-12)
