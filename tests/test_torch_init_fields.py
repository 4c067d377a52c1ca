"""Field initialisation, divergence recovery and the channel driver of the
port (orc_tpu_torch/solver/init_fields.py, solver/recovery.py,
models/channel_flow.solve_channel_flow) against orc_tpu on the CPU,
float64.

- check_boundary_conditions and the classification without checks
  equal orc_tpu's on pressure-driven, velocity-driven, hybrid and
  periodic cases (tests/test_periodic.py:275-285, the duct of
  tests/test_cases_2d.py on a box and on a permuted 2-D mesh), and
  raise where orc_tpu raises.
- initialize_pressure_field, initialize_velocity_field (vel and psi),
  initialize_flow and initialize_flow_ramp within 1e-10 of orc_tpu's on
  those cases; the plug profile of
  tests/test_channel_flow.py::test_potential_flow_init_plug_profile.
- solve_steady_with_recovery on tests/test_aux.py:73-119's case: the
  same recovery log and the state within 1e-8.
- solve_channel_flow for Poiseuille and Couette at 8x8: with
  tests/test_channel_flow.py's ROBUST numerics (1500 iterations) the
  same `passed` flags (True) and every statistic within 1e-8; with the
  default numerics (MULTIGRID on the geometric hierarchy, explicit
  relaxation), 5 iterations, every statistic within 1e-8. The default
  Poiseuille run amplifies roundoff about tenfold an iteration, with
  equal inner counts: its statistics part by 1.8e-13 after 5
  iterations, 6.5e-10 after 10, 1.1e-6 after 15 and 3.5e-4 after 19
  (ROADMAP Queue 3).
"""

import numpy as np
import pytest
import torch

from torch_parity import _cavity_table, compiled_both, np_, permuted_arrays, to_jax_settings

from orc_tpu.mesh.generate import structured_box_mesh as jbox
from orc_tpu.mesh.zones import FaceCondition as JFC
from orc_tpu.models import channel_flow as jcf
from orc_tpu.solver import init_fields as ji
from orc_tpu.solver.recovery import solve_steady_with_recovery as jrecover

from orc_tpu_torch.mesh.generate import structured_box_mesh as tbox
from orc_tpu_torch.mesh.zones import FaceCondition as TFC
from orc_tpu_torch.models import channel_flow as tcf
from orc_tpu_torch.solver import init_fields as ti
from orc_tpu_torch.solver.recovery import solve_steady_with_recovery as trecover
from orc_tpu_torch.utils import settings as tset

TOL = 1e-10


def _couette(pkg, **kw):
    vin = kw.pop("velocity_inlet", None)
    if pkg == "jax":
        return jcf.couette_case(nx=8, ny=8, params=jcf.ChannelFlowParameters(**kw), velocity_inlet=vin)
    return tcf.couette_case(
        nx=8, ny=8, params=tcf.ChannelFlowParameters(**kw), velocity_inlet=vin, device="cpu"
    )


def _duct_zones(table, fc):
    table.set("INLET", fc.PRESSURE_INLET, scalar_value=100.0)
    table.set("OUTLET", fc.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("TOP_WALL", fc.WALL, vector_value=(0.0, 0.0, 0.0))
    table.set("BOTTOM_WALL", fc.WALL)
    return table


def _duct(pkg):
    """tests/test_cases_2d.py's pressure-driven duct on a 6x3 box."""
    box, fc = (jbox, JFC) if pkg == "jax" else (tbox, TFC)
    kw = {} if pkg == "jax" else dict(device="cpu")
    mesh, table = box(6, 3, 1, lengths=(2.0, 1.0, 0.1), **kw)
    table.set("PERIODIC_-Z", fc.SYMMETRY)
    table.set("PERIODIC_+Z", fc.SYMMETRY)
    return mesh, _duct_zones(table, fc)


def _permuted(pkg, duct):
    """The permuted 12^2 cavity (a 2-D mesh, RCM order, slice plan), lid
    driven or, as a duct, pressure driven."""
    mj, mt = compiled_both(permuted_arrays(12, seed=1)[0])
    table = _cavity_table(pkg)
    if duct:
        table = _duct_zones(table, JFC if pkg == "jax" else TFC)
    return (mj if pkg == "jax" else mt), table


def _plug(pkg):
    """tests/test_channel_flow.py::test_potential_flow_init_plug_profile:
    a one-cell-thick 3-D channel with a velocity inlet."""
    box, fc = (jbox, JFC) if pkg == "jax" else (tbox, TFC)
    kw = {} if pkg == "jax" else dict(device="cpu")
    mesh, table = box(8, 4, 1, lengths=(2e-3, 1e-3, 1e-4), **kw)
    table.set("TOP_WALL", fc.WALL)
    table.set("BOTTOM_WALL", fc.WALL)
    table.set("INLET", fc.VELOCITY_INLET, vector_value=(1e-3, 0, 0))
    table.set("OUTLET", fc.PRESSURE_OUTLET)
    table.set("PERIODIC_-Z", fc.SYMMETRY)
    table.set("PERIODIC_+Z", fc.SYMMETRY)
    return mesh, table


def _periodic(pkg):
    """tests/test_periodic.py periodic_channel()."""
    box, fc = (jbox, JFC) if pkg == "jax" else (tbox, TFC)
    kw = {} if pkg == "jax" else dict(device="cpu")
    mesh, table = box(8, 24, 1, lengths=(2.0, 1.0, 0.1), periodic=("x",), **kw)
    table.set("BOTTOM_WALL", fc.WALL)
    table.set("TOP_WALL", fc.WALL)
    table.set("PERIODIC_-Z", fc.SYMMETRY)
    table.set("PERIODIC_+Z", fc.SYMMETRY)
    return mesh, table


#: name -> (make(pkg), expected classification)
CASES = {
    "couette-hybrid": (lambda pkg: _couette(pkg, top_wall_velocity=5e-4, dp_dx=5.0), "hybrid"),
    "couette-vinlet": (lambda pkg: _couette(pkg, velocity_inlet=1e-3), "velocity_only"),
    "duct": (_duct, "pressure_only"),
    "permuted-lid": (lambda pkg: _permuted(pkg, False), "velocity_only"),
    "permuted-duct": (lambda pkg: _permuted(pkg, True), "pressure_only"),
    "plug3d": (_plug, "velocity_only"),
    "periodic": (_periodic, "unconstrained"),
}


def _both(name):
    make, _ = CASES[name]
    return make("jax"), make("torch")


def _close(actual, desired, tol=TOL, name=""):
    d = np.asarray(desired, dtype=np.float64)
    scale = float(np.abs(d).max()) if d.size else 0.0
    np.testing.assert_allclose(np_(actual), d, rtol=tol, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_classification_matches_orc_tpu(name):
    (mj, tj), (mt, tt) = _both(name)
    assert ti.check_boundary_conditions(mt, tt).value == CASES[name][1]
    assert ji.check_boundary_conditions(mj, tj).value == CASES[name][1]
    assert ti._classify_only(tt).value == ji._classify_only(tj).value


def _raising_tables(pkg):
    fc = JFC if pkg == "jax" else TFC
    m, t = _couette(pkg)
    for z in ("INLET", "OUTLET"):
        t.set(z, fc.WALL)
    yield m, t  # walls only: no boundary condition drives the flow
    m, t = _couette(pkg)
    t.set("TOP_WALL", fc.WALL, vector_value=(0.0, 1e-3, 0.0))
    yield m, t  # a wall velocity along the wall's normal
    m, t = _couette(pkg, velocity_inlet=1e-3)
    t.set("INLET", fc.VELOCITY_INLET, vector_value=(0.0, 0.0, 0.0))
    yield m, t  # a velocity inlet without a velocity


def test_invalid_boundary_conditions_raise_as_orc_tpu():
    for (mj, tj), (mt, tt) in zip(_raising_tables("jax"), _raising_tables("torch")):
        with pytest.raises(ValueError) as ej:
            ji.check_boundary_conditions(mj, tj)
        with pytest.raises(ValueError) as et:
            ti.check_boundary_conditions(mt, tt)
        assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("name", sorted(set(CASES) - {"periodic"}))
def test_init_fields_match_orc_tpu(name):
    (mj, tj), (mt, tt) = _both(name)
    _close(ti.initialize_pressure_field(mt, tt), ji.initialize_pressure_field(mj, tj), name="p")
    vt, psit = ti.initialize_velocity_field(mt, tt)
    vj, psij = ji.initialize_velocity_field(mj, tj)
    _close(vt, vj, name="vel")
    _close(psit, psij, name="psi")


@pytest.mark.parametrize("name", sorted(CASES))
def test_initialize_flow_matches_orc_tpu(name):
    (mj, tj), (mt, tt) = _both(name)
    sj, st = ji.initialize_flow(mj, tj, 1e-3, 1000.0), ti.initialize_flow(mt, tt, 1e-3, 1000.0)
    for f in ("vel", "p", "mom_diag"):
        _close(getattr(st, f), getattr(sj, f), name=f)
    assert st.vel.dtype == torch.float64 and st.mom_diag.shape == (3, mt.n_cells)
    if name == "periodic":
        assert float(st.vel.abs().max()) == 0.0 and float(st.p.abs().max()) == 0.0


@pytest.mark.parametrize("name", ["couette-hybrid", "couette-vinlet", "permuted-duct"])
def test_initialize_flow_ramp_matches_orc_tpu(name):
    (mj, tj), (mt, tt) = _both(name)
    sj = ji.initialize_flow_ramp(mj, tj, 1e-3, 1000.0, iterations=40)
    st = ti.initialize_flow_ramp(mt, tt, 1e-3, 1000.0, iterations=40)
    _close(st.vel, sj.vel, name="vel")
    _close(st.p, sj.p, name="p")


def test_plug_profile():
    """The assertions of test_potential_flow_init_plug_profile."""
    mesh, table = _plug("torch")
    vel, _ = ti.initialize_velocity_field(mesh, table)
    u = np_(vel[:, 0])
    np.testing.assert_allclose(u, 1e-3, rtol=0.05)
    assert np.abs(np_(vel[:, 1])).max() < 1e-4
    assert abs(u.mean() - 1e-3) / 1e-3 < 0.01


def _recovery_settings():
    """tests/test_aux.py::test_recovery_backs_off_and_completes: an
    over-relaxed Jacobi solver on every solve, which diverges."""
    return tset.NumericalSettings(
        momentum=tset.MomentumScheme.UD,
        pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=tset.VelocityInterpolation.LINEAR_WEIGHTED,
        matrix_solver=tset.MatrixSolverSettings(
            solver_type=tset.SolutionMethod.JACOBI, iterations=4, relaxation=1.9,
            momentum_iterations=None,
        ),
        pressure_relaxation=0.5,
        momentum_relaxation=1.0,
    )


def test_recovery_matches_orc_tpu():
    kw = dict(iterations=40, reporting_interval=10, max_retries=5, verbose=False)
    mj, tj = jcf.couette_case(nx=4, ny=4, params=jcf.ChannelFlowParameters(dp_dx=500.0))
    mt, tt = tcf.couette_case(nx=4, ny=4, params=tcf.ChannelFlowParameters(dp_dx=500.0), device="cpu")
    settings = _recovery_settings()
    sj, hj, log_j = jrecover(mj, tj, to_jax_settings(settings), 1000.0, 0.001, **kw)
    st, ht, log_t = trecover(mt, tt, settings, 1000.0, 0.001, **kw)
    assert log_t == log_j and len(log_t) >= 1
    assert log_t[0]["pressure_relaxation"] < 0.5
    assert len(ht) == len(hj)
    assert np.isfinite(np_(st.vel)).all()
    for f in ("vel", "p"):
        _close(getattr(st, f), getattr(sj, f), tol=1e-8, name=f)


def test_recovery_reraises_past_max_retries():
    from orc_tpu_torch.solver.simple import SolverDivergedError

    mt, tt = tcf.couette_case(nx=4, ny=4, params=tcf.ChannelFlowParameters(dp_dx=500.0), device="cpu")
    with pytest.raises(SolverDivergedError):
        trecover(mt, tt, _recovery_settings(), 1000.0, 0.001, iterations=40,
                 reporting_interval=10, max_retries=0, verbose=False)


ROBUST = tset.NumericalSettings(
    momentum=tset.MomentumScheme.UD,
    pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED,
    velocity_interpolation=tset.VelocityInterpolation.LINEAR_WEIGHTED,
    matrix_solver=tset.MatrixSolverSettings(
        solver_type=tset.SolutionMethod.BICGSTAB, iterations=50,
        preconditioner=tset.PreconditionMethod.JACOBI,
    ),
    pressure_relaxation=0.03,
)
PARAMS = {"poiseuille": dict(dp_dx=5.0), "couette": dict(top_wall_velocity=5e-4)}


def _channel_both(params, settings, iterations, **kw):
    run = dict(iterations=iterations, reporting_interval=iterations, verbose=False, **kw)
    a = jcf.solve_channel_flow(
        jcf.ChannelFlowParameters(**params),
        None if settings is None else to_jax_settings(settings), **run,
    )
    b = tcf.solve_channel_flow(tcf.ChannelFlowParameters(**params), settings, device="cpu", **run)
    stats = [k for k, v in a.items() if isinstance(v, float)]
    assert len(stats) == 12 and set(stats) <= set(b)
    for k in stats:
        assert abs(b[k] - a[k]) <= 1e-8 * abs(a[k]), (k, a[k], b[k])
    for k in ("mean_ok", "min_ok", "max_ok", "passed"):
        assert b[k] == a[k], k
    return b


@pytest.mark.parametrize("case", sorted(PARAMS))
def test_channel_flow_matches_orc_tpu(case):
    r = _channel_both(PARAMS[case], ROBUST, 1500, validation_threshold=0.05)
    assert r["passed"]


@pytest.mark.parametrize("case", sorted(PARAMS))
def test_channel_flow_default_numerics_track_orc_tpu(case):
    r = _channel_both(PARAMS[case], None, 5)
    assert r["history"][0].pc_iters.shape == (5,)
