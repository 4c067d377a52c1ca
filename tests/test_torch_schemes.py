"""The (c,k) step's remaining schemes against orc_tpu on the CPU, float64:
least-squares gradients, CD2 and in-matrix TVD momentum (one matrix per
velocity component), with test_ck.py's "lsq", "cd2" and "tvd" settings.

- solve_steady under SIMPLE and under SIMPLE_FC (forced, its pressure
  solved by Jacobi(50): ROADMAP Queue 3 on BiCGSTAB and the full-p
  system) on test_ck.py's 8x6 pressure-driven channel and on the permuted
  13^2 cavity (RCM order, slice plan: the per-component matrices through
  the slice SpMV, CD2's 9-field velocity-gradient gather): three
  iterations, one under TVD momentum ("lsq" and "tvd"), whose limiter
  flips branches on rounding (test_ck.py; measured: the permuted "lsq"
  cavity's mean w parts by 3.5e-4 at its third iteration). Every StepMetrics field at rtol 1e-6 (absolute floor
  1e-12 x the field's largest magnitude), inner counts equal, final vel,
  p and mom_diag to 1e-6 of their scale.
- solve_transient with least squares and CD2 under both couplings, 2
  steps x 3 inner iterations, the same way.
- The least-squares gradients on a periodic box, entry for entry at rtol
  1e-10 (the other meshes are in test_torch_ck_ops.py).
"""

import numpy as np
import pytest
import torch

from torch_parity import both, np_, to_jax_settings

import jax.numpy as jnp
from orc_tpu.mesh import structured_box_mesh as jbox
from orc_tpu.mesh.zones import FaceCondition as JFC
from orc_tpu.ops import ck_ops as jck
from orc_tpu.ops.fields import device_bc as jdevice_bc
from orc_tpu.solver import simple as js
from orc_tpu.solver import transient as jtr

from orc_tpu_torch.mesh.generate import structured_box_mesh as tbox
from orc_tpu_torch.mesh.zones import FaceCondition as TFC
from orc_tpu_torch.ops import ck_ops as tck
from orc_tpu_torch.ops.fields import device_bc as tdevice_bc
from orc_tpu_torch.solver import simple as ts
from orc_tpu_torch.solver import transient as ttr
from orc_tpu_torch.utils import settings as tset

RHO, MU = 1000.0, 0.001
BICGSTAB_25 = tset.MatrixSolverSettings(
    solver_type=tset.SolutionMethod.BICGSTAB,
    iterations=25,
    preconditioner=tset.PreconditionMethod.JACOBI,
)
JACOBI_50 = tset.MatrixSolverSettings(
    solver_type=tset.SolutionMethod.JACOBI,
    iterations=50,
    preconditioner=tset.PreconditionMethod.JACOBI,
)
#: tests/test_ck.py SCHEMES "lsq", "cd2" and "tvd".
SCHEMES = {
    "lsq": tset.NumericalSettings(
        momentum=tset.MomentumScheme.TVD,
        tvd_psi=tset.tvd_umist,
        gradient_reconstruction=tset.GradientReconstruction.LEAST_SQUARES,
        pressure_interpolation=tset.PressureInterpolation.SECOND_ORDER,
        velocity_interpolation=tset.VelocityInterpolation.RHIE_CHOW,
        matrix_solver=BICGSTAB_25,
    ),
    "cd2": tset.NumericalSettings(
        momentum=tset.MomentumScheme.CD2,
        pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=tset.VelocityInterpolation.LINEAR_WEIGHTED,
        matrix_solver=BICGSTAB_25,
    ),
    "tvd": tset.NumericalSettings(
        momentum=tset.MomentumScheme.TVD,
        tvd_psi=tset.tvd_umist,
        pressure_interpolation=tset.PressureInterpolation.LINEAR,
        velocity_interpolation=tset.VelocityInterpolation.LINEAR,
        matrix_solver=BICGSTAB_25,
    ),
}


def settings_of(scheme, coupling):
    s = SCHEMES[scheme]
    if coupling == "fc":
        s = s.replace(
            pressure_velocity_coupling=tset.PressureVelocityCoupling.SIMPLE_FC,
            matrix_solver=JACOBI_50,
        )
    return s


def channel(pkg):
    """tests/test_ck.py make_case(): 8x6, moving top wall, pressure
    inlet and outlet."""
    box, fc = (jbox, JFC) if pkg == "jax" else (tbox, TFC)
    kw = {} if pkg == "jax" else dict(device="cpu")
    mesh, table = box(8, 6, 1, lengths=(0.002, 0.001, 0.0001), **kw)
    table.set("TOP_WALL", fc.WALL, vector_value=(5e-4, 0, 0))
    table.set("INLET", fc.PRESSURE_INLET, scalar_value=0.01)
    table.set("OUTLET", fc.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", fc.SYMMETRY)
    table.set("PERIODIC_+Z", fc.SYMMETRY)
    return mesh, table


#: name -> (rho, mu, scale of the seeded start velocity and pressure).
FLUIDS = {"channel": (RHO, MU, 1e-4, 1e-3), "permuted": (1.0, 0.01, 1e-2, 1e-3)}


def meshes(name):
    if name == "channel":
        return channel("jax"), channel("torch")
    return both("permuted")


def start(name, mj, mt, seed=0):
    """A seeded nontrivial start state (test_ck.py's on the channel), in
    both packages."""
    _, _, sv, sp = FLUIDS[name]
    rng = np.random.default_rng(seed)
    vel = rng.standard_normal((mj.n_cells, 3)) * sv
    p = rng.standard_normal(mj.n_cells) * sp
    return js.initial_state(mj, vel=vel, p=p), ts.initial_state(mt, vel=vel, p=p)


def assert_tracks(hj, ht):
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


def assert_state_close(sj, st):
    for f in ("vel", "p", "mom_diag"):
        a = np.asarray(getattr(sj, f))
        np.testing.assert_allclose(
            np_(getattr(st, f)), a, rtol=0, atol=1e-6 * float(np.abs(a).max()),
            err_msg=f,
        )


@pytest.mark.parametrize("coupling", ["simple", "fc"])
@pytest.mark.parametrize("mesh", ["channel", "permuted"])
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_scheme_tracks_orc_tpu(scheme, mesh, coupling):
    settings = settings_of(scheme, coupling)
    n = 1 if settings.momentum == tset.MomentumScheme.TVD else 3
    (mj, tj), (mt, tt) = meshes(mesh)
    s0j, s0t = start(mesh, mj, mt)
    rho, mu = FLUIDS[mesh][:2]
    kw = dict(iterations=n, reporting_interval=n, verbose=False, use_ck=True)
    sj, hj = js.solve_steady(mj, tj, to_jax_settings(settings), rho, mu, state=s0j, **kw)
    st, ht = ts.solve_steady(mt, tt, settings, rho, mu, state=s0t, **kw)
    assert_tracks(js.stack_history(hj), ts.stack_history(ht))
    assert_state_close(sj, st)


@pytest.mark.parametrize("coupling", ["simple", "fc"])
@pytest.mark.parametrize("scheme", ["lsq", "cd2"])
def test_transient_scheme_tracks_orc_tpu(scheme, coupling):
    settings = settings_of(scheme, coupling)
    (mj, tj), (mt, tt) = meshes("channel")
    s0j, s0t = start("channel", mj, mt, seed=1)
    kw = dict(dt=1e-3, n_steps=2, inner_iterations=3, verbose=False)
    sj, hj = jtr.solve_transient(mj, tj, to_jax_settings(settings), RHO, MU, state=s0j, **kw)
    st, ht = ttr.solve_transient(mt, tt, settings, RHO, MU, state=s0t, **kw)
    assert_tracks(hj, ht)
    assert_state_close(sj, st)


def test_lsq_gradients_on_a_periodic_box():
    """ck_lsq_pressure_gradient / ck_lsq_velocity_gradient on a box
    periodic in x (the wrap rows see the neighbour's translated image),
    entry for entry at rtol 1e-10."""
    out = []
    for pkg in ("jax", "torch"):
        box, fc, ops, dbc = (
            (jbox, JFC, jck, jdevice_bc) if pkg == "jax"
            else (tbox, TFC, tck, lambda t: tdevice_bc(t, device="cpu"))
        )
        kw = {} if pkg == "jax" else dict(device="cpu")
        mesh, table = box(6, 5, 1, lengths=(3.0, 1.0, 0.2), periodic=("x",), **kw)
        table.set("BOTTOM_WALL", fc.WALL)
        table.set("TOP_WALL", fc.WALL, vector_value=(1.0, 0, 0))
        table.set("PERIODIC_-Z", fc.SYMMETRY)
        table.set("PERIODIC_+Z", fc.SYMMETRY)
        rng = np.random.default_rng(5)
        arr = jnp.asarray if pkg == "jax" else torch.from_numpy
        vel = arr(rng.standard_normal((mesh.n_cells, 3)))
        p = arr(rng.standard_normal(mesh.n_cells))
        ck = ops.build_ck_geometry(mesh, len(table.zone_ids))
        bc = ops.ck_bc(ck, *dbc(table))
        out.append((
            ops.ck_lsq_pressure_gradient(mesh, ck, bc, p),
            ops.ck_lsq_velocity_gradient(mesh, ck, bc, vel),
        ))
    for a, b in zip(out[1], out[0]):
        b = np.asarray(b)
        np.testing.assert_allclose(np_(a), b, rtol=1e-10, atol=1e-13 * np.abs(b).max())
