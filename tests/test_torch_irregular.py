"""The irregular-mesh slice as a whole: orc_tpu_torch's steady SIMPLE and
SIMPLE_FC loops on a randomly permuted cavity (RCM order, slice-plan
SpMV and neighbour gather) against orc_tpu's on CPU, and against the
port's own structured twin.

- parity SIMPLE, permuted 12^2 f64 cavity, solve_cavity's settings
  (BiCGSTAB(50) pressure, 6-sweep momentum smoother), 60 iterations:
  every StepMetrics field tracks orc_tpu at rtol 1e-6 per iteration
  (absolute floor 1e-12 of the field's scale), equal mom_iters and
  pc_iters, fields to 1e-8 of scale;
- the same run against the port's structured 12^2 cavity, mapped
  through the permutation: rtol 1e-8 (tests/test_reorder.py's
  test_irregular_solve_matches_structured);
- SIMPLE_FC (UD + Rhie-Chow, BiCGSTAB(50)) after 400 iterations against
  the structured run at atol 5e-8 (tests/test_fc.py's
  test_fc_irregular_mesh_matches_structured), and per iteration against
  orc_tpu with a Jacobi(50) pressure solve (the full-p BiCGSTAB
  amplifies roundoff, ROADMAP Queue 3);
- a TGRID couette through `couette_case(mesh_path=...)`, 20 iterations
  against orc_tpu's.
"""

import numpy as np
import pytest
import torch

from torch_parity import compiled_both, np_, permuted_arrays, to_jax_settings

from orc_tpu.models.cavity import cavity_case as j_cavity
from orc_tpu.solver import simple as js

from orc_tpu_torch.models.cavity import cavity_case as t_cavity, default_settings
from orc_tpu_torch.solver import simple as ts
from orc_tpu_torch.utils import settings as tset


def _fc_settings(solver):
    return tset.NumericalSettings(
        momentum=tset.MomentumScheme.UD,
        pressure_velocity_coupling=tset.PressureVelocityCoupling.SIMPLE_FC,
        pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=tset.VelocityInterpolation.RHIE_CHOW,
        relaxation_mode=tset.RelaxationMode.IMPLICIT,
        momentum_relaxation=0.7,
        pressure_relaxation=0.3,
        matrix_solver=tset.MatrixSolverSettings(
            solver_type=solver, iterations=50,
            preconditioner=tset.PreconditionMethod.JACOBI,
        ),
    )


def _permuted(n=12, seed=9):
    kw, perm = permuted_arrays(n, seed=seed)
    mj, mt = compiled_both(kw)
    return mj, mt, perm


def _solve(pkg, mesh, settings, iterations, mu=0.01):
    kw = dict(iterations=iterations, reporting_interval=iterations, verbose=False)
    if pkg == "jax":
        _, table = j_cavity(n=4)
        s, h = js.solve_steady(
            mesh, table, to_jax_settings(settings), 1.0, mu,
            state=js.initial_state(mesh), **kw,
        )
        return s, js.stack_history(h)
    _, table = t_cavity(n=4, device="cpu")
    s, h = ts.solve_steady(
        mesh, table, settings, 1.0, mu, state=ts.initial_state(mesh), **kw
    )
    return s, ts.stack_history(h)


def _assert_tracks(jres, tres, fields=("vel", "p")):
    (sj, hj), (st, ht) = jres, tres
    for f in hj._fields:
        a, b = np.asarray(getattr(hj, f)), getattr(ht, f)
        assert a.shape == b.shape, f
        if f in ("mom_iters", "pc_iters", "diverged"):
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            d = a.astype(np.float64)
            np.testing.assert_allclose(
                b, d, rtol=1e-6, atol=1e-12 * float(np.max(np.abs(d))),
                err_msg=f,
            )
    for f in fields:
        d = np_(getattr(sj, f))
        np.testing.assert_allclose(
            np_(getattr(st, f)), d, rtol=1e-8,
            atol=1e-8 * float(np.max(np.abs(d))), err_msg=f,
        )


def _to_box_order(mesh, perm, field):
    """A compiled-order cell field of the permuted mesh in the box's
    cell order (through cell_order, then the permutation)."""
    raw = np.empty_like(field)
    raw[np_(mesh.cell_order)] = field
    out = np.empty_like(raw)
    out[perm] = raw
    return out


def test_irregular_simple_tracks_orc_tpu():
    mj, mt, _ = _permuted()
    assert mt.neighbor_offsets is None and mt.slice_plan is not None
    _assert_tracks(
        _solve("jax", mj, default_settings(), 60),
        _solve("torch", mt, default_settings(), 60),
    )


def test_irregular_simple_matches_structured_twin():
    _, mt, perm = _permuted()
    mesh_s, _ = t_cavity(n=12, device="cpu")
    ss, _ = _solve("torch", mesh_s, default_settings(), 60)
    si, hi = _solve("torch", mt, default_settings(), 60)
    assert not hi.diverged.any()
    np.testing.assert_allclose(
        _to_box_order(mt, perm, np_(si.vel)), np_(ss.vel), rtol=1e-8, atol=1e-10
    )


def test_irregular_fc_matches_structured_twin():
    _, mt, perm = _permuted(seed=5)
    mesh_s, _ = t_cavity(n=12, device="cpu")
    s = _fc_settings(tset.SolutionMethod.BICGSTAB)
    ss, _ = _solve("torch", mesh_s, s, 400)
    si, hi = _solve("torch", mt, s, 400)
    assert not hi.diverged.any()
    np.testing.assert_allclose(
        _to_box_order(mt, perm, np_(si.vel)), np_(ss.vel), rtol=0, atol=5e-8
    )


def test_irregular_fc_tracks_orc_tpu_with_jacobi_pressure():
    mj, mt, _ = _permuted(seed=5)
    s = _fc_settings(tset.SolutionMethod.JACOBI)
    _assert_tracks(
        _solve("jax", mj, s, 20), _solve("torch", mt, s, 20),
        fields=("vel", "p", "flux"),
    )


def test_couette_case_reads_tgrid(tmp_path):
    """couette_case(mesh_path=...) through the port's TGRID reader: the
    written 16x8 channel, 20 parity iterations, against orc_tpu's."""
    from orc_tpu.models.channel_flow import ChannelFlowParameters as JParams
    from orc_tpu.models.channel_flow import couette_case as j_couette

    from orc_tpu_torch.mesh.generate import write_tgrid
    from orc_tpu_torch.models.channel_flow import ChannelFlowParameters as TParams
    from orc_tpu_torch.models.channel_flow import couette_case as t_couette

    path = str(tmp_path / "channel.msh")
    write_tgrid(path, 16, 8, 1, lengths=(0.002, 0.001, 0.0001))
    kw = dict(top_wall_velocity=5e-4, dp_dx=10.0)
    mj, tj = j_couette(params=JParams(**kw), mesh_path=path)
    mt, tt = t_couette(params=TParams(**kw), mesh_path=path, device="cpu")
    assert mt.neighbor_offsets == mj.neighbor_offsets
    settings = tset.NumericalSettings(
        matrix_solver=tset.MatrixSolverSettings(
            solver_type=tset.SolutionMethod.BICGSTAB, iterations=50,
            preconditioner=tset.PreconditionMethod.JACOBI,
        )
    )
    run = dict(iterations=20, reporting_interval=20, verbose=False)
    sj, hj = js.solve_steady(mj, tj, to_jax_settings(settings), 1000.0, 0.001, **run)
    st, ht = ts.solve_steady(mt, tt, settings, 1000.0, 0.001, **run)
    _assert_tracks((sj, js.stack_history(hj)), (st, ts.stack_history(ht)))


def test_native_reader_is_not_ported(tmp_path):
    """The native reader is ported now (mesh/native.py): read_mesh with
    native=True compiles the same mesh as the Python parser's
    (tests/test_torch_native.py holds the parsers against each other)."""
    from orc_tpu_torch.mesh.generate import write_tgrid
    from orc_tpu_torch.mesh.tgrid import read_mesh

    path = str(tmp_path / "box.msh")
    write_tgrid(path, 3, 3, 1)
    mn, _ = read_mesh(path, native=True, device="cpu")
    mp, _ = read_mesh(path, native=False, device="cpu")
    assert torch.equal(mn.cell_centroid, mp.cell_centroid)
    assert torch.equal(mn.cell_neighbors, mp.cell_neighbors)
