"""Structured geometric multigrid of the port (orc_tpu_torch/solver/gmg.py,
solver/amg.py's smoother, krylov's MULTIGRID branch) against orc_tpu on
CPU, float64.

- the level hierarchy equals orc_tpu's, every GmgLevel field, on the
  even, odd, 3-D and periodic boxes of tests/test_gmg.py;
- restrict, prolong and galerkin agree with orc_tpu's at 1e-14 of
  scale on the same matrix, galerkin equals the dense R A P, and R and
  P are transposes;
- the V-cycle reaches a known solution (rtol 1e-6, tests/test_gmg.py)
  and one cycle equals orc_tpu's at rtol 1e-10;
- solve_steady under MULTIGRID on the 16^2 cavity tracks orc_tpu for 20
  iterations (every StepMetrics field at rtol 1e-6, equal inner
  iteration counts);
- a fully periodic box (SIMPLE_FC, no pressure zone: a singular
  pressure system) tracks orc_tpu with the deflation reaching the
  coarse levels;
- the body-force periodic Poiseuille channel under MULTIGRID matches
  the parabola to 5e-3 (tests/test_gmg.py::test_gmg_periodic_poiseuille);
- MULTIGRID on an irregular mesh raises NotImplementedError (the
  algebraic hierarchy is not ported).
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import np_, permuted_arrays, to_jax_settings

import jax.numpy as jnp
from orc_tpu.mesh.generate import structured_box_mesh as jbox
from orc_tpu.ops.assembly import diffusion_system
from orc_tpu.ops.fields import device_bc, face_bc
from orc_tpu.ops.spmv import EllMatrix as JEll
from orc_tpu.solver import gmg as jg
from orc_tpu.solver import simple as js

from orc_tpu_torch.mesh.generate import structured_box_mesh as tbox
from orc_tpu_torch.mesh.zones import FaceCondition as TFC
from orc_tpu_torch.ops.spmv import EllMatrix as TEll
from orc_tpu_torch.solver import amg as tamg
from orc_tpu_torch.solver import gmg as tg
from orc_tpu_torch.solver import simple as ts
from orc_tpu_torch.utils import settings as tset

MG = tset.MatrixSolverSettings(
    solver_type=tset.SolutionMethod.MULTIGRID,
    iterations=30,
    multigrid_levels=4,
    multigrid_smoother_iterations=4,
    relative_convergence_threshold=1e-10,
    preconditioner=tset.PreconditionMethod.NONE,
)
BOXES = [(16, 12, 1, ()), (15, 9, 1, ()), (8, 6, 4, ()), (12, 8, 1, ("x",))]


def _matrix(nx, ny, nz, per, shift=0.1):
    """orc_tpu's diffusion matrix of a box (+ shift on the diagonal) as
    (jax EllMatrix, port EllMatrix on the CPU, jax mesh), from the same
    numbers."""
    mesh, table = jbox(nx, ny, nz, periodic=per)
    zc, zs, zv = device_bc(table, mesh.dtype)
    d = diffusion_system(mesh, face_bc(mesh, zc, zs, zv), jnp.asarray(1.0, mesh.dtype))
    A = JEll(
        diag=d.diag + shift, off=d.off, neighbors=mesh.cell_neighbors,
        offsets=mesh.neighbor_offsets,
    )
    At = TEll(
        diag=torch.tensor(np.asarray(A.diag)), off=torch.tensor(np.asarray(A.off)),
        neighbors=None, offsets=mesh.neighbor_offsets,
    )
    return A, At, mesh


def _dense(A, C):
    Ad = np.zeros((C, C))
    Ad[np.arange(C), np.arange(C)] = np.asarray(A.diag)
    nb, off = np.asarray(A.neighbors), np.asarray(A.off)
    for k in range(nb.shape[1]):
        np.add.at(Ad, (np.arange(C), nb[:, k]), off[:, k])
    return Ad


def _hierarchies(nx, ny, nz, per):
    jm, _ = jbox(nx, ny, nz, periodic=per)
    tm, _ = tbox(nx, ny, nz, periodic=per, device="cpu")
    assert tm.neighbor_offsets == jm.neighbor_offsets
    jdims = jg.infer_box_dims(jm.neighbor_offsets, jm.n_cells)
    tdims = tg.infer_box_dims(tm.neighbor_offsets, tm.n_cells)
    assert tdims == jdims
    return (
        jg.build_gmg_hierarchy(jdims, jm.neighbor_offsets, to_jax_settings(MG)),
        tg.build_gmg_hierarchy(tdims, tm.neighbor_offsets, MG),
    )


@pytest.mark.parametrize("nx,ny,nz,per", BOXES)
def test_levels_equal_orc_tpu(nx, ny, nz, per):
    hj, ht = _hierarchies(nx, ny, nz, per)
    assert ht and len(ht) == len(hj)
    for lj, lt in zip(hj, ht):
        for f in dataclasses.fields(tg.GmgLevel):
            assert getattr(lt, f.name) == getattr(lj, f.name), f.name
        assert lt.n_coarse == lj.n_coarse


@pytest.mark.parametrize("nx,ny,nz,per", BOXES)
def test_transfers_and_galerkin_match(nx, ny, nz, per):
    A, At, mesh = _matrix(nx, ny, nz, per)
    hj, ht = _hierarchies(nx, ny, nz, per)
    lj, lt = hj[0], ht[0]
    C, nC = mesh.n_cells, lt.n_coarse
    rng = np.random.default_rng(0)
    r = rng.standard_normal((3, C))
    e = rng.standard_normal((3, nC))
    for b in range(3):  # one vector at a time, as orc_tpu's test
        np.testing.assert_allclose(
            np_(tg.restrict(torch.tensor(r[b]), lt)),
            np.asarray(jg.restrict(jnp.asarray(r[b]), lj)), rtol=1e-14, atol=1e-14,
        )
        np.testing.assert_allclose(
            np_(tg.prolong(torch.tensor(e[b]), lt)),
            np.asarray(jg.prolong(jnp.asarray(e[b]), lj)), rtol=0, atol=0,
        )
    # Batched vectors ([3, C], the momentum systems) row by row.
    np.testing.assert_allclose(
        np_(tg.restrict(torch.tensor(r), lt)),
        np.stack([np_(tg.restrict(torch.tensor(x), lt)) for x in r]), rtol=0, atol=0,
    )
    # <R r, e> == <r, P e>.
    lhs = float(torch.dot(tg.restrict(torch.tensor(r[0]), lt), torch.tensor(e[0])))
    rhs = float(torch.dot(torch.tensor(r[0]), tg.prolong(torch.tensor(e[0]), lt)))
    assert abs(lhs - rhs) < 1e-10 * max(abs(lhs), 1.0)
    # Galerkin against orc_tpu's and against the dense R A P.
    Acj, Act = jg.galerkin(A, lj), tg.galerkin(At, lt)
    assert Act.offsets == Acj.offsets
    scale = float(np.abs(np.asarray(Acj.off)).max())
    np.testing.assert_allclose(np_(Act.diag), np.asarray(Acj.diag), rtol=1e-14, atol=1e-14 * scale)
    np.testing.assert_allclose(np_(Act.off), np.asarray(Acj.off), rtol=1e-14, atol=1e-14 * scale)
    P = np.stack([np_(tg.prolong(torch.tensor(row), lt)) for row in np.eye(nC)])
    Ac_dense = P @ _dense(A, C) @ P.T
    empty = np.abs(Ac_dense).sum(1) == 0
    Ac_dense[empty, empty] = 1.0  # identity rows for all-padding blocks
    Acd = np.zeros((nC, nC))
    Acd[np.arange(nC), np.arange(nC)] = np_(Act.diag)
    for j, d in enumerate(lt.coarse_offsets):
        np.add.at(Acd, (np.arange(nC), (np.arange(nC) + d) % nC), np_(Act.off[:, j]))
    np.testing.assert_allclose(Acd, Ac_dense, atol=1e-12)


def test_vcycle_known_solution_and_orc_tpu_cycle():
    A, At, mesh = _matrix(16, 12, 1, ())
    hj, ht = _hierarchies(16, 12, 1, ())
    C = mesh.n_cells
    rng = np.random.default_rng(1)
    xs = rng.standard_normal(C)
    b = _dense(A, C) @ xs
    xj, _ = jg.gmg_solve(A, jnp.asarray(b), jnp.zeros(C), to_jax_settings(MG), hj)
    x = torch.zeros(C, dtype=torch.float64)
    for i in range(8):
        x, info = tg.gmg_solve(At, torch.tensor(b), x, MG, ht)
        if i == 0:
            np.testing.assert_allclose(np_(x), np.asarray(xj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np_(x), xs, rtol=1e-6, atol=1e-8)
    assert not bool(info.diverged)


def test_iterative_solve_multigrid_is_the_vcycle():
    """krylov.iterative_solve under MULTIGRID runs gmg_solve with the
    Jacobi-preconditioned matrix, as orc_tpu does; without a hierarchy
    it refuses."""
    from orc_tpu_torch.solver.krylov import iterative_solve

    _, At, mesh = _matrix(16, 12, 1, ())
    _, ht = _hierarchies(16, 12, 1, ())
    b = torch.tensor(np.random.default_rng(2).standard_normal(mesh.n_cells))
    x0 = torch.zeros_like(b)
    x, _ = iterative_solve(At, b, x0, MG, mg_hierarchy=ht)
    y, _ = tg.gmg_solve(At, b, x0, MG, ht)
    assert torch.equal(x, y)
    with pytest.raises(ValueError):
        iterative_solve(At, b, x0, MG)


#: tests/test_gmg.py::test_simple_with_gmg_matches_bicgstab's MULTIGRID
#: configuration.
CAVITY_MG = tset.NumericalSettings(
    momentum=tset.MomentumScheme.UD,
    pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED,
    velocity_interpolation=tset.VelocityInterpolation.LINEAR_WEIGHTED,
    relaxation_mode=tset.RelaxationMode.IMPLICIT,
    momentum_relaxation=0.7,
    pressure_relaxation=0.1,
    matrix_solver=tset.MatrixSolverSettings(
        solver_type=tset.SolutionMethod.MULTIGRID,
        iterations=40,
        multigrid_levels=3,
        multigrid_smoother_iterations=5,
        preconditioner=tset.PreconditionMethod.JACOBI,
    ),
)


def _assert_tracks(hj, ht, sj, st, fields=("vel", "p"), metrics=None):
    """The StepMetrics fields `metrics` (default all) at rtol 1e-6
    (absolute floor 1e-12 of the field's largest value), inner iteration
    counts equal, the end fields to 1e-8 of scale."""
    for f in metrics or hj._fields:
        a, b = np.asarray(getattr(hj, f)), getattr(ht, f)
        assert a.shape == b.shape, f
        if f in ("mom_iters", "pc_iters", "diverged"):
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            d = a.astype(np.float64)
            np.testing.assert_allclose(
                b, d, rtol=1e-6, atol=1e-12 * float(np.max(np.abs(d))), err_msg=f
            )
    for name in fields:
        d = np.asarray(getattr(sj, name))
        np.testing.assert_allclose(
            np_(getattr(st, name)), d, rtol=1e-8, atol=1e-8 * np.abs(d).max(),
            err_msg=name,
        )


def test_cavity_multigrid_tracks_orc_tpu():
    from orc_tpu.models.cavity import cavity_case as jcav

    from orc_tpu_torch.models.cavity import cavity_case as tcav

    kw = dict(iterations=20, reporting_interval=20, verbose=False)
    mj, tj = jcav(n=16)
    sj, hj = js.solve_steady(mj, tj, to_jax_settings(CAVITY_MG), 1.0, 0.01, **kw)
    mt, tt = tcav(n=16, device="cpu")
    st, ht = ts.solve_steady(mt, tt, CAVITY_MG, 1.0, 0.01, **kw)
    _assert_tracks(js.stack_history(hj), ts.stack_history(ht), sj, st)
    assert not ts.stack_history(ht).diverged.any()


def test_periodic_box_deflates_coarse_levels(monkeypatch):
    """A fully periodic 16^2 box (the Taylor-Green vortex, 3 implicit
    time steps x 4 SIMPLE_FC iterations: no pressure zone, so the
    pressure system is singular) under MULTIGRID: the coarse levels get
    the plain-mean deflation, and the run tracks orc_tpu. (Marched in
    time: orc_tpu's steady loop diverges on this box.)"""
    from orc_tpu.solver import transient as jt

    from orc_tpu_torch.solver import transient as tt

    settings = CAVITY_MG.replace(
        momentum=tset.MomentumScheme.CD1,
        velocity_interpolation=tset.VelocityInterpolation.RHIE_CHOW,
        pressure_relaxation=0.3,
    )
    assert settings.resolved_coupling() == tset.PressureVelocityCoupling.SIMPLE_FC
    L = 2 * np.pi
    mj, tj = jbox(16, 16, 1, lengths=(L, L, 1.0), periodic=("x", "y"))
    mt, ttab = tbox(16, 16, 1, lengths=(L, L, 1.0), periodic=("x", "y"), device="cpu")
    cc = np.asarray(mj.cell_centroid)
    vel = np.stack([np.sin(cc[:, 0]) * np.cos(cc[:, 1]),
                    -np.cos(cc[:, 0]) * np.sin(cc[:, 1]), 0 * cc[:, 0]], -1)
    scales = []
    real = tg._coarse_project

    def spy(null_scale):
        scales.append(null_scale)
        return real(null_scale)

    monkeypatch.setattr(tg, "_coarse_project", spy)
    kw = dict(dt=0.05, n_steps=3, inner_iterations=4, verbose=False)
    sj, hj = jt.solve_transient(
        mj, tj, to_jax_settings(settings), 1.0, 0.02,
        state=js.initial_state(mj, vel=jnp.asarray(vel)), **kw,
    )
    st, ht = tt.solve_transient(
        mt, ttab, settings, 1.0, 0.02, state=ts.initial_state(mt, vel=vel), **kw
    )
    assert scales and all(s is not None and float(s) == 1.0 for s in scales)
    ht = ts.StepMetrics(**{f: np_(getattr(ht, f)) for f in ts._metric_names()})
    # The vortex's mean velocity, its Peclet estimates (sums of face
    # flows of a divergence-free field) and the pressure residual (the
    # floor of a singular system whose RHS is consistent to roundoff)
    # are cancellation noise here.
    _assert_tracks(
        hj, ht, sj, st, fields=("vel", "p", "flux"),
        metrics=("p_corr_norm", "vel_corr_norm", "mom_residual", "diverged",
                 "mom_iters", "pc_iters"),
    )


def test_gmg_periodic_poiseuille():
    """tests/test_gmg.py::test_gmg_periodic_poiseuille in the port: the
    body-force-driven x-periodic channel under MULTIGRID (wrap offsets at
    every level) matches plane Poiseuille to 5e-3."""
    nx, ny, H, G = 8, 16, 1.0, 1.0
    mesh, table = tbox(nx, ny, 1, lengths=(2.0, H, 0.1), periodic=("x",), device="cpu")
    for z in ("BOTTOM_WALL", "TOP_WALL"):
        table.set(z, TFC.WALL)
    for z in ("PERIODIC_-Z", "PERIODIC_+Z"):
        table.set(z, TFC.SYMMETRY)
    vol = float(mesh.cell_volume[0])

    def source(cc):
        s = torch.zeros_like(cc)
        s[:, 0] = G * vol
        return s

    settings = tset.NumericalSettings(
        momentum=tset.MomentumScheme.UD,
        pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=tset.VelocityInterpolation.RHIE_CHOW,
        momentum_source=source,
        matrix_solver=tset.MatrixSolverSettings(
            solver_type=tset.SolutionMethod.MULTIGRID,
            iterations=30,
            multigrid_levels=3,
            multigrid_smoother_iterations=5,
            preconditioner=tset.PreconditionMethod.JACOBI,
        ),
    )
    assert ts._mg_hierarchy(mesh, settings)
    state, _ = ts.solve_steady(
        mesh, table, settings, 1.0, 0.1, iterations=400, reporting_interval=200,
        verbose=False,
    )
    u = np_(state.vel)[:, 0].reshape(ny, nx)
    y = (np.arange(ny) + 0.5) * (H / ny)
    u_exact = G / (2 * 0.1) * y * (H - y)
    err = np.abs(u.mean(axis=1) - u_exact).max() / u_exact.max()
    assert err < 5e-3, err


def test_multigrid_on_irregular_mesh_raises():
    from orc_tpu_torch.mesh.compile import compile_from_arrays
    from orc_tpu_torch.models.cavity import cavity_case

    kw, _perm = permuted_arrays(8, seed=1)
    mesh = compile_from_arrays(**kw, dtype=torch.float64, device="cpu")
    table = cavity_case(n=4, device="cpu")[1]
    assert mesh.neighbor_offsets is None
    with pytest.raises(NotImplementedError, match="Queue 1, item 8"):
        ts.solve_steady(mesh, table, CAVITY_MG, 1.0, 0.01, iterations=1, verbose=False)
    with pytest.raises(NotImplementedError, match="Queue 1, item 8"):
        tg.build_mg_hierarchy(mesh, CAVITY_MG)


def test_smoother_is_jacobi_preconditioned_bicgstab():
    """amg._smooth runs multigrid_smoother_iterations of BiCGSTAB on
    D^-1 A (settings.iterations when unset)."""
    _, At, mesh = _matrix(8, 6, 1, ())
    b = torch.tensor(np.random.default_rng(3).standard_normal(mesh.n_cells))
    x0 = torch.zeros_like(b)
    _, info = tamg._smooth(At, b, x0, MG)
    assert int(info.iterations) == MG.multigrid_smoother_iterations
    _, info = tamg._smooth(At, b, x0, dataclasses.replace(MG, multigrid_smoother_iterations=None))
    assert 4 < int(info.iterations) <= MG.iterations
