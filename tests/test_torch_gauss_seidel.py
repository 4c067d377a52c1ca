"""Multi-colour Gauss-Seidel of the port (orc_tpu_torch/solver/coloring.py,
krylov.gauss_seidel_solve, iterative_solve's GAUSS_SEIDEL branch)
against orc_tpu on the CPU, float64.

- greedy_coloring equals orc_tpu's on the meshes of torch_parity (boxes
  2-D and 3-D, channels, the permuted and graded meshes), and is a
  colouring: no face joins two cells of one colour.
- gauss_seidel_solve and iterative_solve(GAUSS_SEIDEL) within 1e-10 of
  orc_tpu: the known solution of tests/test_solvers.py:62-87 (even/odd
  colours, Jacobi and no preconditioner), a structured system, single
  and batched [3,C], with the constant-mode projection.
- solve_steady under GAUSS_SEIDEL on the 12^2 cavity, structured and
  permuted, tracks orc_tpu for 10 iterations (every StepMetrics field
  at rtol 1e-6, equal inner counts).
"""

import numpy as np
import pytest
import torch

from torch_parity import (
    CASES,
    IRREGULAR_CASES,
    _cavity_table,
    both,
    compiled_both,
    np_,
    permuted_arrays,
    structured_system,
    to_jax_settings,
)

import jax
import jax.numpy as jnp
from orc_tpu.models.cavity import cavity_case as jcav
from orc_tpu.ops.spmv import EllMatrix as JEll
from orc_tpu.solver import krylov as jk
from orc_tpu.solver import simple as js
from orc_tpu.solver.coloring import greedy_coloring as jcolor

from orc_tpu_torch.models.cavity import cavity_case as tcav
from orc_tpu_torch.ops.spmv import EllMatrix as TEll
from orc_tpu_torch.solver import krylov as tk
from orc_tpu_torch.solver import simple as ts
from orc_tpu_torch.solver.coloring import greedy_coloring as tcolor
from orc_tpu_torch.utils import settings as tset

from test_solvers import N, TOL, reference_test_system
from test_torch_gmg import _assert_tracks

ALL_CASES = sorted(CASES) + sorted(IRREGULAR_CASES)
OFFSETS = (-24, -1, 1, 24)
C = 24 * 20


@pytest.mark.parametrize("case", ALL_CASES)
def test_greedy_coloring_equals_orc_tpu(case):
    (mj, _), (mt, _) = both(case)
    cj, nj = jcolor(mj)
    ct, nt = tcolor(mt)
    assert nt == nj and ct.dtype == torch.int32
    np.testing.assert_array_equal(np_(ct), np.asarray(cj))
    nbrs = np_(mt.cell_neighbors)
    col = np_(ct)
    face = np_(mt.cell_face_mask) & (nbrs != np.arange(len(col))[:, None])
    assert not (col[nbrs] == col[:, None])[face].any()


def _reference_pair():
    A, b, x_true = reference_test_system()
    At = TEll(
        diag=torch.tensor(np.asarray(A.diag)), off=torch.tensor(np.asarray(A.off)),
        neighbors=torch.tensor(np.asarray(A.neighbors), dtype=torch.int32),
    )
    return A, At, b, x_true


@pytest.mark.parametrize("precond", ["JACOBI", "NONE"])
def test_reference_known_solution(precond):
    """tests/test_solvers.py::test_reference_known_solution[GAUSS_SEIDEL]
    in the port, held to orc_tpu at 1e-10."""
    A, At, b, x_true = _reference_pair()
    settings = tset.MatrixSolverSettings(
        solver_type=tset.SolutionMethod.GAUSS_SEIDEL, iterations=50,
        relaxation=0.5, relative_convergence_threshold=TOL / N**3,
        preconditioner=tset.PreconditionMethod[precond],
    )
    colors = np.arange(N) % 2
    xj, ij = jk.iterative_solve(
        A, b, jnp.zeros(N), to_jax_settings(settings),
        colors=jnp.asarray(colors), n_colors=2,
    )
    xt, it = tk.iterative_solve(
        At, torch.tensor(np.asarray(b)), torch.zeros(N, dtype=torch.float64),
        settings, colors=torch.tensor(colors, dtype=torch.int32), n_colors=2,
    )
    r = np_(At.matvec(xt)) - np.asarray(b)
    assert np.linalg.norm(r) < TOL
    np.testing.assert_allclose(np_(xt), np.asarray(xj), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np_(it.residual), np.asarray(ij.residual), rtol=1e-8)
    assert int(it.iterations) == int(ij.iterations) == 50
    assert not bool(it.diverged)


@pytest.mark.parametrize(
    "batched,project", [(False, False), (True, False), (False, True)],
    ids=["single", "batched", "deflated"],  # deflation takes 1-D vectors
)
def test_gauss_seidel_solve_matches(batched, project):
    diag, off, b, x0 = structured_system(C, OFFSETS, B=3 if batched else 0, seed=4)
    colors = (np.arange(C) + np.arange(C) // 24) % 2  # a checkerboard
    Aj = JEll(diag=jnp.asarray(diag), off=jnp.asarray(off), neighbors=None, offsets=OFFSETS)
    At = TEll(diag=torch.tensor(diag), off=torch.tensor(off), neighbors=None, offsets=OFFSETS)
    kw_j, kw_t = {}, {}
    if project:
        kw_j = dict(project=jk.constant_deflation(jnp.asarray(1.0)))
        kw_t = dict(project=tk.constant_deflation(torch.tensor(1.0, dtype=torch.float64)))

    def jsolve(bb, xx):
        return jk.gauss_seidel_solve(Aj, bb, xx, 20, 0.9, jnp.asarray(colors), 2, **kw_j)

    jres = jax.vmap(jsolve)(jnp.asarray(b), jnp.asarray(x0)) if batched else jsolve(jnp.asarray(b), jnp.asarray(x0))
    xt, it = tk.gauss_seidel_solve(
        At, torch.tensor(b), torch.tensor(x0), 20, 0.9,
        torch.tensor(colors, dtype=torch.int32), 2, **kw_t,
    )
    xj, ij = jres
    np.testing.assert_allclose(np_(xt), np.asarray(xj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np_(it.residual), np.asarray(ij.residual), rtol=1e-8)
    assert np_(it.iterations).shape == np.asarray(ij.iterations).shape
    assert (np_(it.iterations) == 20).all()


@pytest.mark.parametrize("mesh", ["box", "permuted"])
def test_cavity_gauss_seidel_tracks_orc_tpu(mesh):
    """The 12^2 cavity's SIMPLE with the pressure solved by GAUSS_SEIDEL
    (the greedy colouring; on the permuted mesh the slice SpMV per
    colour)."""
    settings = tset.NumericalSettings(
        momentum=tset.MomentumScheme.UD,
        pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=tset.VelocityInterpolation.LINEAR_WEIGHTED,
        relaxation_mode=tset.RelaxationMode.IMPLICIT,
        momentum_relaxation=0.7,
        pressure_relaxation=0.1,
        matrix_solver=tset.MatrixSolverSettings(
            solver_type=tset.SolutionMethod.GAUSS_SEIDEL, iterations=20,
            relaxation=0.9, preconditioner=tset.PreconditionMethod.JACOBI,
        ),
    )
    if mesh == "box":
        (mj, tj), (mt, tt) = jcav(n=12), tcav(n=12, device="cpu")
    else:
        mj, mt = compiled_both(permuted_arrays(12, seed=1)[0])
        tj, tt = _cavity_table("jax"), _cavity_table("torch")
    run = dict(iterations=10, reporting_interval=10, verbose=False)
    sj, hj = js.solve_steady(mj, tj, to_jax_settings(settings), 1.0, 0.01, **run)
    st, ht = ts.solve_steady(mt, tt, settings, 1.0, 0.01, **run)
    _assert_tracks(js.stack_history(hj), ts.stack_history(ht), sj, st)
