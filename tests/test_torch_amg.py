"""Algebraic multigrid of the port (orc_tpu_torch/solver/amg.py) against
orc_tpu's solver/amg.py on the CPU, float64.

- The hierarchy equals orc_tpu's as integers (agg, diag_target,
  off_target, coarse_neighbors, n_coarse, k_coarse) under both
  restrictions, on tests/test_solvers.py's reference system, a 12^2 box
  and the permuted 12^2 cavity; each coarse level's slice plan equals
  orc_tpu's, built without the neighbour gather's table.
- galerkin_values within 1e-12 of orc_tpu's and of the dense R A R^T
  (tests/test_solvers.py:172-193), one matrix or one per batch row.
- multigrid_solve reaches the known solution of tests/test_solvers.py
  (both restrictions, the tuned smoother), equal to orc_tpu's to 1e-10
  with equal iteration counts; a batched [3,C] solve over one matrix
  equals three single ones; a matrix whose plans are degenerate takes
  the gather form on every level.
- solve_steady under MULTIGRID on the permuted 12^2 cavity tracks
  orc_tpu for 20 iterations (every StepMetrics field at rtol 1e-6,
  equal inner counts).
- The restriction and Galerkin sums give the same bits at 1 and 4
  threads.
- The signatures of this slice's functions (AMG, Gauss-Seidel,
  build_mg_hierarchy, initialisation, recovery, solve_channel_flow) are
  orc_tpu's but for its sharded hooks; MgLevel has orc_tpu's fields.
"""

import numpy as np
import pytest
import torch

from torch_parity import _cavity_table, compiled_both, np_, permuted_arrays, to_jax_settings

import jax.numpy as jnp
from orc_tpu.mesh.generate import structured_box_mesh as jbox
from orc_tpu.ops.assembly import diffusion_system as jdiff
from orc_tpu.ops.fields import device_bc as jbc, face_bc as jfbc
from orc_tpu.ops.spmv import EllMatrix as JEll
from orc_tpu.solver import amg as jamg
from orc_tpu.solver import krylov as jk
from orc_tpu.solver import simple as js

from orc_tpu_torch.ops.spmv import EllMatrix as TEll
from orc_tpu_torch.solver import amg as tamg
from orc_tpu_torch.solver import krylov as tk
from orc_tpu_torch.solver import simple as ts
from orc_tpu_torch.utils import settings as tset

from test_solvers import N, TOL, reference_test_system
from test_torch_gmg import CAVITY_MG, _assert_tracks

RESTRICTIONS = ["strongest", "injection"]


def _diffusion(mesh, table):
    zc, zs, zv = jbc(table, mesh.dtype)
    d = jdiff(mesh, jfbc(mesh, zc, zs, zv), jnp.asarray(0.01, mesh.dtype))
    return np.asarray(d.diag), np.asarray(d.off), np.asarray(mesh.cell_neighbors)


def _box():
    return _diffusion(*jbox(12, 12, 1))


def _permuted():
    mj, _ = compiled_both(permuted_arrays(12, seed=1)[0])
    return _diffusion(mj, _cavity_table("jax"))


def _reference():
    A, _, _ = reference_test_system()
    return np.asarray(A.diag), np.asarray(A.off), np.asarray(A.neighbors)


SYSTEMS = {"reference": _reference, "box12": _box, "permuted12": _permuted}


def _settings(restriction="strongest", **kw):
    return tset.MatrixSolverSettings(
        solver_type=tset.SolutionMethod.MULTIGRID,
        multigrid_restriction=tset.RestrictionMethod(restriction),
        **kw,
    )


def _hierarchies(diag, off, nbrs, settings):
    hj = jamg.build_hierarchy_from_matrix(diag, off, nbrs, to_jax_settings(settings))
    ht = tamg.build_hierarchy_from_matrix(diag, off, nbrs, settings, device="cpu")
    return hj, ht


def _pair(diag, off, nbrs, plan=None):
    return (
        JEll(diag=jnp.asarray(diag), off=jnp.asarray(off),
             neighbors=jnp.asarray(nbrs, jnp.int32)),
        TEll(diag=torch.tensor(diag), off=torch.tensor(off),
             neighbors=torch.tensor(nbrs, dtype=torch.int32), plan=plan),
    )


@pytest.mark.parametrize("restriction", RESTRICTIONS)
@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_hierarchy_equals_orc_tpu(system, restriction):
    diag, off, nbrs = SYSTEMS[system]()
    hj, ht = _hierarchies(diag, off, nbrs, _settings(restriction))
    assert len(ht) == len(hj) >= 2
    for lj, lt in zip(hj, ht):
        for f in ("agg", "diag_target", "off_target", "coarse_neighbors"):
            np.testing.assert_array_equal(np_(getattr(lt, f)), np.asarray(getattr(lj, f)), err_msg=f)
            assert getattr(lt, f).dtype == torch.int32
        assert (lt.n_coarse, lt.k_coarse) == (lj.n_coarse, lj.k_coarse)
        assert (lt.plan is None) == (lj.plan is None)
        if lt.plan is not None:
            assert lt.plan.col_tile is None  # nothing gathers on a coarse level
            for f in ("starts", "col_of", "tile_nj"):
                np.testing.assert_array_equal(np_(getattr(lt.plan, f)), np.asarray(getattr(lj.plan, f)))
            assert (lt.plan.tile, lt.plan.n_max) == (lj.plan.tile, lj.plan.n_max)


def _coarse_dense(agg, n_c, M):
    R = np.zeros((n_c, M.shape[0]))
    R[agg, np.arange(M.shape[0])] = 1.0
    return R @ M @ R.T


def _dense_ell(diag, off, nbrs):
    M = np.diag(np.asarray(diag, dtype=np.float64))
    for i in range(len(diag)):
        for k in range(nbrs.shape[1]):
            M[i, nbrs[i, k]] += off[i, k]
    return M


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_galerkin_values_match_orc_tpu_and_dense(system):
    """On each level in turn, from seeded values over the level's
    sparsity: orc_tpu's segment sums and R A R^T."""
    diag, off, nbrs = SYSTEMS[system]()
    hj, ht = _hierarchies(diag, off, nbrs, _settings())
    rng = np.random.default_rng(7)
    d = diag + rng.uniform(0.1, 1.0, diag.shape)
    o = off * rng.uniform(0.5, 1.5, off.shape)
    for lj, lt in zip(hj, ht):
        Aj, At = _pair(d, o, nbrs)
        Gj, Gt = jamg.galerkin_values(Aj, lj), tamg.galerkin_values(At, lt)
        for f in ("diag", "off"):
            a = np.asarray(getattr(Gj, f))
            np.testing.assert_allclose(np_(getattr(Gt, f)), a, rtol=1e-12, atol=1e-12 * np.abs(a).max())
        M_c = _coarse_dense(np.asarray(lj.agg), lj.n_coarse, _dense_ell(d, o, nbrs))
        cn = np_(Gt.neighbors)
        np.testing.assert_allclose(
            _dense_ell(np_(Gt.diag), np_(Gt.off), cn), M_c, rtol=1e-12,
            atol=1e-12 * np.abs(M_c).max(),
        )
        d, o, nbrs = np_(Gt.diag), np_(Gt.off), cn


def test_galerkin_values_one_matrix_per_batch_row():
    diag, off, nbrs = _permuted()
    _, ht = _hierarchies(diag, off, nbrs, _settings())
    scale = np.array([1.0, 2.0, 0.5])
    A3 = TEll(
        diag=torch.tensor(diag[None] * scale[:, None]),
        off=torch.tensor(off[None] * scale[:, None, None]),
        neighbors=torch.tensor(nbrs, dtype=torch.int32),
    )
    G3 = tamg.galerkin_values(A3, ht[0])
    for i, s in enumerate(scale):
        G = tamg.galerkin_values(
            TEll(diag=torch.tensor(diag * s), off=torch.tensor(off * s), neighbors=None),
            ht[0],
        )
        assert torch.equal(G3.diag[i], G.diag) and torch.equal(G3.off[i], G.off)


def _known_solution(settings):
    A, b, x_true = reference_test_system()
    diag, off, nbrs = _reference()
    hj, ht = _hierarchies(diag, off, nbrs, settings)
    _, At = _pair(diag, off, nbrs)
    xj, ij = jk.iterative_solve(A, b, jnp.zeros(N), to_jax_settings(settings), mg_hierarchy=hj)
    xt, it = tk.iterative_solve(
        At, torch.tensor(np.asarray(b)), torch.zeros(N, dtype=torch.float64),
        settings, mg_hierarchy=ht,
    )
    r = np_(At.matvec(xt)) - np.asarray(b)
    assert np.linalg.norm(r) < TOL
    np.testing.assert_allclose(np_(xt), x_true, atol=5e-2)
    np.testing.assert_allclose(np_(xt), np.asarray(xj), rtol=1e-10, atol=1e-10 * np.abs(x_true).max())
    assert int(it.iterations) == int(ij.iterations)
    assert not bool(it.diverged)


@pytest.mark.parametrize("restriction", RESTRICTIONS)
def test_multigrid_known_solution(restriction):
    """tests/test_solvers.py::test_multigrid_known_solution in the port."""
    _known_solution(_settings(
        restriction, iterations=50, relaxation=0.5,
        relative_convergence_threshold=TOL / N**3,
        preconditioner=tset.PreconditionMethod.JACOBI,
    ))


def test_multigrid_tuned_smoother():
    """tests/test_solvers.py::test_multigrid_tuned_smoother in the port."""
    _known_solution(_settings(
        iterations=50, relative_convergence_threshold=TOL / N**3,
        preconditioner=tset.PreconditionMethod.JACOBI,
        multigrid_smoother_iterations=5,
    ))


def test_batched_multigrid_equals_single_solves():
    """b [3,C] over one matrix (the momentum solve's form) equals three
    single solves."""
    diag, off, nbrs = _permuted()
    settings = _settings(iterations=20, multigrid_smoother_iterations=4)
    _, ht = _hierarchies(diag, off, nbrs, settings)
    _, At = _pair(diag + 0.1, off, nbrs)
    b = torch.tensor(np.random.default_rng(1).standard_normal((3, len(diag))))
    x3, i3 = tamg.multigrid_solve(At, b, torch.zeros_like(b), settings, ht)
    for i in range(3):
        x, info = tamg.multigrid_solve(At, b[i], torch.zeros_like(b[i]), settings, ht)
        np.testing.assert_allclose(np_(x3[i]), np_(x), rtol=1e-12, atol=1e-14)
        assert int(i3.iterations[i]) == int(info.iterations)


def test_degenerate_plans_take_the_gather_form():
    """A random sparse graph, too wide for a slice plan on any level:
    every level's plan is None, its SpMV gathers, and the solve equals
    orc_tpu's."""
    rng = np.random.default_rng(3)
    C, K = 600, 4
    nbrs = np.tile(np.arange(C)[:, None], (1, K))
    off = np.zeros((C, K))
    for i in range(C):
        for k, j in enumerate(rng.choice(C, K, replace=False)):
            if j != i:
                nbrs[i, k], off[i, k] = j, -rng.uniform(0.1, 1.0)
    diag = 1.0 + np.abs(off).sum(axis=1)
    settings = _settings(iterations=30, multigrid_smoother_iterations=4,
                         preconditioner=tset.PreconditionMethod.JACOBI)
    hj, ht = _hierarchies(diag, off, nbrs, settings)
    assert all(l.plan is None for l in ht) and all(l.plan is None for l in hj)
    Aj, At = _pair(diag, off, nbrs)
    b = rng.standard_normal(C)
    xj, ij = jk.iterative_solve(Aj, jnp.asarray(b), jnp.zeros(C), to_jax_settings(settings), mg_hierarchy=hj)
    xt, it = tk.iterative_solve(At, torch.tensor(b), torch.zeros(C, dtype=torch.float64), settings, mg_hierarchy=ht)
    np.testing.assert_allclose(np_(xt), np.asarray(xj), rtol=1e-10, atol=1e-12)
    assert int(it.iterations) == int(ij.iterations)


def test_permuted_cavity_multigrid_tracks_orc_tpu():
    """The permuted 12^2 cavity (RCM order, slice plan) under MULTIGRID:
    the AMG hierarchy on the pressure system, 20 iterations."""
    mj, mt = compiled_both(permuted_arrays(12, seed=1)[0])
    run = dict(iterations=20, reporting_interval=20, verbose=False)
    sj, hj = js.solve_steady(mj, _cavity_table("jax"), to_jax_settings(CAVITY_MG), 1.0, 0.01, **run)
    st, ht = ts.solve_steady(mt, _cavity_table("torch"), CAVITY_MG, 1.0, 0.01, **run)
    _assert_tracks(js.stack_history(hj), ts.stack_history(ht), sj, st)
    assert int(ts.stack_history(ht).pc_iters.min()) > 0


def test_sums_do_not_depend_on_threads():
    """Restriction and Galerkin sums on the permuted 64^2 cavity's
    matrix: the same bits at 1 and 4 intra-op threads."""
    mj, _ = compiled_both(permuted_arrays(64, seed=2)[0])
    diag, off, nbrs = _diffusion(mj, _cavity_table("jax"))
    _, ht = _hierarchies(diag, off, nbrs, _settings())
    _, At = _pair(diag, off, nbrs)
    r = torch.tensor(np.random.default_rng(5).standard_normal((3, len(diag))))
    before = torch.get_num_threads()
    out = []
    try:
        for n in (1, 4):
            torch.set_num_threads(n)
            G = tamg.galerkin_values(At, ht[0])
            out.append((tamg.restrict(r, ht[0]), G.diag, G.off))
    finally:
        torch.set_num_threads(before)
    for a, b in zip(*out):
        assert torch.equal(a, b)


def _signature_pairs():
    import orc_tpu.models.channel_flow as jcf
    import orc_tpu.solver.coloring as jcol
    import orc_tpu.solver.gmg as jg
    import orc_tpu.solver.init_fields as ji
    import orc_tpu.solver.recovery as jr

    import orc_tpu_torch.models.channel_flow as tcf
    import orc_tpu_torch.solver.coloring as tcol
    import orc_tpu_torch.solver.gmg as tg
    import orc_tpu_torch.solver.init_fields as ti
    import orc_tpu_torch.solver.recovery as tr

    names = {
        (jcol, tcol): ["greedy_coloring"],
        (jk, tk): ["gauss_seidel_solve", "iterative_solve"],
        (jamg, tamg): [
            "build_hierarchy", "build_hierarchy_from_matrix", "galerkin_values",
            "multigrid_solve", "_aggregate", "_coarse_structure", "_mg_correction",
        ],
        (jg, tg): ["build_mg_hierarchy"],
        (ji, ti): [
            "check_boundary_conditions", "initialize_pressure_field",
            "initialize_velocity_field", "initialize_flow", "initialize_flow_ramp",
        ],
        (jr, tr): ["solve_steady_with_recovery"],
        (jcf, tcf): ["solve_channel_flow"],
    }
    for (jm, tm), fns in names.items():
        for fn in fns:
            yield f"{tm.__name__.rsplit('.', 1)[-1]}.{fn}", getattr(jm, fn), getattr(tm, fn)


SIGNATURES = list(_signature_pairs())


@pytest.mark.parametrize("label,jf,tf", SIGNATURES, ids=[s[0] for s in SIGNATURES])
def test_signature_matches_orc_tpu(label, jf, tf):
    """Every parameter of orc_tpu's function is the port's, in orc_tpu's
    order; left out are orc_tpu's sharded hooks (ROADMAP item 14), and
    the port adds only an explicit device."""
    import inspect

    sharded = {"axis_sum", "refresh", "mg_owned", "comm"}
    j = [n for n in inspect.signature(jf).parameters if n not in sharded]
    t = [n for n in inspect.signature(tf).parameters if n != "device"]
    assert j == t, (j, t)


def test_mg_level_has_orc_tpu_fields():
    import dataclasses

    j = [f.name for f in dataclasses.fields(jamg.MgLevel)]
    t = [f.name for f in dataclasses.fields(tamg.MgLevel)]
    assert t[: len(j)] == j and t[len(j):] == ["restrict_src", "galerkin_src"]
