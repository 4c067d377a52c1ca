"""Port solvers (orc_tpu_torch/solver/krylov.py) against orc_tpu on
seeded diagonally dominant structured systems, single [C] and batched
[3,C] over one shared matrix (orc_tpu: jax.vmap). float64; solutions
agree to rtol 1e-10 (same iteration, sums in another order) and every
per-component iteration count is equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from orc_tpu.ops.spmv import EllMatrix as JEll
from orc_tpu.solver import krylov as jk

from torch_parity import np_, structured_system, to_jax_settings

from orc_tpu_torch.ops.spmv import EllMatrix as TEll
from orc_tpu_torch.solver import krylov as tk
from orc_tpu_torch.utils import settings as tset

OFFSETS = (-24, -1, 1, 24, 0, 0)
C = 24 * 20


def _system(batched: bool, seed=0):
    """Seeded system; batched right-hand sides differ in kind so the
    components exit at different iterations: a random start, a zero
    start, and a start close to the solution."""
    diag, off, b, x0 = structured_system(C, OFFSETS, B=3 if batched else 0, seed=seed)
    if batched:
        A = np.diag(diag)
        for k, d in enumerate(OFFSETS):
            if d:
                rows = np.arange(C)
                ok = (rows + d >= 0) & (rows + d < C)
                A[rows[ok], rows[ok] + d] += off[ok, k]
        x0[1] = 0.0
        x0[2] = np.linalg.solve(A, b[2]) * (1.0 + 1e-4)
    return diag, off, b, x0


def _pair(diag, off):
    return (
        JEll(diag=jnp.asarray(diag), off=jnp.asarray(off), neighbors=None,
             offsets=OFFSETS),
        TEll(diag=torch.tensor(diag), off=torch.tensor(off), neighbors=None,
             offsets=OFFSETS),
    )


def _run_jax(fn, b, x0):
    if b.ndim == 2:
        return jax.vmap(fn)(jnp.asarray(b), jnp.asarray(x0))
    return fn(jnp.asarray(b), jnp.asarray(x0))


def _compare(jres, tres):
    (xj, ij), (xt, it) = jres, tres
    np.testing.assert_array_equal(np_(it.iterations), np_(ij.iterations))
    np.testing.assert_allclose(np_(xt), np_(xj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        np_(it.residual), np_(ij.residual), rtol=1e-8, atol=1e-14
    )
    np.testing.assert_array_equal(np_(it.diverged), np_(ij.diverged))


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_bicgstab_matches(batched):
    diag, off, b, x0 = _system(batched)
    Aj, At = _pair(diag, off)
    jres = _run_jax(lambda bb, xx: jk.bicgstab_solve(Aj, bb, xx, 50, convergence_threshold=1e-9), b, x0)
    tres = tk.bicgstab_solve(At, torch.tensor(b), torch.tensor(x0), 50, convergence_threshold=1e-9)
    _compare(jres, tres)
    if batched:  # the components really exit at different iterations
        assert len(set(np_(tres[1].iterations).tolist())) > 1


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_jacobi_smooth_matches(batched):
    diag, off, b, x0 = _system(batched, seed=1)
    Aj, At = _pair(diag, off)
    jres = _run_jax(lambda bb, xx: jk.jacobi_smooth_solve(Aj, bb, xx, 6, 0.8), b, x0)
    tres = tk.jacobi_smooth_solve(At, torch.tensor(b), torch.tensor(x0), 6, 0.8)
    _compare(jres, tres)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_jacobi_matches(batched):
    diag, off, b, x0 = _system(batched, seed=2)
    Aj, At = _pair(diag, off)
    jres = _run_jax(lambda bb, xx: jk.jacobi_solve(Aj, bb, xx, 50, 0.8, 1e-3), b, x0)
    tres = tk.jacobi_solve(At, torch.tensor(b), torch.tensor(x0), 50, 0.8, 1e-3)
    _compare(jres, tres)


@pytest.mark.parametrize(
    "method", ["BICGSTAB", "JACOBI", "JACOBI_SMOOTH"]
)
@pytest.mark.parametrize("precond", ["JACOBI", "NONE"])
def test_iterative_solve_matches(method, precond):
    """The dispatch: column split, row scaling, then the solver; batched
    [3,C] with the shared matrix as the SIMPLE momentum solve uses it."""
    diag, off, b, x0 = _system(True, seed=3)
    ts = tset.MatrixSolverSettings(
        solver_type=tset.SolutionMethod[method],
        iterations=40,
        relaxation=0.8,
        relative_convergence_threshold=1e-4,
        preconditioner=tset.PreconditionMethod[precond],
        compensated_f32=True,  # no effect on float64 systems
    )
    js = to_jax_settings(ts)
    Aj, At = _pair(diag, off)
    jres = _run_jax(lambda bb, xx: jk.iterative_solve(Aj, bb, xx, js), b, x0)
    tres = tk.iterative_solve(At, torch.tensor(b), torch.tensor(x0), ts)
    _compare(jres, tres)


def test_deflated_singular_solve_matches():
    """A singular system (zero row sums) with the constant-mode
    projection, as the unanchored pressure-correction solve uses it."""
    diag, off, b, _ = structured_system(C, OFFSETS, seed=4)
    diag = -off.sum(axis=1)
    b = b - b.mean()
    active = np.ones(C, bool)
    active[-3:] = False
    Aj, At = _pair(diag, off)
    pj = jk.constant_deflation(jnp.asarray(1.0), active=jnp.asarray(active))
    pt = tk.constant_deflation(
        torch.tensor(1.0, dtype=torch.float64), active=torch.tensor(active)
    )
    np.testing.assert_allclose(
        np_(pt(torch.tensor(b))), np_(pj(jnp.asarray(b))), rtol=1e-13
    )
    settings = tset.MatrixSolverSettings(
        solver_type=tset.SolutionMethod.BICGSTAB, iterations=30
    )
    jres = jk.iterative_solve(
        Aj, jnp.asarray(b), jnp.zeros(C), to_jax_settings(settings), project=pj
    )
    tres = tk.iterative_solve(
        At, torch.tensor(b), torch.zeros(C, dtype=torch.float64), settings,
        project=pt,
    )
    _compare(jres, tres)


def test_exit_check_interval_does_not_change_results(monkeypatch):
    """Checking `done` on the host every iteration or every 8 gives the
    same iterates and counts (done components are frozen)."""
    diag, off, b, x0 = _system(True, seed=5)
    _, At = _pair(diag, off)
    args = (At, torch.tensor(b), torch.tensor(x0), 50)
    x8, i8 = tk.bicgstab_solve(*args, convergence_threshold=1e-9)
    monkeypatch.setattr(tk, "EXIT_CHECK_EVERY", 1)
    x1, i1 = tk.bicgstab_solve(*args, convergence_threshold=1e-9)
    assert torch.equal(x8, x1)
    assert torch.equal(i8.iterations, i1.iterations)


@pytest.mark.parametrize("method", ["GAUSS_SEIDEL", "MULTIGRID"])
def test_unported_methods_raise(method):
    """Gauss-Seidel without a colouring and multigrid without a hierarchy
    raise ValueError in both packages (before the port had them it
    raised NotImplementedError); tests/test_torch_gauss_seidel.py and
    tests/test_torch_amg.py run them."""
    diag, off, b, x0 = _system(False)
    Aj, At = _pair(diag, off)
    ts = tset.MatrixSolverSettings(solver_type=tset.SolutionMethod[method])
    with pytest.raises(ValueError):
        jk.iterative_solve(Aj, jnp.asarray(b), jnp.asarray(x0), to_jax_settings(ts))
    with pytest.raises(ValueError):
        tk.iterative_solve(At, torch.tensor(b), torch.tensor(x0), ts)
