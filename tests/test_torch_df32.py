"""The port's double-float arithmetic and DF32 iterative refinement
(orc_tpu_torch/ops/df32.py, the plain exact slice product of kernel 12,
orc_tpu_torch/solver/refine.py) against orc_tpu on CPU.

- Every primitive equals orc_tpu's eager `orc_tpu.ops.df32` on the same
  seeded float32 planes bit for bit (same operations in the same order;
  eager JAX dispatches op by op, so XLA cannot fuse them); the tree sum
  and the dot product reduce in another order (torch.sum vs XLA), so
  they are held at 1e-12 of the float64 reference instead.
- orc_tpu measured its error-free transforms on the TPU with a chain of
  39 two_prod/two_sum steps (2.8e-13 against f64) and found XLA:CPU's
  jit rewrites them away (3.9e-7). Torch on CPU keeps them: the same
  chain stays under 1e-12 here, so the port runs the df32 residual on
  every device and these tests exercise the card's arithmetic.
- `slice_spmv_exact_plain` against orc_tpu's `slice_spmv_exact(...,
  interpret=True)` on tests/test_df32.py's banded system: y at rtol
  1e-5, err at epsilon scale (orc_tpu's own test), and y + err against
  the float64 product of the hi planes at 1e-13 of each row's
  sum |coef x|, which orc_tpu's test cannot certify on XLA:CPU.
- DF32_IR through `iterative_solve` on the slice-plan, structured and
  batched [3,C] systems of tests/test_df32.py: below 1e-11 of x_true,
  and within 1e-10 of orc_tpu's solution (orc_tpu forms the residual in
  native f64 on CPU; measured gap ~1e-14).
- The permuted 12^2 cavity with DF32_IR (solve_cavity's settings), 20
  SIMPLE iterations, port against orc_tpu: fields within 1e-9 of scale
  (measured 3.4e-11), momentum iteration counts equal, pressure counts
  within one. orc_tpu's constant deflation multiplies the float32
  residual by a float64 scalar, which promotes its inner pressure solve
  to float64 (ROADMAP Queue 3); the port's inner solves stay float32.
- The same cavity with DF32_IR against native f64 solves as deep as
  DF32_IR's (the smoother's sweeps and the pressure threshold's exponent
  times refine_steps): the two trajectories coincide, which is what
  chip_smoke.py holds the card's 448^2 DF32_IR cavity to.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import compiled_both, np_, permuted_arrays, to_jax_settings

import jax
import jax.numpy as jnp
from orc_tpu.mesh.reorder import build_slice_plan as jplan
from orc_tpu.ops import df32 as jdf
from orc_tpu.ops.pallas_slice import slice_spmv_exact as j_exact
from orc_tpu.ops.spmv import EllMatrix as JEll
from orc_tpu.solver import krylov as jk

from orc_tpu_torch.mesh.reorder import build_slice_plan as tplan
from orc_tpu_torch.ops import df32 as tdf
from orc_tpu_torch.ops.slice_spmv import slice_spmv_exact, slice_spmv_exact_plain
from orc_tpu_torch.ops.spmv import EllMatrix as TEll
from orc_tpu_torch.solver import krylov as tk
from orc_tpu_torch.utils import settings as tset


def _wide(shape, seed):
    """float64 values over a wide dynamic range (tests/test_df32.py)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) * np.exp(rng.uniform(-8, 8, shape))


def _planes(shape, seed):
    """(hi, lo) float32 planes of seeded float64 values, as numpy."""
    a = _wide(shape, seed)
    hi = a.astype(np.float32)
    return hi, (a - hi.astype(np.float64)).astype(np.float32)


def _bits(x):
    return np_(x).view(np.uint32)


#: name -> (port function, orc_tpu function, number of float32 inputs)
PRIMITIVES = {
    "two_sum": (tdf.two_sum, jdf.two_sum, 2),
    "fast_two_sum": (tdf.fast_two_sum, jdf.fast_two_sum, 2),
    "split": (tdf.split, jdf.split, 1),
    "two_prod": (tdf.two_prod, jdf.two_prod, 2),
    "df_add": (tdf.df_add, jdf.df_add, 4),
    "df_mul": (tdf.df_mul, jdf.df_mul, 4),
}


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitive_matches_orc_tpu_bitwise(name):
    tf, jf, n = PRIMITIVES[name]
    xs = [_planes(4096, seed)[seed % 2] for seed in range(n)]
    if name == "fast_two_sum":  # its contract: |a| >= |b|
        xs[1] = xs[1] * np.float32(1e-3)
        xs[0] = np.sign(xs[0]) * np.maximum(np.abs(xs[0]), np.abs(xs[1]))
    got = tf(*(torch.from_numpy(np.ascontiguousarray(x)) for x in xs))
    ref = jf(*(jnp.asarray(x) for x in xs))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(_bits(g), _bits(r))


def test_from_to_f64_match_orc_tpu():
    a = _wide(4096, 7)
    th, tl = tdf.df_from_f64(torch.from_numpy(a))
    jh, jl = jdf.df_from_f64(jnp.asarray(a))
    np.testing.assert_array_equal(_bits(th), _bits(jh))
    np.testing.assert_array_equal(_bits(tl), _bits(jl))
    np.testing.assert_array_equal(np_(tdf.df_to_f64(th, tl)), np_(jdf.df_to_f64(jh, jl)))
    assert float(np.max(np.abs(np_(tdf.df_to_f64(th, tl)) - a) / np.abs(a))) < 2e-15


def test_df_spmv_matches_orc_tpu_bitwise():
    """The shift-path df32 SpMV (rolls, df_mul, df_add in column order),
    the system of tests/test_df32.py's test_df_spmv_vs_f64_shift."""
    C, offsets = 8192, (-64, -1, 1, 64)
    planes = [_planes(s, seed) for s, seed in (((C,), 4), ((C, 4), 5), ((C,), 6))]
    (dh, dl), (oh, ol), (xh, xl) = planes
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (dh, dl, oh, ol, xh, xl)]
    got = tdf.df_spmv(*t[:4], offsets, *t[4:])
    j = [jnp.asarray(a) for a in (dh, dl, oh, ol, xh, xl)]
    ref = jdf.df_spmv(*j[:4], offsets, *j[4:])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_bits(g), _bits(r))


def test_df_sum_and_dot_keep_f64_accuracy():
    """Tree sum and dot: torch reduces the error plane in another order
    than XLA, so these are held to the f64 answer (and to orc_tpu's)."""
    x, y = _wide(10000, 2), _wide(10000, 3)
    (xh, xl), (yh, yl) = (tdf.df_from_f64(torch.from_numpy(a)) for a in (x, y))
    want = float(np.sum(x * y))
    h, lo = tdf.df_dot(xh, xl, yh, yl)
    got = float(h) + float(lo)
    assert abs(got - want) / abs(want) < 1e-12
    jh, jl = jdf.df_dot(*(jnp.asarray(np_(a)) for a in (xh, xl, yh, yl)))
    assert abs(got - (float(jh) + float(jl))) / abs(want) < 1e-12
    p = torch.cat([torch.ones(512), torch.full((512,), 1e-8)])
    h, lo = tdf.df_sum(p)
    assert abs(float(h) + float(lo) - (512.0 + 512e-8)) / 512.0 < 1e-12


def test_error_free_chain_survives_on_cpu():
    """39 two_prod / two_sum steps (orc_tpu's chain: 2.8e-13 on its
    TPU, 3.9e-7 under XLA:CPU's jit): under 1e-12 in torch on CPU, where
    the plain float32 sum of the same products is off by ~1e-7."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((39, 4096)).astype(np.float32)
    b = rng.standard_normal((39, 4096)).astype(np.float32)
    acc = torch.zeros(4096)
    err = torch.zeros(4096)
    plain = torch.zeros(4096)
    for i in range(39):
        p, pe = tdf.two_prod(torch.from_numpy(a[i]), torch.from_numpy(b[i]))
        acc, te = tdf.two_sum(acc, p)
        err = err + (te + pe)
        plain = plain + torch.from_numpy(a[i]) * torch.from_numpy(b[i])
    ref = np.sum(a.astype(np.float64) * b.astype(np.float64), axis=0)
    scale = np.abs(ref).max()
    df = np.abs(np_(acc).astype(np.float64) + np_(err) - ref).max() / scale
    f32 = np.abs(np_(plain).astype(np.float64) - ref).max() / scale
    assert df < 1e-12, df
    assert f32 > 1e-8, f32


# --- kernel 12's plain version and DF32_IR --------------------------------


def _banded(C=2000, K=4, seed=0, band=40):
    """tests/test_df32.py's `_banded_system`: both packages' f64 matrix
    over one random banded adjacency with its slice plan, x_true and
    b = A x_true (numpy)."""
    rng = np.random.default_rng(seed)
    nbrs = np.clip(np.arange(C)[:, None] + rng.integers(-band, band, (C, K)), 0, C - 1)
    valid = nbrs != np.arange(C)[:, None]
    off = rng.standard_normal((C, K)) * valid * 0.2
    diag = np.abs(off).sum(1) + rng.uniform(1.0, 2.0, C)
    x_true = rng.standard_normal(C)
    Aj = JEll(
        diag=jnp.asarray(diag), off=jnp.asarray(off), neighbors=jnp.asarray(nbrs),
        offsets=None, plan=jplan(nbrs, valid, tile=128),
    )
    At = TEll(
        diag=torch.tensor(diag), off=torch.tensor(off),
        neighbors=torch.tensor(nbrs, dtype=torch.int32),
        plan=tplan(nbrs, valid, tile=128, device="cpu"),
    )
    return Aj, At, x_true, np_(At.matvec(torch.tensor(x_true)))


def test_exact_slice_product_matches_orc_tpu_kernel():
    Aj, At, x_true, _b = _banded(C=384, K=3, seed=11, band=8)
    Pj, Pt = Aj.prepare(), At.prepare()
    cj, _ = jdf.df_from_f64(Pj.off)
    xj, _ = jdf.df_from_f64(jnp.asarray(x_true))
    yj, ej = j_exact(cj, Pj.plan, xj, interpret=True)
    ct, _ = tdf.df_from_f64(Pt.off)
    xt, _ = tdf.df_from_f64(torch.tensor(x_true))
    before = slice_spmv_exact.launches
    y, e = slice_spmv_exact(ct, Pt.plan, xt)
    assert slice_spmv_exact.launches == before
    assert y.dtype == e.dtype == torch.float32 and y.shape == e.shape == (384,)
    np.testing.assert_array_equal(np_(ct), np_(cj))
    np.testing.assert_allclose(np_(y), np_(yj), rtol=1e-5, atol=1e-6)
    assert float(e.abs().max()) < 1e-5 * float(y.abs().max()) + 1e-7
    assert float(np.abs(np_(ej)).max()) < 1e-5 * float(y.abs().max()) + 1e-7
    # y + err is the f64 row sum of the hi planes' products.
    c64, x64 = np_(ct).astype(np.float64), np_(xt).astype(np.float64)
    At32 = TEll(
        diag=torch.zeros(384, dtype=torch.float64), off=torch.tensor(c64),
        neighbors=None, plan=Pt.plan, slice_layout=True,
    )
    ref = np_(At32.matvec(torch.tensor(x64)))
    absrow = np_(TEll(
        diag=At32.diag, off=torch.tensor(np.abs(c64)), neighbors=None,
        plan=Pt.plan, slice_layout=True,
    ).matvec(torch.tensor(np.abs(x64))))
    gap = np.abs(np_(y).astype(np.float64) + np_(e) - ref)
    assert np.all(gap <= 1e-13 * absrow), float(np.max(gap / np.maximum(absrow, 1e-300)))


def test_exact_slice_product_batched_rows():
    """[3,C] x over a shared and a per-row coefficient set: each row
    equals the single-row product bit for bit."""
    _Aj, At, x_true, _b = _banded(C=700, K=4, seed=2, band=30)
    P = At.prepare()
    coef, _ = tdf.df_from_f64(P.off)
    x3 = torch.stack([torch.tensor(x_true), 2 * torch.tensor(x_true), -torch.tensor(x_true)])
    x3, _ = tdf.df_from_f64(x3)
    y3, e3 = slice_spmv_exact_plain(coef, P.plan, x3)
    c3 = torch.stack([coef, 0.5 * coef, coef])
    yb, eb = slice_spmv_exact_plain(c3, P.plan, x3)
    for r in range(3):
        y, e = slice_spmv_exact_plain(coef, P.plan, x3[r])
        assert torch.equal(y3[r], y) and torch.equal(e3[r], e)
        y, e = slice_spmv_exact_plain(c3[r], P.plan, x3[r])
        assert torch.equal(yb[r], y) and torch.equal(eb[r], e)


def _ir_settings():
    return tset.MatrixSolverSettings(
        solver_type=tset.SolutionMethod.BICGSTAB,
        iterations=100,
        relative_convergence_threshold=1e-8,
        preconditioner=tset.PreconditionMethod.JACOBI,
        precision=tset.SolverPrecision.DF32_IR,
    )


def _structured():
    """tests/test_df32.py's structured 32x32 system, both packages."""
    from orc_tpu.mesh import structured_box_mesh

    mesh, _ = structured_box_mesh(32, 32, 1)
    rng = np.random.default_rng(3)
    interior = np.asarray(mesh.face_interior[mesh.cell_faces] & mesh.cell_face_mask)
    off = rng.standard_normal(interior.shape) * interior * 0.2
    diag = np.abs(off).sum(1) + 1.5
    offsets = mesh.neighbor_offsets
    x_true = rng.standard_normal(mesh.n_cells)
    Aj = JEll(diag=jnp.asarray(diag), off=jnp.asarray(off), neighbors=None, offsets=offsets)
    At = TEll(diag=torch.tensor(diag), off=torch.tensor(off), neighbors=None, offsets=offsets)
    return Aj, At, x_true, np_(At.matvec(torch.tensor(x_true)))


@pytest.mark.parametrize("system", ["slice_plan", "structured", "batched"])
def test_df32_ir_solve_matches_orc_tpu(system):
    if system == "structured":
        Aj, At, x_true, b = _structured()
    else:
        Aj, At, x_true, b = _banded(C=1000 if system == "batched" else 2000,
                                    seed=7 if system == "batched" else 0)
    ref_x = x_true
    if system == "batched":
        scale = np.array([1.0, 2.0, -1.0])[:, None]
        b, ref_x = scale * b[None, :], scale * x_true[None, :]
    settings = _ir_settings()
    x, info = tk.iterative_solve(
        At, torch.tensor(b), torch.zeros(b.shape, dtype=torch.float64), settings
    )
    js = to_jax_settings(settings)
    solve = lambda bb: jk.iterative_solve(Aj, bb, jnp.zeros_like(bb), js)  # noqa: E731
    xj, _ = jax.vmap(solve)(jnp.asarray(b)) if b.ndim == 2 else solve(jnp.asarray(b))
    assert x.dtype == torch.float64 and x.shape == b.shape
    assert info.iterations.shape == b.shape[:-1] and not bool(info.diverged.any())
    err = np.abs(np_(x) - ref_x).max() / np.abs(ref_x).max()
    assert err < 1e-11, err
    gap = np.abs(np_(x) - np_(xj)).max() / np.abs(ref_x).max()
    assert gap < 1e-10, gap


def test_df32_ir_gather_matrix():
    """A matrix with neither offsets nor a plan (the gather form of
    meshes too small for one): the df32 residual sums over the neighbour
    table, and the solve reaches f64 accuracy."""
    _Aj, At, x_true, b = _banded(C=300, K=3, seed=4, band=6)
    A = TEll(diag=At.diag, off=At.off, neighbors=At.neighbors)
    x, info = tk.iterative_solve(
        A, torch.tensor(b), torch.zeros(300, dtype=torch.float64), _ir_settings()
    )
    assert int(info.iterations) > 0
    assert np.abs(np_(x) - x_true).max() / np.abs(x_true).max() < 1e-11


def test_df32_ir_cavity_tracks_orc_tpu():
    from orc_tpu.models.cavity import cavity_case as j_cavity
    from orc_tpu.solver import simple as js

    from orc_tpu_torch.models.cavity import cavity_case as t_cavity, default_settings
    from orc_tpu_torch.solver import simple as ts

    kw, _perm = permuted_arrays(12, seed=9)
    mj, mt = compiled_both(kw)
    s = default_settings()
    s = s.replace(matrix_solver=dataclasses.replace(
        s.matrix_solver, precision=tset.SolverPrecision.DF32_IR
    ))
    run = dict(iterations=20, reporting_interval=20, verbose=False)
    _, tj = j_cavity(n=4)
    sj, hj = js.solve_steady(mj, tj, to_jax_settings(s), 1.0, 0.01, state=js.initial_state(mj), **run)
    _, tt = t_cavity(n=4, device="cpu")
    st, ht = ts.solve_steady(mt, tt, s, 1.0, 0.01, state=ts.initial_state(mt), **run)
    hj, ht = js.stack_history(hj), ts.stack_history(ht)
    assert not ht.diverged.any()
    np.testing.assert_array_equal(ht.mom_iters, np.asarray(hj.mom_iters))
    assert np.all(ht.mom_iters == 3 * 6)  # refine_steps x the smoother's sweeps
    assert np.max(np.abs(ht.pc_iters - np.asarray(hj.pc_iters))) <= 1
    for f in ("vel", "p"):
        d = np_(getattr(sj, f))
        gap = np.abs(np_(getattr(st, f)) - d).max() / np.abs(d).max()
        assert gap < 1e-9, (f, gap)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_df32_ir_cavity_tracks_native_at_its_depth():
    """DF32_IR's SIMPLE trajectory is the native f64 one of solves as
    deep as its own: the permuted 12^2 cavity, 20 iterations, DF32_IR
    against native f64 at the same depth within 1e-8 of scale (measured
    vel 1.6e-10, p 2.4e-10), while the native run at the configured
    depth (6 momentum sweeps, pressure to 1e-3) parts from it by more
    than a thousand times that (measured 5.8e-3 and 2.0e-2). The
    equal-depth settings are chip_smoke.py's `same_depth_settings`,
    which the card's 448^2 DF32_IR cavity is held against."""
    from orc_tpu_torch.mesh.compile import compile_from_arrays
    from orc_tpu_torch.models.cavity import cavity_case as t_cavity, default_settings
    from orc_tpu_torch.solver import simple as ts

    kw, _perm = permuted_arrays(12, seed=9)
    mesh = compile_from_arrays(**kw, dtype=torch.float64, device="cpu")
    _, table = t_cavity(n=4, device="cpu")
    native = default_settings()
    runs = {
        "df32": native.replace(matrix_solver=native.matrix_solver.replace_precision(
            tset.SolverPrecision.DF32_IR
        )),
        "native": native,
        "same depth": _chip_smoke().same_depth_settings(native),
    }
    out = {}
    for name, s in runs.items():
        st, _h = ts.solve_steady(
            mesh, table, s, 1.0, 0.01, state=ts.initial_state(mesh),
            iterations=20, reporting_interval=20, verbose=False,
        )
        out[name] = st
    gaps = {}
    for ref in ("native", "same depth"):
        for f in ("vel", "p"):
            d = np_(getattr(out[ref], f))
            gaps[ref, f] = np.abs(np_(getattr(out["df32"], f)) - d).max() / np.abs(d).max()
    for f in ("vel", "p"):
        assert gaps["same depth", f] < 1e-8, gaps
        assert gaps["native", f] > 1e3 * gaps["same depth", f], gaps
