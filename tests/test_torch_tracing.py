"""The port's spans and host-sync counter (orc_tpu_torch/utils/profiling.py
`span`, `to_host`) on the CPU.

- `span` is one shared no-op context while no profiler runs, and a
  profiler range (a plain host op, not a user annotation) while one does;
- under torch.profiler, `solve_steady(iterations=2)` nests
  orc.solve_steady > orc.prepare, orc.chunk > orc.step > the seven
  phases in order, on each of the four steps ((c,k) and face-major,
  parity SIMPLE and SIMPLE_FC); under MULTIGRID, on a box (geometric)
  and on a gather matrix (algebraic), orc.pressure_solve > orc.mg.level1
  > orc.mg.galerkin, orc.mg.level2 > ...;
- `to_host.syncs` counts 1 + iterations // EXIT_CHECK_EVERY reads for a
  capped BiCGSTAB solve (7 for BiCGSTAB(50)) and 2 L + 1 for a V-cycle of
  L coarse levels whose smooths stay under EXIT_CHECK_EVERY iterations;
  each counted read is one orc.sync.<site> span;
- outputs are bitwise equal with and without a profiler running, and the
  verbose chunk line prints the chunk's own metrics.
"""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from orc_tpu_torch.mesh.generate import structured_box_mesh
from orc_tpu_torch.models.cavity import cavity_case, default_settings, flagship_settings
from orc_tpu_torch.ops.assembly import diffusion_system
from orc_tpu_torch.ops.fields import device_bc, face_bc
from orc_tpu_torch.ops.spmv import EllMatrix
from orc_tpu_torch.solver import amg, fc, gmg, krylov, simple
from orc_tpu_torch.utils import profiling
from orc_tpu_torch.utils import settings as tset

PHASES = [
    "orc.gradients",
    "orc.momentum_assembly",
    "orc.momentum_solve",
    "orc.pressure_assembly",
    "orc.pressure_solve",
    "orc.correction",
    "orc.step_metrics",
]

#: A MULTIGRID pressure solve whose smooths all stay under the exit-check
#: interval (four BiCGSTAB iterations, the coarsest level's too).
MG4 = tset.MatrixSolverSettings(
    solver_type=tset.SolutionMethod.MULTIGRID,
    iterations=4,
    multigrid_levels=3,
    multigrid_smoother_iterations=4,
    multigrid_coarsest_size=4,
    preconditioner=tset.PreconditionMethod.JACOBI,
)

#: (settings, use_ck, the module and name of the step solve_steady runs)
STEPS = {
    "ck-parity": (default_settings, True, simple, "ck_simple_step"),
    "ck-fc": (flagship_settings, True, fc, "ck_simple_step_fc"),
    "fm-parity": (default_settings, False, simple, "simple_step"),
    "fm-fc": (flagship_settings, False, fc, "simple_step_fc"),
}


def _spans(prof):
    """(name, start, end) of the orc. spans, outer before inner."""
    spans = [
        (e.name, e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.name.startswith("orc.")
    ]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


def _tree(spans):
    """Each span's children (indices, in order) and the roots."""
    children = {i: [] for i in range(len(spans))}
    roots, stack = [], []
    for i, (_, s, e) in enumerate(spans):
        while stack and spans[stack[-1]][2] < e:
            stack.pop()
        (children[stack[-1]] if stack else roots).append(i)
        stack.append(i)
    return children, roots


def _names(spans, idx):
    return [spans[i][0] for i in idx]


def _cavity(settings_fn, n=10, solver=None):
    mesh, table = cavity_case(n=n, device="cpu")
    settings = settings_fn()
    if solver is not None:
        settings = dataclasses.replace(settings, matrix_solver=solver)
    return mesh, table, settings


def _solve(mesh, table, settings, use_ck, iterations=2, state=None, **kw):
    kw = dict(dict(reporting_interval=iterations, verbose=False), **kw)
    return simple.solve_steady(
        mesh, table, settings, 1.0, 0.01, state=state, iterations=iterations,
        use_ck=use_ck, **kw,
    )


def test_span_without_profiler_is_the_shared_null_context():
    a, b = profiling.span("orc.a"), profiling.span("orc.b")
    assert a is b
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        inside = profiling.span("orc.a")
        assert inside is not a
        with inside:
            torch.ones(2).sum()
    assert profiling.span("orc.a") is a


def test_span_is_a_host_op_not_a_user_annotation():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("orc.outer"):
            with profiling.span("orc.inner"):
                torch.ones(3).sum()
    ev = {e.name: e for e in prof.events() if e.name.startswith("orc.")}
    assert set(ev) == {"orc.outer", "orc.inner"}
    assert not any(e.is_user_annotation for e in ev.values())
    outer, inner = ev["orc.outer"].time_range, ev["orc.inner"].time_range
    assert outer.start <= inner.start and inner.end <= outer.end


def test_to_host_counts_each_read_and_returns_python_values():
    before = profiling.to_host.syncs
    assert profiling.to_host(torch.tensor(True), "a") is True
    assert profiling.to_host(torch.tensor(2.5), "b") == 2.5
    assert profiling.to_host(torch.tensor([1.0, 2.0]), "c") == [1.0, 2.0]
    assert profiling.to_host.syncs - before == 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        profiling.to_host(torch.tensor(1), "site")
    assert [s[0] for s in _spans(prof)] == ["orc.sync.site"]


@pytest.mark.parametrize("name", sorted(STEPS))
def test_step_span_tree(name, monkeypatch):
    settings_fn, use_ck, module, step = STEPS[name]
    mesh, table, settings = _cavity(settings_fn)
    called = []
    real = getattr(module, step)

    def spy(*a, **k):
        called.append(step)
        return real(*a, **k)

    monkeypatch.setattr(module, step, spy)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _solve(mesh, table, settings, use_ck)
    assert called == [step, step]
    spans = _spans(prof)
    children, roots = _tree(spans)
    assert _names(spans, roots) == ["orc.solve_steady"]
    top = children[roots[0]]
    assert _names(spans, top) == ["orc.prepare", "orc.chunk", "orc.sync.divergence"]
    steps = children[top[1]]
    assert _names(spans, steps) == ["orc.step", "orc.step"]
    for s in steps:
        assert _names(spans, children[s]) == PHASES
        solve = children[s][PHASES.index("orc.pressure_solve")]
        assert set(_names(spans, children[solve])) <= {"orc.sync.all_done"}
        assert children[solve]  # the BiCGSTAB exit checks


@pytest.mark.parametrize("use_ck", [True, False], ids=["ck", "fm"])
def test_multigrid_levels_nest_in_the_pressure_solve(use_ck):
    mesh, table, settings = _cavity(default_settings, n=16, solver=MG4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _solve(mesh, table, settings, use_ck, iterations=1)
    spans = _spans(prof)
    children, _ = _tree(spans)
    solves = [i for i, s in enumerate(spans) if s[0] == "orc.pressure_solve"]
    assert len(solves) == 1
    level, depth = solves[0], 0
    while True:
        mg = [j for j in children[level] if spans[j][0].startswith("orc.mg.level")]
        if not mg:
            break
        assert len(mg) == 1
        depth += 1
        level = mg[0]
        assert spans[level][0] == f"orc.mg.level{depth}"
        assert _names(spans, children[level])[0] == "orc.mg.galerkin"
    assert depth == 3


def _box_matrix(n, shift=0.0):
    """The n x n box's diffusion matrix (+ shift on the diagonal), float64
    on the CPU, and its mesh."""
    mesh, table = structured_box_mesh(n, n, 1, device="cpu")
    zc, zs, zv = device_bc(table, mesh.dtype, device="cpu")
    d = diffusion_system(mesh, face_bc(mesh, zc, zs, zv), torch.tensor(1.0, dtype=mesh.dtype))
    return d.diag + shift, d.off, mesh


def test_capped_bicgstab_counts_its_exit_checks():
    diag, off, mesh = _box_matrix(64)
    A = EllMatrix(diag=diag, off=off, neighbors=None, offsets=mesh.neighbor_offsets)
    b = torch.randn(mesh.n_cells, dtype=torch.float64, generator=torch.Generator().manual_seed(7))
    before = profiling.to_host.syncs
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, info = krylov.bicgstab_solve(A, b, torch.zeros_like(b), 50, convergence_threshold=1e-14)
    syncs = profiling.to_host.syncs - before
    assert int(info.iterations) == 50  # capped, not converged
    assert syncs == 1 + 50 // krylov.EXIT_CHECK_EVERY == 7
    assert [s[0] for s in _spans(prof)] == ["orc.sync.all_done"] * syncs


def test_vcycle_counts_one_read_per_smooth():
    diag, off, mesh = _box_matrix(32, shift=0.1)
    A = EllMatrix(diag=diag, off=off, neighbors=None, offsets=mesh.neighbor_offsets)
    dims = gmg.infer_box_dims(mesh.neighbor_offsets, mesh.n_cells)
    h = gmg.build_gmg_hierarchy(dims, mesh.neighbor_offsets, MG4)
    assert len(h) == 3
    b = torch.randn(mesh.n_cells, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    before = profiling.to_host.syncs
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gmg.gmg_solve(A, b, torch.zeros_like(b), MG4, h)
    syncs = profiling.to_host.syncs - before
    assert syncs == 2 * len(h) + 1
    names = [s[0] for s in _spans(prof)]
    assert names.count("orc.sync.all_done") == syncs
    assert names.count("orc.mg.galerkin") == len(h)
    assert sorted(n for n in names if n.startswith("orc.mg.level")) == [
        f"orc.mg.level{i + 1}" for i in range(len(h))
    ]


def test_algebraic_vcycle_levels_nest():
    diag, off, mesh = _box_matrix(16, shift=0.1)
    solver = MG4
    h = amg.build_hierarchy_from_matrix(
        diag.numpy(), off.numpy(), mesh.cell_neighbors.numpy(), solver, device="cpu"
    )
    assert len(h) >= 2
    A = EllMatrix(diag=diag, off=off, neighbors=mesh.cell_neighbors)
    b = torch.randn(mesh.n_cells, dtype=torch.float64, generator=torch.Generator().manual_seed(5))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        amg.multigrid_solve(A, b, torch.zeros_like(b), solver, h)
    spans = _spans(prof)
    children, roots = _tree(spans)
    level = [i for i in roots if spans[i][0].startswith("orc.mg.")]
    for depth in range(1, len(h) + 1):
        assert _names(spans, level) == [f"orc.mg.level{depth}"]
        kids = children[level[0]]
        assert _names(spans, kids)[0] == "orc.mg.galerkin"
        level = [j for j in kids if spans[j][0].startswith("orc.mg.level")]
    assert level == []


@pytest.mark.parametrize("name", sorted(STEPS))
def test_each_counted_read_is_one_sync_span(name):
    settings_fn, use_ck, *_ = STEPS[name]
    mesh, table, settings = _cavity(settings_fn)
    before = profiling.to_host.syncs
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _solve(mesh, table, settings, use_ck, iterations=3, reporting_interval=2)
    syncs = profiling.to_host.syncs - before
    sync_spans = [s for s in _spans(prof) if s[0].startswith("orc.sync.")]
    assert syncs == len(sync_spans) > 2


def _flat(state, history):
    out = [state.vel, state.p, state.mom_diag]
    if state.flux is not None:
        out.append(state.flux)
    for h in history:
        out += [getattr(h, f.name) for f in dataclasses.fields(h)]
    return out


@pytest.mark.parametrize("name", ["ck-fc", "fm-parity"])
def test_outputs_bitwise_equal_under_the_profiler(name):
    settings_fn, use_ck, *_ = STEPS[name]
    mesh, table, settings = _cavity(settings_fn)
    plain = _flat(*_solve(mesh, table, settings, use_ck, iterations=3))
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _flat(*_solve(mesh, table, settings, use_ck, iterations=3))
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def test_verbose_prints_each_chunks_metrics(capsys):
    mesh, table, settings = _cavity(default_settings)
    _, history = _solve(
        mesh, table, settings, True, iterations=2, reporting_interval=1, verbose=True
    )
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("Iteration")]
    assert len(lines) == 2
    for done, (line, h) in enumerate(zip(lines, history), start=1):
        va = h.vel_avg[-1].tolist()
        expect = (
            f"Iteration {done}: avg velocity = "
            f"({va[0]:.2e}, {va[1]:.2e}, {va[2]:.2e})\t"
            f"avg peclet = {float(h.peclet_avg[-1]):.1e}\t"
            f"vel corr = {float(h.vel_corr_norm[-1]):.2e}\t"
            f"p corr = {float(h.p_corr_norm[-1]):.2e}\t"
            f"ms/iter = "
        )
        assert line.startswith(expect)



#: The benchmark cells' steps at a small size, float32 on the card:
#: (case size (n, nz), settings, use_ck).
CARD_CASES = {
    # ghia-3072-ck: the (c,k) SIMPLE_FC step with rows 4 and 6.
    "ck-fc": ((64, 1), flagship_settings, "auto"),
    # ghia-3200-fm: the face-major SIMPLE_FC step.
    "fm-fc": ((64, 1), flagship_settings, False),
    # cube-256-fm: the face-major SIMPLE step under the V-cycle.
    "fm-parity-mg": ((32, 32), default_settings, False),
    # the (c,k) SIMPLE step with rows 3 and 5 under the V-cycle.
    "ck-parity-mg": ((32, 32), default_settings, "auto"),
}
CUBE_MG = tset.MatrixSolverSettings(
    solver_type=tset.SolutionMethod.MULTIGRID,
    iterations=50,
    multigrid_levels=5,
    multigrid_smoother_iterations=4,
)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_every_host_sync_of_a_solve_is_counted_on_the_card(name):
    """Every synchronising CUDA call that torch's sync debug mode reports
    in a two-iteration solve_steady call is one of `to_host`'s reads."""
    import warnings

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    (n, nz), settings_fn, use_ck = CARD_CASES[name]
    mesh, table = cavity_case(n=n, nz=nz, dtype=torch.float32, device="cuda")
    settings = settings_fn()
    if nz > 1:
        settings = dataclasses.replace(settings, matrix_solver=CUBE_MG)
    gen = torch.Generator(device="cuda").manual_seed(11)
    state = simple.initial_state(
        mesh,
        vel=1e-3 * torch.randn((mesh.n_cells, 3), generator=gen, device="cuda"),
        p=1e-3 * torch.randn((mesh.n_cells,), generator=gen, device="cuda"),
    )
    kw = dict(reporting_interval=200, verbose=False, use_ck=use_ck)
    state, _ = simple.solve_steady(mesh, table, settings, 1.0, 1e-3, state=state, iterations=1, **kw)
    torch.cuda.synchronize()
    before = profiling.to_host.syncs
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            simple.solve_steady(mesh, table, settings, 1.0, 1e-3, state=state, iterations=2, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchronizing CUDA operation" in str(w.message)]
    counted = profiling.to_host.syncs - before
    assert counted > 2
    assert len(syncs) == counted, [f"{w.filename}:{w.lineno}" for w in syncs]
