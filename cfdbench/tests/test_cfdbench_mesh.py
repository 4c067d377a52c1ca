"""Mesh cases: a generated TGRID mesh read through the program's case path
and judged by the face-list reference (reference/mesh.py) through the
layout by correspondence (layout_mesh.py), on the CPU at small sizes.

- The face-list reference computes what the box reference computes on
  an ungraded closed cavity, in 2-D and 3-D, under SIMPLE and SIMPLE_FC.
- The box cells read the same check numbers as before mesh cases came.
- On a graded, scrambled channel (velocity inlet, pressure outlet,
  walls) a sound run is correct, and a run with the timed path broken
  underneath is not, fault by fault; the bfloat16 control fails.
- The TGRID file round-trips through both of the program's parsers and
  is written once.
"""

import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from cfdbench import control, run
from cfdbench.meshes import graded_box, tgrid
from cfdbench.reference import box as fv
from cfdbench.reference import judge, mesh as fm, mesh_fc, mesh_simple, simple, simple_fc

ROOT = Path(__file__).resolve().parents[2]
#: The channel's configuration and workload: a test fixture, no cell.
FIXTURES = Path(__file__).resolve().parent / "fixtures"
SEED = 2**31 + 17
SIZES = [dict(nx=16, ny=8, nz=1, dim=2), dict(nx=6, ny=5, nz=4)]


# --- the face-list reference against the box reference -----------------------------


def _cells(grid, x):
    """A box field [..., Z, Y, X] in the generator's cell order [..., C]."""
    i, j, k = torch.as_tensor(grid.cell_ijk).T
    return x[..., k, j, i]


def _faces(ref, flux, dims):
    """Box face arrays (along +e_a) as one [F] array out of each face's
    owner (a uniform unit box)."""
    n, xf = ref.normal, ref.face_centroid
    axis = torch.argmax(torch.abs(n), dim=1)
    out = torch.empty(n.shape[0], dtype=n.dtype)
    for a in range(3):
        sel = torch.nonzero(axis == a)[:, 0]
        pos = [
            (torch.round if b == a else torch.floor)(xf[sel, b] * dims[b]).long() for b in range(3)
        ]
        out[sel] = flux[a][pos[2], pos[1], pos[0]] * torch.sign(n[sel, a])
    return out


@pytest.mark.parametrize("fc", [False, True], ids=["simple_ud", "simple_fc_tvd_dc_rc"])
@pytest.mark.parametrize("dims", [(16, 8, 1), (6, 5, 4)], ids=["2d", "3d"])
def test_face_list_reference_is_the_box_reference(dims, fc):
    nx, ny, nz = dims
    grid = graded_box.generate(nx, ny, nz, dim=3)
    side = "symmetry" if nz == 1 else "wall"
    bnd = {name: {"type": "wall"} for name in graded_box.PLANE_ZONES.values()}
    bnd.update({"TOP_WALL": {"type": "wall", "velocity": [1.0, 0.0, 0.0]},
                "PERIODIC_-Z": {"type": side}, "PERIODIC_+Z": {"type": side}})
    box = fv.make_box(dims, (1.0, 1.0, 1.0), bnd, torch.float64, "cpu")
    ref = fm.make_mesh(grid, bnd)
    prm = dict(
        rho=1.0, mu=0.01, alpha_u=0.6, alpha_p=0.03 if fc else 0.1, sweeps=6, omega=0.8,
        momentum="tvd_dc_umist" if fc else "ud", solver_iterations=50, solver_threshold=1e-3,
        pressure_interpolation="linear_weighted", relaxation_mode="implicit",
        velocity_interpolation="rhie_chow" if fc else "linear_weighted",
    )
    g = torch.Generator().manual_seed(3)
    vel = 0.1 * torch.randn((3, nz, ny, nx), generator=g, dtype=torch.float64)
    p = 0.1 * torch.randn((nz, ny, nx), generator=g, dtype=torch.float64)
    md = (1.0 + torch.rand((nz, ny, nx), generator=g, dtype=torch.float64)).expand(3, -1, -1, -1)
    sb = dict(vel=vel, p=p, md=md, flux=None)
    sm = dict(vel=_cells(grid, vel), p=_cells(grid, p), md=_cells(grid, md), flux=None)
    bm, mm = (simple_fc, mesh_fc) if fc else (simple, mesh_simple)

    def gap(a, b):
        return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))

    for _ in range(2):  # from the seeded start, then from the stored flux
        pb, pm = bm.predict(box, prm, sb), mm.predict(ref, prm, sm)
        assert gap(pm["mom"].diag, _cells(grid, pb["mom"].diag)) < 1e-12
        assert gap(pm["ustar"], _cells(grid, pb["ustar"])) < 1e-12
        assert gap(pm["psys"].b, _cells(grid, pb["psys"].b)) < 1e-12
        assert gap(pm["psys"].apply(sm["p"]), _cells(grid, pb["psys"].apply(sb["p"]))) < 1e-12
        sol = bm.solve(box, prm, sb, pb)
        ob, om = bm.finish(box, prm, sb, pb, sol), mm.finish(ref, prm, sm, pm, _cells(grid, sol))
        assert gap(om["vel"], _cells(grid, ob["vel"])) < 1e-12
        if fc:
            assert gap(om["flux"][0], _faces(ref, ob["flux"], dims)) < 1e-12
        sb = dict(ob, md=ob["md"].expand(3, *ob["md"].shape))
        sm = dict(om, md=om["md"].expand(3, -1))


# --- the box cells read as before -----------------------------------------------------

#: Each box cell's check numbers at a small size, a window of two
#: iterations and seed 2**31 + 101, so that a change of the harness that
#: moves them shows.
BOX_READINGS = {
    "ghia-3072-ck": {"mom_diag": 1.1055910000214532e-07, "u_star": 3.287303608586438e-07,
                     "p_residual_first": 0.0042912340493011765, "p_residual": 0.0042912340493011765,
                     "flux": 8.464339622739558e-07},
    "cube-256-fm": {"mom_diag": 1.553761541042167e-07, "u_star": 3.4158924348226735e-07,
                    "p_residual_first": 0.005819867508721409, "p_residual": 0.005819867508721409},
    "ghia-3200-fm": {"mom_diag": 1.2785353291394797e-07, "u_star": 2.791429463746775e-07,
                     "p_residual_first": 0.003988037784345313, "p_residual": 0.003988037784345313,
                     "flux": 1.0603613728053063e-06},
}


@pytest.mark.parametrize("cell_name, size", [("ghia-3072-ck", (16, 1)), ("cube-256-fm", (8, 8)), ("ghia-3200-fm", (16, 1))])
def test_box_cells_read_as_before(monkeypatch, cell_name, size):
    from orc_tpu_torch.solver import simple as program

    if cell_name == "ghia-3200-fm":  # its face-major step, as above CK_AUTO_MAX_CELLS
        monkeypatch.setattr(program, "CK_AUTO_MAX_CELLS", 0)
    result, readings = run.run_cell(run.load_spec(cell_name), 2**31 + 101, 1e-6, False, device="cpu", size=size)
    assert readings == BOX_READINGS[cell_name]
    assert "mesh_file_s" not in result["setup_parts"] and "layout" not in result["check"]


# --- a graded, scrambled channel -----------------------------------------------------


@pytest.fixture(scope="module")
def channel_bench(tmp_path_factory):
    """BENCHMARK.json with a cell of the channel configuration, in a
    scratch copy."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(
        {"name": "channel-1m", "config": "channel-graded", "traffic": "steady", "chips": 1, "why": "tests"}
    )
    path = tmp_path_factory.mktemp("bench") / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


def channel(bench_path, size, dtype="float32"):
    spec = run.load_spec("channel-1m", bench_path=bench_path, files=FIXTURES)
    bnd = spec.config["boundaries"]
    if size.get("dim") == 2:  # no z planes
        bnd = {k: v for k, v in bnd.items() if not k.startswith("PERIODIC")}
    spec.config = dict(spec.config, dtype=dtype, boundaries=bnd)
    return spec


def channel_run(bench_path, size, dtype="float32", seed=SEED):
    return run.run_cell(channel(bench_path, size, dtype), seed, 1e-6, False, device="cpu", size=size)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("size", SIZES, ids=["2d", "3d"])
def test_sound_channel_is_correct(channel_bench, size, dtype):
    result, readings = channel_run(channel_bench, size, dtype)
    assert result["correct"] is True, readings
    assert list(result)[-1] == "check" and "layout" in result["check"]
    parts = result["setup_parts"]
    assert parts["mesh_file_bytes"] > 0 and parts["mesh_build_s"] > 0
    if dtype == "float64":  # the reference computes what the program computes
        assert max(readings[k] for k in ("mom_diag", "u_star", "flux", "layout")) < 1e-12


def _flip_outlet(monkeypatch):
    """The program takes the pressure outlet's faces for walls."""
    from orc_tpu_torch.ops.fields import PRESSURE_OUTLET, WALL
    from orc_tpu_torch.solver import simple as program

    real = program.device_bc

    def device_bc(table, *a, **kw):
        codes, scalar, vector = real(table, *a, **kw)
        return torch.where(codes == PRESSURE_OUTLET, WALL, codes).to(codes.dtype), scalar, vector

    monkeypatch.setattr(program, "device_bc", device_bc)


def _move_centroid(monkeypatch):
    """The program's centroid of a cell at the outlet moved by one cell
    width along x, out of the box (onto no other centroid)."""
    from orc_tpu_torch.mesh import compile as program_compile

    real = program_compile.derive_geometry

    def derive_geometry(raw):
        geo = real(raw)
        cc = geo.cell_centroid.copy()
        cc[np.argmax(cc[:, 0]), 0] += raw.points[:, 0].max() / SIZES[0]["nx"]
        return dataclasses.replace(geo, cell_centroid=cc)

    monkeypatch.setattr(program_compile, "derive_geometry", derive_geometry)


def _unchanged(monkeypatch):
    from orc_tpu_torch.solver import simple as program

    real = program.solve_steady

    def solve_steady(mesh, table, settings, rho, mu, state=None, **kw):
        _, history = real(mesh, table, settings, rho, mu, state=state, **kw)
        return state, history

    monkeypatch.setattr(program, "solve_steady", solve_steady)


def _noop_solve(monkeypatch):
    from orc_tpu_torch.solver import simple as program

    monkeypatch.setattr(program, "_solve_p_prime", control.noop_p_solve(program._solve_p_prime))


@pytest.mark.parametrize(
    "plant", [_unchanged, _noop_solve, _flip_outlet, _move_centroid],
    ids=["unchanged", "noop_solve", "outlet_as_wall", "centroid_moved"],
)
def test_broken_channel_is_not_correct(monkeypatch, channel_bench, plant):
    plant(monkeypatch)
    result, readings = channel_run(channel_bench, SIZES[0])
    assert result["correct"] is False, readings


def test_control_fails_on_the_channel(channel_bench):
    spec = channel(channel_bench, SIZES[1])
    cell = run.make_cell(spec, "cpu", SIZES[1])
    layout, ref = cell.layout(), cell.box()
    prm = judge.params(spec.config)
    mod = judge.coupling(spec.config["reference"]["module"])
    row = control.readings(cell, layout, ref, prm, mod, SEED, 10)
    limits = spec.workload["limits"]
    assert all(row["program"][k] <= limits[k] for k in limits), row["program"]
    assert any(row["control"][k] > limits[k] for k in limits), row["control"]
    assert any(row["unchanged"][k] > limits[k] for k in limits), row["unchanged"]
    assert row["noop_solve"]["p_residual_first"] > limits["p_residual_first"], row["noop_solve"]


# --- the TGRID file -----------------------------------------------------------------


@pytest.mark.parametrize("size", SIZES, ids=["2d", "3d"])
def test_tgrid_round_trip(tmp_path, size):
    from orc_tpu_torch.mesh.tgrid import parse_tgrid

    case = dict(generator="graded_box", grading_y=1.1, codes={"OUTLET": "pressure_outlet"}, **size)
    path, seconds, grid = tgrid.mesh_file(case, tmp_path)
    assert seconds > 0 and grid is not None
    raws = [parse_tgrid(path.read_text())]
    if shutil.which("g++"):
        from orc_tpu_torch.mesh.native import parse_tgrid_native

        raws.append(parse_tgrid_native(str(path)))
    for raw in raws:
        assert raw.dim == grid.dim and raw.n_cells == grid.n_cells
        assert np.array_equal(raw.points, grid.points)
        assert np.array_equal(np.stack(raw.face_nodes), grid.face_nodes)
        assert np.array_equal(raw.face_cells, grid.face_cells)
        zones = [(z.name, int(z.zone_type)) for _, z in sorted(raw.face_zones.items())]
        assert zones == grid.zones
        assert np.array_equal(np.unique(raw.face_zone_id, return_inverse=True)[1], grid.face_zone)
    stamp = path.stat().st_mtime_ns
    again, seconds, grid = tgrid.mesh_file(case, tmp_path)
    assert again == path and seconds == 0.0 and grid is None and path.stat().st_mtime_ns == stamp
    other, _, _ = tgrid.mesh_file(dict(case, grading_y=1.2), tmp_path)
    assert other != path


def test_zone_names_are_the_box_planes():
    assert graded_box.PLANE_ZONES == fv.PLANE_ZONES


# --- per-layer readers on a mesh case --------------------------------------------------


@pytest.mark.parametrize(
    "name, reads",
    [("spmv_hbm_pct", False), ("smooth_hbm_pct", False), ("asm_hbm_pct", False), ("idle_pct", True),
     ("launches_per_iter", True), ("plain_ms_per_iter", True), ("p_solve_residual", True), ("mesh_build_s", True)],
)
def test_readers_on_a_mesh_case(name, reads):
    """A reader that needs a box's dims reads nothing on a mesh case; the
    others read as on a box."""
    import importlib

    from cfdbench.tests.test_cfdbench_metrics import C, ctx, recorded

    box = ctx()
    mesh = run.MetricContext(recorded(), 2, None, C, 4, box.pc_residuals, box.mesh_build_s)
    mod = importlib.import_module(f"cfdbench.metrics.{name}")
    assert (mod.read(mesh) == mod.read(box)) if reads else (mod.read(mesh) is None)


def test_channel_case_file_runs_the_flagship_numerics(channel_bench):
    """The case file a mesh case hands the CLI's parser: the mesh file,
    the flagship's numerics, the fluid and every zone's condition."""
    from orc_tpu_torch.models.cavity import flagship_settings
    from orc_tpu_torch.utils.config import parse_case

    spec = run.load_spec("channel-1m", bench_path=channel_bench, files=FIXTURES)
    case = parse_case(run.case_text(spec.config, "meshes/channel.msh"))
    assert case.mesh_path == "meshes/channel.msh"
    assert case.settings == flagship_settings()
    assert (case.rho, case.mu) == (1.0, 0.01)
    assert case.boundaries == spec.config["boundaries"]
