"""The port's CLI (orc_tpu_torch/cli.py) beside orc_tpu's on the CPU.

- `run --device cpu` against orc_tpu's `cli.main` on a shrunk copy of
  every examples/*.toml (chip_smoke.case_copy: boxes capped at 16 cells
  a side, 8 in 3-D; 3 iterations; 2 time steps of 3 inner iterations;
  two sequencing levels, because a 4^2 -> 8^2 -> 16^2 cascade at Re 1000
  diverges after its first prolongation in both packages), each with a
  checkpoint and --history (couette_flow also --vtk): the same files,
  whose fields agree to 1e-8 of their scale (the solver slices' parity
  tolerance, tests/test_torch_simple.py); pressure's scale is the
  larger of its own and rho |u|^2, since on the streamwise-periodic
  channels the pressure is roundoff around zero; the text files, which
  print 7 significant digits, to 1e-6 of scale; the histories' vel_avg
  at rtol 1e-6 (atol 1e-12 of its largest value);
- `info` prints orc_tpu's lines; `init-case` orc_tpu's text; `plot`
  writes its PNGs (matplotlib on the CPU) and write_analytical_profile
  orc_tpu's text;
- `run --devices 2 --device cpu` runs the case over two partitions on
  the CPU, equal to orc_tpu's `--devices 2` over two of its virtual CPU
  devices (and to the port's own one-device run) at 1e-8 of scale;
- bench.build_case is the repository bench.py's case;
- two subprocesses: `python -m orc_tpu_torch run` without `--device cpu`
  exits non-zero with the no-GPU message (where there is no GPU), and a
  whole `run --device cpu` loads no jax or orc_tpu module.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import chip_smoke

from orc_tpu.cli import main as j_main
from orc_tpu.io.data import read_data as j_read_data

from orc_tpu_torch.cli import main as t_main
from orc_tpu_torch.io.data import read_data
from orc_tpu_torch.io.vtk import read_vtk_cell_data
from orc_tpu_torch.utils.config import load_case

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = sorted(p.stem for p in (REPO / "examples").glob("*.toml"))
TOL = 1e-8
TEXT_TOL = 1e-6


def shrunk_case(name, out):
    """Path of a shrunk copy of examples/<name>.toml writing into `out`."""
    out.mkdir(parents=True, exist_ok=True)
    text = (REPO / "examples" / f"{name}.toml").read_text()
    case = out / "case.toml"
    case.write_text(chip_smoke().case_copy(
        text, out, iterations=3, steps=2, inner=3,
        cap=8 if name == "cavity_3d" else 16, levels=2,
    ))
    return case


def _scale_close(a, b, tol, scale, name):
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale, err_msg=name)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", EXAMPLES)
def test_run_matches_orc_tpu(name, tmp_path):
    jcase, tcase = shrunk_case(name, tmp_path / "jax"), shrunk_case(name, tmp_path / "torch")
    for pkg, case in (("jax", jcase), ("torch", tcase)):
        argv = ["run", str(case), "--history", str(case.parent / "history.npz")]
        if name == "couette_flow":
            argv += ["--vtk", str(case.parent / "solution.vtk")]
        if pkg == "jax":
            assert j_main(argv) == 0
        else:
            assert t_main(argv + ["--device", "cpu"]) == 0
    j_out, t_out = jcase.parent, tcase.parent
    assert sorted(p.name for p in t_out.iterdir()) == sorted(p.name for p in j_out.iterdir())
    cj, ct = _npz(j_out / "checkpoint.npz"), _npz(t_out / "checkpoint.npz")
    assert sorted(ct) == sorted(cj)
    assert ct["mesh_fingerprint"] == cj["mesh_fingerprint"] and ct["iteration"] == cj["iteration"]
    rho = load_case(str(tcase)).rho
    u_scale = float(np.abs(cj["vel"]).max())
    scales = dict(vel=u_scale, mom_diag=float(np.abs(cj["mom_diag"]).max()),
                  p=max(float(np.abs(cj["p"]).max()), rho * u_scale**2))
    for key in sorted(ct):
        if key in ("mesh_fingerprint", "iteration"):
            continue
        assert ct[key].dtype == cj[key].dtype and ct[key].shape == cj[key].shape, key
        scale = scales.get(key, float(np.abs(cj[key]).max()))
        _scale_close(ct[key], cj[key], TOL, scale, key)
    case = load_case(str(tcase))
    vt, pt = read_data(case.data_file)
    vj, pj = j_read_data(str(j_out / Path(case.data_file).name))
    _scale_close(vt, vj, TEXT_TOL, scales["vel"], "data vel")
    _scale_close(pt, pj, TEXT_TOL, scales["p"], "data p")
    if case.gradients_file:
        rows = [Path(d, Path(case.gradients_file).name).read_text() for d in (t_out, j_out)]
        gt, gj = (np.array([[float(x) for x in line.replace("(", "").replace(")", "")
                             .replace("\t", ", ").split(", ")] for line in r.splitlines()]) for r in rows)
        _scale_close(gt, gj, TEXT_TOL, float(np.abs(gj).max()), "gradients")
    if name == "couette_flow":
        dt, dj = (read_vtk_cell_data(str(d / "solution.vtk")) for d in (t_out, j_out))
        _scale_close(dt["velocity"], dj["velocity"], TOL, scales["vel"], "vtk velocity")
        _scale_close(dt["pressure"], dj["pressure"], TOL, scales["p"], "vtk pressure")
    hj, ht = _npz(j_out / "history.npz"), _npz(t_out / "history.npz")
    assert sorted(ht) == sorted(hj)
    a = hj["vel_avg"].astype(np.float64)
    np.testing.assert_allclose(ht["vel_avg"], a, rtol=1e-6, atol=1e-12 * np.abs(a).max())
    assert not ht["diverged"].any()


def test_info_prints_orc_tpus_lines(tmp_path, capsys):
    from orc_tpu_torch.mesh.generate import write_tgrid

    path = tmp_path / "box.msh"
    write_tgrid(str(path), 5, 4, 2, lengths=(2.0, 1.0, 0.5))
    assert j_main(["info", str(path)]) == 0
    want = capsys.readouterr().out
    assert t_main(["info", str(path), "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and "total volume" in got


def test_init_case_text(capsys):
    assert j_main(["init-case"]) == 0
    want = capsys.readouterr().out
    assert t_main(["init-case"]) == 0
    assert capsys.readouterr().out == want


def test_plot_writes_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    from orc_tpu.plotting import write_analytical_profile as j_profile
    from orc_tpu.models.channel_flow import ChannelFlowParameters as JParams

    from orc_tpu_torch.io.data import write_face_velocities
    from orc_tpu_torch.mesh.generate import structured_box_mesh
    from orc_tpu_torch.models.channel_flow import ChannelFlowParameters
    from orc_tpu_torch.plotting import write_analytical_profile

    case = shrunk_case("couette_flow", tmp_path)
    assert t_main(["run", str(case), "--device", "cpu"]) == 0
    root = tmp_path / "couette_flow"
    params = dict(top_wall_velocity=5e-4, dp_dx=10.0)
    write_analytical_profile(str(root) + "_analytical.csv", ChannelFlowParameters(**params))
    j_profile(str(tmp_path / "j_analytical.csv"), JParams(**params))
    assert Path(str(root) + "_analytical.csv").read_text() == (tmp_path / "j_analytical.csv").read_text()
    mesh, _ = structured_box_mesh(6, 4, 1, device="cpu")
    faces = [tmp_path / f"faces{i}.txt" for i in range(2)]
    for i, f in enumerate(faces):
        fv = torch.zeros((mesh.n_faces, 3), dtype=torch.float64)
        fv[:, 0] = mesh.face_centroid[:, 1] * (i + 1)
        write_face_velocities(str(f), mesh, fv)
    out = tmp_path / "plots"
    assert t_main(["plot", str(root) + ".csv", "-f", *map(str, faces), "--out-dir", str(out),
                   "--title", "couette"]) == 0
    names = sorted(p.name for p in out.iterdir())
    assert names == ["couette_flow_contour_plots.png", "couette_flow_velocity_profile.png",
                     "face_velocities.png"]
    assert all((out / n).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" for n in names)
    assert t_main(["plot", str(tmp_path / "absent.csv")]) == 2
    assert t_main(["plot"]) == 2


def test_devices_beyond_one_raise(tmp_path):
    """`--devices 2`, which once raised, runs sharded: beside orc_tpu's
    CLI over two of its virtual devices, and beside the port's own
    single-device run (the name is kept from then)."""
    runs = {}
    for tag, main, extra in (
        ("jax", j_main, []),
        ("torch", t_main, ["--device", "cpu"]),
        ("one", t_main, ["--device", "cpu", "--devices", "1"]),
    ):
        case = shrunk_case("cavity", tmp_path / tag)
        devices = [] if tag == "one" else ["--devices", "2"]
        assert main(["run", str(case), *devices, *extra]) == 0
        runs[tag] = _npz(tmp_path / tag / "checkpoint.npz")
    ref = runs["jax"]
    u_scale = float(np.abs(ref["vel"]).max())
    for tag in ("torch", "one"):
        _scale_close(runs[tag]["vel"], ref["vel"], TOL, u_scale, f"{tag} vel")
        _scale_close(
            runs[tag]["p"], ref["p"], TOL, max(float(np.abs(ref["p"]).max()), u_scale**2),
            f"{tag} p",
        )


def test_missing_files_exit_2(tmp_path):
    assert t_main(["run", str(tmp_path / "absent.toml"), "--device", "cpu"]) == 2
    case = shrunk_case("cavity", tmp_path)
    case.write_text(chip_smoke().case_copy(case.read_text(), tmp_path, mesh=tmp_path / "absent.msh"))
    assert t_main(["run", str(case), "--device", "cpu"]) == 2


def test_bench_case_is_bench_py():
    spec = importlib.util.spec_from_file_location("repo_bench", REPO / "bench.py")
    repo_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(repo_bench)
    from orc_tpu_torch import bench

    mj, tj = repo_bench.build_case()
    mt, tt = bench.build_case("cpu")
    np.testing.assert_array_equal(mt.cell_centroid.numpy(), np.asarray(mj.cell_centroid))
    np.testing.assert_array_equal(tt.codes, tj.codes)
    np.testing.assert_array_equal(tt.scalar, tj.scalar)
    np.testing.assert_array_equal(tt.vector, tj.vector)
    assert bench.U_MEAN_ANALYTICAL == 5e-4 / 2 + 1e-3**2 / (12 * 0.001) * 10.0


def _subprocess(code, tmp_path):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO)),
    )


def test_run_without_device_cpu_fails_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU message cannot show")
    case = shrunk_case("cavity", tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "orc_tpu_torch", "run", str(case)], cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "no CUDA GPU is available" in out.stderr and "device='cpu'" in out.stderr
    assert not (tmp_path / "cavity.csv").exists()


def test_run_imports_no_jax(tmp_path):
    """A whole `run --device cpu` (text, gradients, checkpoint, VTK and
    history) loads no jax or orc_tpu module."""
    case = shrunk_case("couette_flow", tmp_path)
    code = (
        "import sys\n"
        "import orc_tpu_torch.parallel\n"
        "from orc_tpu_torch.cli import main\n"
        f"rc = main(['run', {str(case)!r}, '--vtk', 'x.vtk', '--history', 'h.npz', '--device', 'cpu'])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'orc_tpu.')) or m == 'orc_tpu')\n"
        "assert rc == 0 and not bad, (rc, bad)\n"
        "print('ok')\n"
    )
    out = _subprocess(code, tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    assert (tmp_path / "x.vtk").exists() and (tmp_path / "couette_flow_gradients.csv").exists()
