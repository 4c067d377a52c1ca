"""The port's I/O (orc_tpu_torch/io/) against orc_tpu's on the CPU.

- Text files (write_data, write_gradients, write_face_velocities) and
  VTK files (2-D polygons, 3-D polyhedra) are byte-identical to
  orc_tpu's for the same arrays, on a box, a TGRID box and a TGRID box
  with relabelled cells (RCM order: rows in raw order), in float32 and
  float64; read_data and read_vtk_cell_data give equal arrays.
- mesh_fingerprint is equal, in float32 and float64.
- Checkpoints cross both ways with equal arrays (bit for bit, at the
  mesh dtype): orc_tpu writes and the port reads, the port writes and
  orc_tpu reads, with a TurbState, the SIMPLE_FC flux as [C,K] and as
  [F], and a legacy [C,3] mom_diag.
- load_or_initialize in its three arms: npz and text equal bit for bit,
  fresh within 1e-12 of orc_tpu's initialize_flow (float64, the
  tolerance of tests/test_torch_init_fields.py).
- The io/debug.py strings are identical.
"""

import numpy as np
import pytest
import torch

from torch_parity import np_, relabelled_tgrid, tgrid_2d, _channel

import jax.numpy as jnp
from orc_tpu.io import checkpoint as jck, data as jdata, debug as jdebug, vtk as jvtk
from orc_tpu.mesh import read_mesh as j_read_mesh
from orc_tpu.mesh.generate import structured_box_mesh as j_box, write_tgrid as j_write_tgrid
from orc_tpu.ops.spmv import EllMatrix as JEll
from orc_tpu.solver.simple import FlowState as JFlowState
from orc_tpu.solver.turbulence import TurbState as JTurbState

from orc_tpu_torch.interop import flow_state_from_numpy, turb_state_from_numpy
from orc_tpu_torch.io import checkpoint as tck, data as tdata, debug as tdebug, vtk as tvtk
from orc_tpu_torch.mesh import read_mesh as t_read_mesh
from orc_tpu_torch.mesh.generate import structured_box_mesh as t_box
from orc_tpu_torch.mesh.tgrid import parse_tgrid
from orc_tpu_torch.ops.spmv import EllMatrix as TEll

DT = {"f32": (jnp.float32, torch.float32, np.float32), "f64": (jnp.float64, torch.float64, np.float64)}


def meshes(kind, dtype, tmp_path):
    """(orc_tpu mesh, port mesh) of one mesh kind in one dtype."""
    jd, td, _ = DT[dtype]
    if kind == "box":
        kw = dict(lengths=(2.0, 1.0, 0.1))
        return j_box(6, 5, 1, dtype=jd, **kw)[0], t_box(6, 5, 1, dtype=td, device="cpu", **kw)[0]
    if kind == "tgrid":
        path = tmp_path / "box.msh"
        j_write_tgrid(str(path), 4, 3, 2, lengths=(1.0, 0.7, 0.4))
    else:
        path = relabelled_tgrid(tmp_path, 7, seed=4)
    mj, _ = j_read_mesh(str(path), dtype=jd, native=False)
    mt, _ = t_read_mesh(str(path), dtype=td, native=False, device="cpu")
    assert (mt.cell_order is not None) == (kind == "relabelled")
    return mj, mt


KINDS = ["box", "tgrid", "relabelled"]


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("kind", KINDS)
def test_text_files_byte_identical(tmp_path, kind, dtype):
    mj, mt = meshes(kind, dtype, tmp_path)
    C, F = mt.n_cells, mt.n_faces
    npd = DT[dtype][2]
    rng = np.random.default_rng(7)
    vel, p = rng.standard_normal((C, 3)).astype(npd), rng.standard_normal(C).astype(npd)
    gv, gp = rng.standard_normal((C, 3, 3)).astype(npd), rng.standard_normal((C, 3)).astype(npd)
    fv = rng.standard_normal((F, 3)).astype(npd)
    t = torch.from_numpy
    writes = {
        "data": (jdata.write_data, tdata.write_data, (vel, p)),
        "gradients": (jdata.write_gradients, tdata.write_gradients, (gv, gp)),
        "faces": (jdata.write_face_velocities, tdata.write_face_velocities, (fv,)),
    }
    for name, (jwrite, twrite, arrays) in writes.items():
        a, b = tmp_path / f"{name}.j", tmp_path / f"{name}.t"
        jwrite(str(a), mj, *arrays)
        twrite(str(b), mt, *(t(x) for x in arrays))
        assert a.read_bytes() == b.read_bytes(), name
    # read_data: both readers give the same float64 arrays.
    vj, pj = jdata.read_data(str(tmp_path / "data.j"))
    vt, pt = tdata.read_data(str(tmp_path / "data.t"))
    np.testing.assert_array_equal(vj, vt)
    np.testing.assert_array_equal(pj, pt)
    if kind == "relabelled":  # rows in raw order, not the compiled order
        order = np_(mt.cell_order)
        np.testing.assert_allclose(vt[order], vel, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("kind", KINDS)
def test_mesh_fingerprint_equal(tmp_path, kind, dtype):
    mj, mt = meshes(kind, dtype, tmp_path)
    assert tck.mesh_fingerprint(mt) == jck.mesh_fingerprint(mj)


def _fields(C, K, F, npd, flux, seed=5):
    rng = np.random.default_rng(seed)
    f = dict(
        vel=rng.standard_normal((C, 3)), p=rng.standard_normal(C),
        mom_diag=rng.uniform(0.5, 2.0, (3, C)),
        k=rng.uniform(0.1, 1.0, C), eps=rng.uniform(0.1, 1.0, C), mu_t=rng.uniform(0.0, 1e-3, C),
    )
    if flux == "ck":
        f["flux"] = rng.standard_normal((C, K))
    elif flux == "face":
        f["flux"] = rng.standard_normal(F)
    return {k: v.astype(npd) for k, v in f.items()}


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("kind,flux", [("box", "ck"), ("relabelled", "face"), ("tgrid", None)])
def test_checkpoints_cross_both_ways(tmp_path, kind, flux, dtype):
    mj, mt = meshes(kind, dtype, tmp_path)
    f = _fields(mt.n_cells, mt.max_faces_per_cell, mt.n_faces, DT[dtype][2], flux)
    jstate = JFlowState(vel=jnp.asarray(f["vel"]), p=jnp.asarray(f["p"]),
                        mom_diag=jnp.asarray(f["mom_diag"]),
                        flux=jnp.asarray(f["flux"]) if flux else None)
    jturb = JTurbState(k=jnp.asarray(f["k"]), eps=jnp.asarray(f["eps"]), mu_t=jnp.asarray(f["mu_t"]))
    tstate = flow_state_from_numpy(f["vel"], f["p"], f["mom_diag"], f.get("flux"), device="cpu")
    tturb = turb_state_from_numpy(f["k"], f["eps"], f["mu_t"], device="cpu")

    def check(state, turb, it, expect_it):
        assert it == expect_it
        for name in ("vel", "p", "mom_diag"):
            np.testing.assert_array_equal(np_(getattr(state, name)), f[name])
        if flux:
            np.testing.assert_array_equal(np_(state.flux), f["flux"])
        else:
            assert state.flux is None
        for name in ("k", "eps", "mu_t"):
            np.testing.assert_array_equal(np_(getattr(turb, name)), f[name])

    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_checkpoint(jpath, mj, jstate, 17, turb=jturb)
    tck.save_checkpoint(tpath, mt, tstate, 17, turb=tturb)
    with np.load(jpath) as zj, np.load(tpath) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for key in zj.files:
            assert zj[key].dtype == zt[key].dtype and zj[key].shape == zt[key].shape, key
            np.testing.assert_array_equal(zj[key], zt[key])
    check(*tck.load_checkpoint(jpath, mt, with_turbulence=True), 17)  # orc_tpu -> port
    check(*jck.load_checkpoint(tpath, mj, with_turbulence=True), 17)  # port -> orc_tpu
    st, it = tck.load_checkpoint(jpath, mt)
    assert it == 17 and st.vel.dtype == mt.dtype
    # A mesh mismatch is refused in both directions.
    other_j, other_t = meshes("box" if kind != "box" else "tgrid", dtype, tmp_path)
    with pytest.raises(ValueError, match="different mesh"):
        tck.load_checkpoint(jpath, other_t)
    with pytest.raises(ValueError, match="different mesh"):
        jck.load_checkpoint(tpath, other_j)


def test_legacy_row_major_mom_diag(tmp_path):
    """A checkpoint written before the component-major layout ([C,3]
    mom_diag) loads as [3,C] in both packages."""
    mj, mt = meshes("box", "f64", tmp_path)
    f = _fields(mt.n_cells, 6, mt.n_faces, np.float64, None)
    path = tmp_path / "legacy.npz"
    np.savez_compressed(
        path, vel=f["vel"], p=f["p"], mom_diag=f["mom_diag"].T.copy(), iteration=np.int64(3),
        mesh_fingerprint=np.bytes_(jck.mesh_fingerprint(mj).encode()),
    )
    st, it = tck.load_checkpoint(str(path), mt)
    sj, _ = jck.load_checkpoint(str(path), mj)
    assert it == 3 and tuple(st.mom_diag.shape) == (3, mt.n_cells)
    np.testing.assert_array_equal(np_(st.mom_diag), f["mom_diag"])
    np.testing.assert_array_equal(np_(st.mom_diag), np_(sj.mom_diag))


def test_load_or_initialize_three_arms(tmp_path):
    # npz: the checkpoint's fields; text: the data file's rows mapped
    # from raw order into the RCM order, mom_diag ones.
    mj, mt = meshes("relabelled", "f64", tmp_path)
    f = _fields(mt.n_cells, 6, mt.n_faces, np.float64, None)
    jstate = JFlowState(vel=jnp.asarray(f["vel"]), p=jnp.asarray(f["p"]), mom_diag=jnp.asarray(f["mom_diag"]))
    npz, txt = str(tmp_path / "s.npz"), str(tmp_path / "s.csv")
    jck.save_checkpoint(npz, mj, jstate)
    jdata.write_data(txt, mj, jstate.vel, jstate.p)
    for path in (npz, txt):
        sj = jck.load_or_initialize(path, mj, None, 1e-3, 1.0)
        st = tck.load_or_initialize(path, mt, None, 1e-3, 1.0)
        for name in ("vel", "p", "mom_diag"):
            np.testing.assert_array_equal(np_(getattr(st, name)), np_(getattr(sj, name)))
    np.testing.assert_array_equal(np_(st.mom_diag), 1.0)
    np.testing.assert_allclose(np_(st.vel), f["vel"], rtol=1e-6)  # 7 digits of text
    bad = tmp_path / "short.csv"
    with open(txt) as fh:
        bad.write_text("".join(fh.readlines()[:-1]))
    with pytest.raises(ValueError, match="cells"):
        tck.load_or_initialize(str(bad), mt, None, 1e-3, 1.0)
    # fresh: initialize_flow on a velocity-inlet channel.
    (mj, tj), (mt, tt) = _channel("jax", jnp.float64, True), _channel("torch", torch.float64, True)
    sj = jck.load_or_initialize(None, mj, tj, 1e-3, 1000.0)
    st = tck.load_or_initialize(str(tmp_path / "absent.npz"), mt, tt, 1e-3, 1000.0)
    for name in ("vel", "p", "mom_diag"):
        a, b = np_(getattr(st, name)), np_(getattr(sj, name))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * max(np.abs(b).max(), 1e-300))
    assert np.abs(np_(st.vel)).max() > 0  # the inlet's flow, not zeros


@pytest.mark.parametrize("dim", [2, 3])
def test_vtk_byte_identical(tmp_path, dim):
    if dim == 2:
        path = str(tgrid_2d(tmp_path / "quad.msh", 4, 3))
    else:
        path = str(tmp_path / "hex.msh")
        j_write_tgrid(path, 3, 3, 2, lengths=(1.0, 1.0, 0.5))
    with open(path) as fh:
        C = parse_tgrid(fh.read()).n_cells
    rng = np.random.default_rng(dim)
    s, v = rng.standard_normal(C), rng.standard_normal((C, 3))
    jvtk.write_vtk(str(tmp_path / "j.vtk"), path, cell_data={"s": s, "velocity": v})
    tvtk.write_vtk(str(tmp_path / "t.vtk"), path, cell_data={"s": torch.from_numpy(s), "velocity": v})
    assert (tmp_path / "j.vtk").read_bytes() == (tmp_path / "t.vtk").read_bytes()
    # write_solution_vtk of the same state, float32 fields widened alike.
    f = _fields(C, 6, 1, np.float32, None)
    jvtk.write_solution_vtk(str(tmp_path / "js.vtk"), path,
                            JFlowState(vel=jnp.asarray(f["vel"]), p=jnp.asarray(f["p"]), mom_diag=None))
    tvtk.write_solution_vtk(str(tmp_path / "ts.vtk"), path,
                            flow_state_from_numpy(f["vel"], f["p"], f["mom_diag"], device="cpu"))
    assert (tmp_path / "js.vtk").read_bytes() == (tmp_path / "ts.vtk").read_bytes()
    dj, dt = jvtk.read_vtk_cell_data(str(tmp_path / "js.vtk")), tvtk.read_vtk_cell_data(str(tmp_path / "ts.vtk"))
    assert sorted(dj) == sorted(dt) == ["pressure", "velocity"]
    for key in dj:
        np.testing.assert_array_equal(dj[key], dt[key])
    np.testing.assert_array_equal(dt["velocity"], f["vel"].astype(np.float64))
    with pytest.raises(ValueError, match="entries for"):
        tvtk.write_vtk(str(tmp_path / "bad.vtk"), path, {"x": np.zeros(C + 1)})


@pytest.mark.parametrize("n,structured", [(6, True), (6, False), (20, True), (20, False)])
def test_debug_strings_identical(n, structured):
    rng = np.random.default_rng(n)
    offsets = (-1, 1, -5, 5)
    c = np.arange(n)
    off = rng.uniform(-1.0, 0.0, (n, 4))
    for k, d in enumerate(offsets):
        off[(c + d < 0) | (c + d >= n), k] = 0.0
    diag = 1.0 + rng.random(n)
    nbr = np.clip(c[:, None] + np.array(offsets)[None, :], 0, n - 1).astype(np.int32)
    b = rng.standard_normal(n)
    jn, tn = (None, None) if structured else (jnp.asarray(nbr), torch.from_numpy(nbr))
    A_j = JEll(jnp.asarray(diag), jnp.asarray(off), jn, offsets)
    A_t = TEll(torch.from_numpy(diag), torch.from_numpy(off), tn, offsets)
    assert tdebug.ell_to_string(A_t) == jdebug.ell_to_string(A_j)
    assert tdebug.linear_system_to_string(A_t, torch.from_numpy(b)) == jdebug.linear_system_to_string(A_j, b)
    assert tdebug.vector_to_string(torch.from_numpy(b)) == jdebug.vector_to_string(b)
    if structured:  # the port's split columns print the same matrix
        assert tdebug.ell_to_string(A_t.split_columns()) == jdebug.ell_to_string(A_j)
