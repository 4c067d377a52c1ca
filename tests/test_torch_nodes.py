"""Node-based Green-Gauss in the port (orc_tpu_torch/mesh/nodes.py, the
GG-node branches of ops/gradients.py, compile_mesh / read_mesh with
nodes=True) against orc_tpu on the CPU (float64).

- The vertex tables of TGRID boxes read with nodes=True: a structured
  7x5 box and the same box with its cells relabelled (RCM order and a
  slice plan, so the tables are remapped through cell_order). orc_tpu
  fills each node's row from a Python set and the port sorts it, so rows
  are compared as (cell, weight) sets, weights at 1e-14;
  node_face_values at rtol 1e-12.
- Both gradients with GREEN_GAUSS_NODE at tests/test_gradients.py's
  tolerances (rtol 1e-10, atol 1e-12), and that file's exactness case
  for linear fields on interior cells.
- One steady GG-node solve per iteration (use_ck="auto", which takes the
  face-major step): rtol 1e-6, equal inner counts.
- The rules of orc_tpu's drivers, exact: use_ck=True with GG node raises
  ValueError; the single-device transient driver under "auto" and the
  RANS driver take the (c,k) step, which computes Green-Gauss cell
  gradients, so GG node there equals GG cell bit for bit (a reference
  quirk, ROADMAP Queue 3); a periodic mesh (merged face pairs) raises
  ValueError, as orc_tpu's shape mismatch does.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import np_, to_jax_settings

import jax.numpy as jnp
from orc_tpu.mesh import read_mesh as j_read_mesh
from orc_tpu.mesh.nodes import node_face_values as j_node_face_values
from orc_tpu.mesh.zones import FaceCondition as JFaceCondition
from orc_tpu.ops import fields as jfields
from orc_tpu.ops import gradients as jgrad
from orc_tpu.solver import simple as js

from orc_tpu_torch.interop import (
    MESH_FIELDS,
    NODE_TABLES,
    compiled_mesh_from_numpy,
    node_interp_from_numpy,
)
from orc_tpu_torch.mesh.compile import trim_for_ck
from orc_tpu_torch.mesh.generate import write_tgrid
from orc_tpu_torch.mesh.nodes import node_face_values
from orc_tpu_torch.mesh.tgrid import read_mesh
from orc_tpu_torch.mesh.zones import FaceCondition
from orc_tpu_torch.ops import fields as tfields
from orc_tpu_torch.ops import gradients as tgrad
from orc_tpu_torch.solver import simple as ts
from orc_tpu_torch.utils import settings as tset

REPO = Path(__file__).resolve().parent.parent
GG_NODE = tset.GradientReconstruction.GREEN_GAUSS_NODE


def smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _box_file(tmp_path, name, nx=7, ny=5, nz=1, permuted=False, **kw):
    path = tmp_path / f"{name}.msh"
    write_tgrid(str(path), nx, ny, nz, **kw)
    if permuted:
        out = tmp_path / f"{name}-permuted.msh"
        smoke_module().permuted_tgrid(str(path), str(out), seed=3)
        path = out
    return str(path)


def _both(path):
    mj, tj = j_read_mesh(path, nodes=True, native=False)
    mt, tt = read_mesh(path, nodes=True, device="cpu")
    return (mj, tj), (mt, tt)


def _face_bcs(mj, tj, mt, tt):
    zj = jfields.device_bc(tj, dtype=mj.dtype)
    zt = tfields.device_bc(tt, dtype=mt.dtype, device="cpu")
    return jfields.face_bc(mj, *zj), tfields.face_bc(mt, *zt)


@pytest.mark.parametrize("permuted", [False, True], ids=["box", "permuted"])
def test_node_tables_match_orc_tpu(tmp_path, permuted):
    (mj, _), (mt, _) = _both(_box_file(tmp_path, "b", permuted=permuted))
    assert (mt.cell_order is not None) == permuted
    if permuted:
        np.testing.assert_array_equal(np_(mt.cell_order), np.asarray(mj.cell_order))
    nj, nt = mj.nodes, mt.nodes
    assert nt.node_cells.dtype == torch.int32 and nt.face_nodes.dtype == torch.int32
    for name in ("node_cells", "node_w", "face_nodes", "face_node_w"):
        assert tuple(getattr(nt, name).shape) == tuple(getattr(nj, name).shape), name
    for a, b in (("node_cells", "node_w"), ("face_nodes", "face_node_w")):
        ij, wj = np.asarray(getattr(nj, a)), np.asarray(getattr(nj, b))
        it, wt = np_(getattr(nt, a)), np_(getattr(nt, b))
        for r in range(ij.shape[0]):
            want = {int(c): w for c, w in zip(ij[r], wj[r]) if w != 0.0}
            got = {int(c): w for c, w in zip(it[r], wt[r]) if w != 0.0}
            assert want.keys() == got.keys(), (a, r)
            np.testing.assert_allclose(
                [got[c] for c in want], list(want.values()), rtol=1e-14, atol=0
            )
    rng = np.random.default_rng(4)
    for shape in ((mj.n_cells,), (mj.n_cells, 3)):
        phi = rng.standard_normal(shape)
        np.testing.assert_allclose(
            np_(node_face_values(nt, torch.tensor(phi))),
            np.asarray(j_node_face_values(nj, jnp.asarray(phi))),
            rtol=1e-12, atol=1e-12 * np.abs(phi).max(),
        )


@pytest.mark.parametrize("permuted", [False, True], ids=["box", "permuted"])
def test_gg_node_gradients_match_orc_tpu(tmp_path, permuted):
    path = _box_file(tmp_path, "g", 6, 5, 3, permuted=permuted, lengths=(3.0, 2.0, 1.5))
    (mj, tj), (mt, tt) = _both(path)
    for table, fc in ((tj, JFaceCondition), (tt, FaceCondition)):
        table.set("INLET", fc.VELOCITY_INLET, vector_value=(0.7, 0.1, -0.2))
        table.set("OUTLET", fc.PRESSURE_OUTLET, scalar_value=0.3)
    fj, ft = _face_bcs(mj, tj, mt, tt)
    rng = np.random.default_rng(7)
    p = rng.standard_normal(mj.n_cells)
    vel = rng.standard_normal((mj.n_cells, 3))
    jnode = to_jax_settings(GG_NODE)
    np.testing.assert_allclose(
        np_(tgrad.pressure_gradient(mt, ft, torch.tensor(p), GG_NODE)),
        np.asarray(jgrad.pressure_gradient(mj, fj, jnp.asarray(p), jnode)),
        rtol=1e-10, atol=1e-12,
    )
    np.testing.assert_allclose(
        np_(tgrad.velocity_gradient(mt, ft, torch.tensor(vel), GG_NODE)),
        np.asarray(jgrad.velocity_gradient(mj, fj, jnp.asarray(vel), jnode)),
        rtol=1e-10, atol=1e-12,
    )


def test_gg_node_exact_for_linear_fields_on_interior_cells(tmp_path):
    """tests/test_gradients.py::test_node_gg_exact_linear_interior on the
    port."""
    path = _box_file(tmp_path, "lin", 5, 4, 3, lengths=(5.0, 2.0, 1.5))
    mesh, table = read_mesh(path, nodes=True, device="cpu")
    zc, zs, zv = tfields.device_bc(table, dtype=mesh.dtype, device="cpu")
    fbc = tfields.face_bc(mesh, zc, zs, zv)
    cc = np_(mesh.cell_centroid)
    g_true = np.array([0.7, -1.3, 2.1])
    grad = np_(tgrad.pressure_gradient(mesh, fbc, torch.tensor(cc @ g_true), GG_NODE))
    fint = np_(mesh.face_interior)[np_(mesh.cell_faces)] | ~np_(mesh.cell_face_mask)
    inner = fint.all(axis=1)
    assert inner.sum() >= 6
    np.testing.assert_allclose(
        grad[inner], np.tile(g_true, (int(inner.sum()), 1)), rtol=1e-10, atol=1e-12
    )
    G = np.array([[0.5, 0.0, -0.25], [1.0, 2.0, 3.0], [0.0, -1.0, 0.5]])
    gv = np_(tgrad.velocity_gradient(mesh, fbc, torch.tensor(cc @ G.T), GG_NODE))
    np.testing.assert_allclose(
        gv[inner], np.broadcast_to(G, (int(inner.sum()), 3, 3)), rtol=1e-10, atol=1e-12
    )


def test_gg_node_requires_vertex_tables(tmp_path):
    mesh, table = read_mesh(_box_file(tmp_path, "plain", 3, 3), device="cpu")
    assert mesh.nodes is None
    zc, zs, zv = tfields.device_bc(table, dtype=mesh.dtype, device="cpu")
    fbc = tfields.face_bc(mesh, zc, zs, zv)
    with pytest.raises(ValueError, match="nodes=True"):
        tgrad.pressure_gradient(mesh, fbc, torch.zeros(mesh.n_cells, dtype=mesh.dtype), GG_NODE)


def test_gg_node_on_a_periodic_mesh_raises_as_orc_tpu(tmp_path):
    """compile_mesh merges periodic face pairs, so the raw face-node table
    has more rows than the mesh has faces: orc_tpu's select raises
    ValueError on the shapes, and so does the port."""
    path = _box_file(tmp_path, "per", 6, 4, periodic=("x",))
    (mj, tj), (mt, tt) = _both(path)
    assert mt.nodes.face_nodes.shape[0] > mt.n_faces
    fj, ft = _face_bcs(mj, tj, mt, tt)
    with pytest.raises(ValueError):
        jgrad.pressure_gradient(mj, fj, jnp.zeros(mj.n_cells), to_jax_settings(GG_NODE))
    with pytest.raises(ValueError, match="periodic"):
        tgrad.pressure_gradient(mt, ft, torch.zeros(mt.n_cells, dtype=mt.dtype), GG_NODE)


def test_interop_carries_the_node_tables(tmp_path):
    (mj, _), (mt, _) = _both(_box_file(tmp_path, "io", permuted=True))
    nodes = node_interp_from_numpy(
        {name: np.asarray(getattr(mj.nodes, name)) for name in NODE_TABLES}, device="cpu"
    )
    back = compiled_mesh_from_numpy(
        {name: np.asarray(getattr(mj, name)) for name in MESH_FIELDS},
        None, None, mj.dim, device="cpu", cell_order=np.asarray(mj.cell_order),
        slice_plan=mt.slice_plan, nodes=nodes,
    )
    phi = torch.tensor(np.random.default_rng(2).standard_normal(mt.n_cells))
    np.testing.assert_allclose(
        np_(node_face_values(back.nodes, phi)), np_(node_face_values(mt.nodes, phi)),
        rtol=1e-12, atol=1e-14,
    )
    assert trim_for_ck(mt).nodes is None


# --- the drivers --------------------------------------------------------


def _cavity_file(tmp_path, n=10, permuted=False):
    path = _box_file(tmp_path, "cav", n, n, permuted=permuted)
    (mj, tj), (mt, tt) = _both(path)
    for table, fc in ((tj, JFaceCondition), (tt, FaceCondition)):
        table.set("TOP_WALL", fc.WALL, vector_value=(1.0, 0.0, 0.0))
        table.set("PERIODIC_-Z", fc.SYMMETRY)
        table.set("PERIODIC_+Z", fc.SYMMETRY)
    return (mj, tj), (mt, tt)


def _node_settings():
    from orc_tpu_torch.models.cavity import default_settings

    return default_settings().replace(
        gradient_reconstruction=GG_NODE,
        momentum=tset.MomentumScheme.TVD_DC,
        tvd_psi=tset.tvd_umist,
    )


@pytest.mark.parametrize("permuted", [False, True], ids=["box", "permuted"])
def test_gg_node_steady_solve_tracks_orc_tpu(tmp_path, monkeypatch, permuted):
    """GG node under use_ck="auto" takes the face-major step in both
    packages (TVD_DC reads the node-based velocity gradient), 15
    iterations."""
    (mj, tj), (mt, tt) = _cavity_file(tmp_path, permuted=permuted)
    settings = _node_settings()
    kw = dict(iterations=15, reporting_interval=15, verbose=False)
    built = []
    real = ts.build_ck_geometry
    monkeypatch.setattr(ts, "build_ck_geometry", lambda *a: built.append(1) or real(*a))
    st, ht = ts.solve_steady(mt, tt, settings, 1.0, 0.01, **kw)
    assert not built
    sj, hj = js.solve_steady(mj, tj, to_jax_settings(settings), 1.0, 0.01, **kw)
    hj, ht = js.stack_history(hj), ts.stack_history(ht)
    for f in hj._fields:
        a, b = np.asarray(getattr(hj, f)), getattr(ht, f)
        if f in ("mom_iters", "pc_iters", "diverged"):
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            d = a.astype(np.float64)
            np.testing.assert_allclose(
                b, d, rtol=1e-6, atol=1e-12 * float(np.max(np.abs(d))), err_msg=f
            )
    for f in ("vel", "p"):
        d = np.asarray(getattr(sj, f))
        np.testing.assert_allclose(np_(getattr(st, f)), d, rtol=1e-8, atol=1e-8 * np.abs(d).max())


def test_use_ck_true_with_gg_node_raises_as_orc_tpu(tmp_path):
    (mj, tj), (mt, tt) = _cavity_file(tmp_path, n=4)
    settings = _node_settings()
    with pytest.raises(ValueError, match="use_ck=True"):
        js.solve_steady(mj, tj, to_jax_settings(settings), 1.0, 0.01, iterations=1,
                        verbose=False, use_ck=True)
    with pytest.raises(ValueError, match="use_ck=True"):
        ts.solve_steady(mt, tt, settings, 1.0, 0.01, iterations=1, verbose=False, use_ck=True)


def test_transient_auto_runs_gg_node_as_gg_cell(tmp_path):
    """orc_tpu's single-device transient driver picks the (c,k) step by
    the cell count alone, so GG node runs as GG cell there: the port's
    GG-node run equals its GG-cell run bit for bit and tracks orc_tpu's
    GG-node run."""
    from orc_tpu.solver import transient as jt

    from orc_tpu_torch.solver import transient as tt_

    (mj, tj), (mt, tt) = _cavity_file(tmp_path, n=8)
    node = _node_settings()
    cell = node.replace(gradient_reconstruction=tset.GradientReconstruction.GREEN_GAUSS_CELL)
    run = dict(dt=0.05, n_steps=3, inner_iterations=4, verbose=False)
    s_node, h_node = tt_.solve_transient(mt, tt, node, 1.0, 0.01, **run)
    s_cell, _ = tt_.solve_transient(mt, tt, cell, 1.0, 0.01, **run)
    assert torch.equal(s_node.vel, s_cell.vel) and torch.equal(s_node.p, s_cell.p)
    sj, hj = jt.solve_transient(mj, tj, to_jax_settings(node), 1.0, 0.01, **run)
    np.testing.assert_array_equal(np_(h_node.pc_iters), np.asarray(hj.pc_iters))
    d = np.asarray(sj.vel)
    np.testing.assert_allclose(np_(s_node.vel), d, rtol=1e-8, atol=1e-8 * np.abs(d).max())


def test_rans_runs_gg_node_as_gg_cell():
    """orc_tpu's single-device RANS driver always runs the (c,k) step,
    so GG node runs as GG cell there; the port reproduces it."""
    from test_torch_turbulence import CHANNEL_KW, SETTINGS, channel

    from orc_tpu_torch.solver.turbulence import solve_steady_turbulent

    mesh, table = channel("torch", 8, 6)
    out = []
    for grad in (GG_NODE, tset.GradientReconstruction.GREEN_GAUSS_CELL):
        flow, turb, _ = solve_steady_turbulent(
            mesh, table, SETTINGS.replace(gradient_reconstruction=grad), 1.0, 1e-5,
            iterations=3, reporting_interval=3, **CHANNEL_KW,
        )
        out.append((flow.vel, turb.k))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
