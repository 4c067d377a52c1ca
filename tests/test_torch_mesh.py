"""Port mesh (orc_tpu_torch/mesh) against orc_tpu: every CompiledMesh
field of structured_box_mesh, the static offsets and per-column
constants, the zone table, device_bc and the interop round trip; the
generic compile (compile_from_arrays) on permuted, unpermuted and graded
boxes; write_tgrid -> read_mesh -> compile_mesh, periodic axes of 2
cells included; and the entry points' CUDA default."""

import numpy as np
import pytest
import torch

from torch_parity import compiled_both, graded_arrays, np_, permuted_arrays

import jax.numpy as jnp
from orc_tpu.mesh.generate import structured_box_mesh as jbox
from orc_tpu.ops.fields import device_bc as jdevice_bc
from orc_tpu.solver.gmg import infer_box_dims as j_infer

from orc_tpu_torch.interop import MESH_FIELDS, compiled_mesh_from_numpy
from orc_tpu_torch.mesh.compile import trim_for_ck
from orc_tpu_torch.mesh.generate import structured_box_mesh as tbox
from orc_tpu_torch.ops.fields import device_bc as tdevice_bc
from orc_tpu_torch.solver.gmg import infer_box_dims as t_infer

BOXES = {
    "3x3x3": dict(nx=3, ny=3, nz=3),
    "8x8x1": dict(nx=8, ny=8, nz=1),
    "128x64x1": dict(nx=128, ny=64, nz=1, lengths=(0.002, 0.001, 0.0001)),
    "periodic-x": dict(nx=5, ny=4, nz=3, periodic=("x",)),
    "periodic-xz": dict(nx=4, ny=3, nz=3, periodic=("x", "z")),
}


def _pair(box, jdt=jnp.float64, tdt=torch.float64):
    kw = BOXES[box]
    return jbox(**kw, dtype=jdt), tbox(**kw, dtype=tdt, device="cpu")


@pytest.mark.parametrize("box", sorted(BOXES))
def test_compiled_mesh_fields_equal(box):
    """Integers and masks exactly; floats to 1e-14 (the arithmetic is
    the same numpy code, so in practice they are bit-equal)."""
    (mj, _), (mt, _) = _pair(box)
    assert MESH_FIELDS  # the port's tensor fields
    for name in MESH_FIELDS:
        a, b = np_(getattr(mj, name)), np_(getattr(mt, name))
        assert a.shape == b.shape, name
        assert a.dtype == b.dtype, name
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-14, atol=1e-14, err_msg=name)
    assert mt.dim == mj.dim
    assert mt.neighbor_offsets == mj.neighbor_offsets
    assert mt.ck_constants == mj.ck_constants


@pytest.mark.parametrize("box", sorted(BOXES))
def test_zone_table_and_device_bc_equal(box):
    (_, tj), (_, tt) = _pair(box)
    assert tt.zone_ids == tj.zone_ids
    assert tt.slot_of_zone == tj.slot_of_zone
    assert tt.codes == tj.codes
    assert [z.name for z in tt.zones.values()] == [
        z.name for z in tj.zones.values()
    ]
    for a, b in zip(jdevice_bc(tj), tdevice_bc(tt, device="cpu")):
        np.testing.assert_array_equal(np_(b), np_(a))


@pytest.mark.parametrize("box", sorted(BOXES))
def test_infer_box_dims_equal(box):
    (mj, _), (mt, _) = _pair(box)
    assert t_infer(mt.neighbor_offsets, mt.n_cells) == j_infer(
        mj.neighbor_offsets, mj.n_cells
    )


def test_float32_mesh_and_device_follow_arguments():
    (mj, _), (mt, _) = _pair("8x8x1", jnp.float32, torch.float32)
    assert mt.dtype == torch.float32 and mt.device.type == "cpu"
    np.testing.assert_array_equal(np_(mt.cell_centroid), np_(mj.cell_centroid))


def test_interop_round_trip_is_identity():
    _, (mt, _) = _pair("periodic-x")
    fields = {name: np_(getattr(mt, name)) for name in MESH_FIELDS}
    back = compiled_mesh_from_numpy(
        fields, mt.neighbor_offsets, mt.ck_constants, dim=mt.dim,
        device="cpu",
    )
    for name in MESH_FIELDS:
        a, b = getattr(mt, name), getattr(back, name)
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    assert back.neighbor_offsets == mt.neighbor_offsets
    assert back.ck_constants == mt.ck_constants


def test_interop_takes_orc_tpu_mesh():
    (mj, _), (mt, _) = _pair("3x3x3")
    fields = {name: np.asarray(getattr(mj, name)) for name in MESH_FIELDS}
    back = compiled_mesh_from_numpy(
        fields, mj.neighbor_offsets, mj.ck_constants, device="cpu"
    )
    for name in MESH_FIELDS:
        assert torch.equal(getattr(back, name), getattr(mt, name)), name


def test_trim_for_ck_keeps_cell_geometry():
    _, (mt, _) = _pair("8x8x1")
    tr = trim_for_ck(mt)
    assert tr.face_area.shape == (2,) and tr.cell_neighbors.shape == (2, 6)
    assert torch.equal(tr.cell_volume, mt.cell_volume)
    assert torch.equal(tr.cell_face_mask, mt.cell_face_mask)
    assert tr.neighbor_offsets == mt.neighbor_offsets


def _assert_meshes_equal(mj, mt):
    """Every field of two compiled meshes: integers and masks exactly,
    floats to 1e-14; the RCM order and slice plan when present."""
    for name in MESH_FIELDS + ("cell_order",):
        a, b = getattr(mj, name), getattr(mt, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        a, b = np_(a), np_(b)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-14, atol=1e-14, err_msg=name)
    assert mt.dim == mj.dim
    assert mt.neighbor_offsets == mj.neighbor_offsets
    pj, pt = mj.slice_plan, mt.slice_plan
    assert (pj is None) == (pt is None)
    if pj is not None:
        for f in ("starts", "col_of", "col_tile", "tile_nj"):
            np.testing.assert_array_equal(np_(getattr(pt, f)), np_(getattr(pj, f)), err_msg=f)
        for f in ("tile", "n_max", "pad_lo", "pad_hi", "n_cells", "j0", "n_heavy"):
            assert getattr(pt, f) == getattr(pj, f), f


def test_two_cell_periodic_axis_is_not_ported():
    """A periodic axis of 2 cells now takes the generic construction
    (compile_from_arrays), equal to orc_tpu's; 1 cell still raises."""
    mj, _ = jbox(2, 4, 3, periodic=("x",))
    mt, _ = tbox(2, 4, 3, periodic=("x",), device="cpu")
    assert mt.ck_constants is None
    _assert_meshes_equal(mj, mt)
    with pytest.raises(ValueError):
        tbox(1, 4, 3, periodic=("x",), device="cpu")


ARRAYS = {
    "permuted-13x13": lambda: permuted_arrays(13, seed=1)[0],
    "permuted-6x6x6": lambda: permuted_arrays(6, seed=2, nz=6)[0],
    "unpermuted-9x9": lambda: permuted_arrays(9, seed=None)[0],
    "graded-10x10": lambda: graded_arrays(10),
}


@pytest.mark.parametrize("case", sorted(ARRAYS))
def test_compile_from_arrays_equals_orc_tpu(case):
    mj, mt = compiled_both(ARRAYS[case]())
    assert (mt.neighbor_offsets is None) == case.startswith("permuted")
    assert mt.ck_constants is None
    _assert_meshes_equal(mj, mt)


TGRID_BOXES = {
    "4x3x1": dict(nx=4, ny=3, nz=1),
    "3x3x3": dict(nx=3, ny=3, nz=3),
    "periodic-x-2": dict(nx=2, ny=3, nz=2, periodic=("x",)),
    "periodic-xz": dict(nx=4, ny=3, nz=3, periodic=("x", "z")),
}


@pytest.mark.parametrize("box", sorted(TGRID_BOXES))
def test_tgrid_round_trip_equals_orc_tpu(box, tmp_path):
    from orc_tpu.mesh.generate import write_tgrid as jwrite
    from orc_tpu.mesh.tgrid import read_mesh as jread

    from orc_tpu_torch.mesh.generate import write_tgrid as twrite
    from orc_tpu_torch.mesh.tgrid import read_mesh as tread

    kw = TGRID_BOXES[box]
    jpath, tpath = str(tmp_path / "j.msh"), str(tmp_path / "t.msh")
    jwrite(jpath, **kw)
    twrite(tpath, **kw)
    with open(jpath) as a, open(tpath) as b:
        assert a.read() == b.read()
    mj, tj = jread(jpath, native=False)
    mt, tt = tread(tpath, device="cpu")
    _assert_meshes_equal(mj, mt)
    assert tt.codes == tj.codes and tt.zone_ids == tj.zone_ids
    assert [z.name for z in tt.zones.values()] == [z.name for z in tj.zones.values()]


def test_to_raw_order_equals_orc_tpu():
    from orc_tpu.mesh.compile import to_raw_order as jraw

    from orc_tpu_torch.mesh.compile import to_raw_order as traw

    mj, mt = compiled_both(permuted_arrays(9, seed=6)[0])
    field = np.arange(mt.n_cells, dtype=np.float64) ** 2
    np.testing.assert_array_equal(traw(mt, torch.tensor(field)), jraw(mj, field))
    np.testing.assert_array_equal(traw(mt, field), jraw(mj, field))


def test_interop_carries_an_irregular_mesh():
    from orc_tpu_torch.interop import slice_plan_from_numpy

    mj, mt = compiled_both(permuted_arrays(9, seed=4)[0])
    p = mj.slice_plan
    plan = slice_plan_from_numpy(
        {f: getattr(p, f) if isinstance(getattr(p, f), int) else np.asarray(getattr(p, f))
         for f in ("starts", "col_of", "tile_nj", "col_tile", "tile", "n_max",
                   "pad_lo", "pad_hi", "n_cells", "j0", "n_heavy")},
        device="cpu",
    )
    back = compiled_mesh_from_numpy(
        {name: np.asarray(getattr(mj, name)) for name in MESH_FIELDS},
        None, None, dim=mj.dim, device="cpu",
        cell_order=np.asarray(mj.cell_order), slice_plan=plan,
    )
    _assert_meshes_equal(mj, back)
    _assert_meshes_equal(mj, mt)


def test_entry_points_need_a_gpu_by_default(monkeypatch, tmp_path):
    """Without a CUDA GPU every entry point raises on its default device
    instead of falling back to the CPU."""
    from orc_tpu_torch.mesh.compile import compile_from_arrays, compile_mesh
    from orc_tpu_torch.mesh.generate import write_tgrid
    from orc_tpu_torch.mesh.tgrid import parse_tgrid, read_mesh
    from orc_tpu_torch.models.cavity import cavity_case, solve_cavity
    from orc_tpu_torch.models.channel_flow import couette_case

    path = str(tmp_path / "box.msh")
    write_tgrid(path, 3, 3, 1)
    with open(path) as f:
        raw = parse_tgrid(f.read())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: tbox(3, 3, 1),
        lambda: cavity_case(n=4),
        lambda: solve_cavity(n=4, iterations=1, verbose=False),
        lambda: couette_case(4, 4),
        lambda: compile_from_arrays(**permuted_arrays(4, seed=0)[0]),
        lambda: compile_mesh(raw),
        lambda: read_mesh(path),
        lambda: tbox(3, 3, 1, device="cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()
    assert tbox(3, 3, 1, device="cpu")[0].device.type == "cpu"
