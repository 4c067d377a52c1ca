"""Port mesh (orc_tpu_torch/mesh) against orc_tpu: every CompiledMesh
field of structured_box_mesh, the static offsets and per-column
constants, the zone table, device_bc and the interop round trip."""

import numpy as np
import pytest
import torch

from torch_parity import np_

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
    return jbox(**kw, dtype=jdt), tbox(**kw, dtype=tdt)


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
    for a, b in zip(jdevice_bc(tj), tdevice_bc(tt)):
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
        fields, mt.neighbor_offsets, mt.ck_constants, dim=mt.dim
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
    back = compiled_mesh_from_numpy(fields, mj.neighbor_offsets, mj.ck_constants)
    for name in MESH_FIELDS:
        assert torch.equal(getattr(back, name), getattr(mt, name)), name


def test_trim_for_ck_keeps_cell_geometry():
    _, (mt, _) = _pair("8x8x1")
    tr = trim_for_ck(mt)
    assert tr.face_area.shape == (2,) and tr.cell_neighbors.shape == (2, 6)
    assert torch.equal(tr.cell_volume, mt.cell_volume)
    assert torch.equal(tr.cell_face_mask, mt.cell_face_mask)
    assert tr.neighbor_offsets == mt.neighbor_offsets


def test_two_cell_periodic_axis_is_not_ported():
    with pytest.raises(NotImplementedError):
        tbox(2, 4, 3, periodic=("x",))
    with pytest.raises(ValueError):
        tbox(1, 4, 3, periodic=("x",))
