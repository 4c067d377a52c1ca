"""The port's native (C++) TGRID reader (orc_tpu_torch/mesh/native.py,
csrc/tgrid_reader.cpp) against its Python parser and against orc_tpu's
native reader, on write_tgrid boxes (one cell deep, 3-D, periodic, with
relabelled cells) and a genuinely two-dimensional file: the RawMeshes
must be equal (points, face nodes, cells, zones, periodic pairs exactly).
Also: the error on a garbage file, read_mesh(native=True), and the
library built from the port's own source under build/orc_tpu_torch/.
"""

import numpy as np
import pytest
import torch

from torch_parity import relabelled_tgrid, tgrid_2d

from orc_tpu.mesh import native as j_native
from orc_tpu.mesh.generate import write_tgrid as j_write_tgrid

from orc_tpu_torch.mesh import native
from orc_tpu_torch.mesh.generate import write_tgrid
from orc_tpu_torch.mesh.tgrid import parse_tgrid, read_mesh
from orc_tpu_torch.ops._cuda import BUILD_DIR, CSRC_DIR


def assert_same(a, b, cell_zones=False):
    assert (a.dim, a.n_cells, a.n_faces) == (b.dim, b.n_cells, b.n_faces)
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.face_cells, b.face_cells)
    np.testing.assert_array_equal(a.face_zone_id, b.face_zone_id)
    np.testing.assert_array_equal(a.periodic_pairs, b.periodic_pairs)
    for x, y in zip(a.face_nodes, b.face_nodes):
        np.testing.assert_array_equal(x, y)
    za = {z.zone_id: (z.name, int(z.zone_type)) for z in a.face_zones.values()}
    zb = {z.zone_id: (z.name, int(z.zone_type)) for z in b.face_zones.values()}
    assert za == zb


def _files(tmp_path):
    write_tgrid(str(tmp_path / "thin.msh"), 5, 4, 1, lengths=(2.0, 1.0, 0.1))
    write_tgrid(str(tmp_path / "box3d.msh"), 4, 3, 2)
    write_tgrid(str(tmp_path / "periodic.msh"), 4, 6, 1, periodic=("x",))
    return {
        "thin": tmp_path / "thin.msh",
        "3d": tmp_path / "box3d.msh",
        "periodic": tmp_path / "periodic.msh",
        "relabelled": relabelled_tgrid(tmp_path, 6, seed=2),
        "2d": tgrid_2d(tmp_path / "quad2d.msh", 5, 3),
    }


@pytest.mark.parametrize("name", ["thin", "3d", "periodic", "relabelled", "2d"])
def test_native_matches_python_and_orc_tpu(tmp_path, name):
    path = str(_files(tmp_path)[name])
    rn = native.parse_tgrid_native(path)
    with open(path) as f:
        rp = parse_tgrid(f.read())
    assert_same(rn, rp)
    assert_same(rn, j_native.parse_tgrid_native(path))
    if name == "periodic":
        assert rn.periodic_pairs.shape[0] > 0
    if name == "2d":
        assert rn.dim == 2


def test_write_tgrid_files_equal_orc_tpu(tmp_path):
    """The port's write_tgrid writes orc_tpu's bytes (the CLI's VTK of a
    generated box goes through it)."""
    for kw in (dict(nx=5, ny=4, nz=1), dict(nx=3, ny=2, nz=2, periodic=("x",))):
        write_tgrid(str(tmp_path / "t.msh"), **kw, lengths=(2.0, 1.0, 0.5))
        j_write_tgrid(str(tmp_path / "j.msh"), **kw, lengths=(2.0, 1.0, 0.5))
        assert (tmp_path / "t.msh").read_bytes() == (tmp_path / "j.msh").read_bytes()


def test_native_error_on_garbage(tmp_path):
    path = tmp_path / "garbage.msh"
    path.write_text("hello\nworld\n")
    with pytest.raises(ValueError, match="native TGRID parse failed"):
        native.parse_tgrid_native(str(path))


def test_read_mesh_native_flag(tmp_path):
    """read_mesh(native=True) compiles the mesh the Python parser's gives,
    RCM order and slice plan included; native=True raises when the
    parser fails (here: a missing file), where "auto" would fall back."""
    path = str(relabelled_tgrid(tmp_path, 8, seed=1))
    mn, tn = read_mesh(path, native=True, device="cpu")
    mp, tp = read_mesh(path, native=False, device="cpu")
    for name in ("cell_centroid", "cell_volume", "cell_neighbors", "cell_order", "face_zone_slot"):
        assert torch.equal(getattr(mn, name), getattr(mp, name)), name
    assert torch.equal(mn.slice_plan.starts, mp.slice_plan.starts)
    assert tn.zone_ids == tp.zone_ids
    with pytest.raises(ValueError):
        read_mesh(str(tmp_path / "missing.msh"), native=True, device="cpu")


def test_library_built_from_the_port_source():
    """The parser library is built from csrc/tgrid_reader.cpp into
    build/orc_tpu_torch/, never beside the source, and is current."""
    native.library()
    assert native.SRC == CSRC_DIR / "tgrid_reader.cpp"
    assert native.LIB_PATH.parent == BUILD_DIR
    assert BUILD_DIR.parts[-2:] == ("build", "orc_tpu_torch")
    assert native.LIB_PATH.exists() and not native.is_stale()
    assert native.native_available()
    assert not list(CSRC_DIR.glob("*.so"))
