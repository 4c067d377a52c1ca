"""Port RCM ordering and slice plans (orc_tpu_torch/mesh/reorder.py)
against orc_tpu's, on permuted cavities (13^2, 17^2, 19^2, 23^2), a
permuted 6^3 box, a random banded adjacency (wide tiles) and a skewed one
(orc_tpu's heavy-tail split): the permutation, every plan table at tile
128 and 1024, the tile choice, and tests/test_reorder.py's coverage and
bandwidth checks. Integers are compared exactly.
"""

import numpy as np
import pytest

from torch_parity import compiled_both, np_, permuted_arrays

from orc_tpu.mesh import reorder as jr

from orc_tpu_torch.mesh import reorder as tr

MESHES = {
    "13x13": (13, 1, 1),
    "17x17": (17, 1, 2),
    "19x19": (19, 1, 3),
    "23x23": (23, 1, 4),
    "6x6x6": (6, 6, 5),
}
PLAN_TABLES = ("starts", "col_of", "col_tile", "tile_nj")
PLAN_SIZES = ("tile", "n_max", "pad_lo", "pad_hi", "n_cells", "j0", "n_heavy")


def _mesh(name):
    n, nz, seed = MESHES[name]
    return compiled_both(permuted_arrays(n, seed=seed, nz=nz)[0])


def _tables(mesh):
    nbrs = np_(mesh.cell_neighbors).astype(np.int64)
    interior = np_(mesh.face_interior)[np_(mesh.cell_faces)] & np_(
        mesh.cell_face_mask
    )
    return nbrs, interior


def _banded(C=4500, K=4, bw=6, seed=21):
    """A random banded adjacency (what RCM produces), as
    tests/test_pallas_slice.py builds it."""
    rng = np.random.default_rng(seed)
    base = np.arange(C)[:, None]
    nbrs = base + rng.integers(-bw, bw + 1, (C, K))
    valid = (nbrs >= 0) & (nbrs < C) & (nbrs != base)
    return np.where(valid, nbrs, base), valid


def _skewed(C=6400, K=6, band=400, seed=3):
    """tests/test_pallas_slice.py's skewed per-tile distribution, which
    turns orc_tpu's heavy-tail split on."""
    rng = np.random.default_rng(seed)
    ntiles = -(-C // 128)
    n_d = np.minimum(2 + rng.geometric(0.2, ntiles), 30)
    tile_deltas = rng.integers(-band, band + 1, (ntiles, int(n_d.max())))
    t_of = np.arange(C) // 128
    pick = rng.integers(0, 10_000, (C, K)) % n_d[t_of][:, None]
    nbrs = np.arange(C)[:, None] + tile_deltas[t_of[:, None], pick]
    valid = (nbrs >= 0) & (nbrs < C) & (rng.random((C, K)) < 0.9)
    return np.where(valid, np.clip(nbrs, 0, C - 1), np.arange(C)[:, None]), valid


ADJACENCIES = {
    **{name: (lambda name=name: _tables(_mesh(name)[0])) for name in MESHES},
    "banded": _banded,
    "skewed": _skewed,
}


def _assert_plans_equal(pt, pj):
    assert (pt is None) == (pj is None)
    if pj is None:
        return
    for f in PLAN_TABLES:
        a, b = getattr(pj, f), getattr(pt, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np_(b), np_(a), err_msg=f)
    for f in PLAN_SIZES:
        assert getattr(pt, f) == getattr(pj, f), f


@pytest.mark.parametrize("name", sorted(MESHES))
def test_rcm_permutation_equals_orc_tpu(name):
    mj, mt = _mesh(name)
    np.testing.assert_array_equal(np_(mt.cell_order), np_(mj.cell_order))
    nbrs, interior = _tables(mj)
    np.testing.assert_array_equal(
        tr.rcm_permutation(nbrs, interior), jr.rcm_permutation(nbrs, interior)
    )


@pytest.mark.parametrize("tile", [128, 1024])
@pytest.mark.parametrize("adj", sorted(ADJACENCIES))
def test_slice_plan_equals_orc_tpu(adj, tile):
    nbrs, interior = ADJACENCIES[adj]()
    _assert_plans_equal(
        tr.build_slice_plan(
            nbrs, interior, tile=tile, build_col_tile=True, device="cpu"
        ),
        jr.build_slice_plan(nbrs, interior, tile=tile, build_col_tile=True),
    )


@pytest.mark.parametrize("adj", sorted(ADJACENCIES))
def test_best_slice_plan_picks_orc_tpus_tile(adj):
    nbrs, interior = ADJACENCIES[adj]()
    pt = tr.build_best_slice_plan(nbrs, interior, build_col_tile=True, device="cpu")
    pj = jr.build_best_slice_plan(nbrs, interior, build_col_tile=True)
    assert pt.tile == pj.tile
    _assert_plans_equal(pt, pj)


def test_skewed_plan_has_the_heavy_split():
    """The skewed adjacency exercises orc_tpu's j0 / n_heavy, which
    feed the tile choice."""
    plan = tr.build_slice_plan(*_skewed(), device="cpu")
    assert plan.j0 > 0 and plan.n_heavy > 0


def test_banded_adjacency_picks_wide_tiles():
    """The banded adjacency exercises the other side of the tile choice
    (1024-row tiles, as orc_tpu picks there)."""
    assert tr.build_best_slice_plan(*_banded(), device="cpu").tile == 1024


@pytest.mark.parametrize("name", sorted(MESHES))
def test_rcm_is_permutation_and_bounds_bandwidth(name):
    _, mesh = _mesh(name)
    C = mesh.n_cells
    assert mesh.neighbor_offsets is None
    order = np_(mesh.cell_order)
    assert sorted(order.tolist()) == list(range(C))
    nbrs, interior = _tables(mesh)
    delta = np.abs(nbrs - np.arange(C)[:, None])[interior]
    n = MESHES[name][0]
    bound = 6 * n + 8 if MESHES[name][1] == 1 else 6 * n * n + 8
    assert delta.max() <= bound


@pytest.mark.parametrize("name", sorted(MESHES))
def test_slice_plan_covers_every_entry(name):
    _, mesh = _mesh(name)
    plan = mesh.slice_plan
    nbrs, interior = _tables(mesh)
    starts, col_of = np_(plan.starts), np_(plan.col_of)
    rows, cols = np.nonzero(interior)
    got = starts[rows // plan.tile, col_of[rows, cols]] + rows % plan.tile
    np.testing.assert_array_equal(got, nbrs[rows, cols] + plan.pad_lo)
    # Used columns come first in every tile.
    nj = np_(plan.tile_nj)
    assert (col_of[rows, cols] < nj[rows // plan.tile]).all()


@pytest.mark.parametrize("name", ["build_slice_plan", "build_best_slice_plan"])
def test_slice_plan_builders_take_orc_tpus_parameters(name):
    """orc_tpu's parameter names, in its order, are a subsequence of the
    port's (the port adds `device` at the end), with equal defaults."""
    import inspect

    pj = inspect.signature(getattr(jr, name)).parameters
    pt = inspect.signature(getattr(tr, name)).parameters
    it = iter(pt)
    assert all(p in it for p in pj), (list(pj), list(pt))
    for p in pj:
        assert pt[p].default == pj[p].default, p
    assert list(pt)[-1] == "device"


@pytest.mark.parametrize("build_col_tile", [False, True])
@pytest.mark.parametrize("tile", [128, 1024, "best"])
@pytest.mark.parametrize("adj", sorted(ADJACENCIES))
def test_slice_plan_flag_equals_orc_tpu(adj, tile, build_col_tile):
    """Both builders under both values of `build_col_tile`: every integer
    table equal to orc_tpu's, the gather table absent exactly where
    orc_tpu's is."""
    nbrs, interior = ADJACENCIES[adj]()
    if tile == "best":
        pt = tr.build_best_slice_plan(
            nbrs, interior, build_col_tile=build_col_tile, device="cpu"
        )
        pj = jr.build_best_slice_plan(nbrs, interior, build_col_tile=build_col_tile)
    else:
        pt = tr.build_slice_plan(
            nbrs, interior, tile=tile, build_col_tile=build_col_tile, device="cpu"
        )
        pj = jr.build_slice_plan(
            nbrs, interior, tile=tile, build_col_tile=build_col_tile
        )
    _assert_plans_equal(pt, pj)
    if pj is not None:
        assert (pt.col_tile is None) == (pj.col_tile is None) == (not build_col_tile)


def test_slice_plan_builders_default_to_no_gather_table():
    nbrs, interior = _banded()
    assert tr.build_slice_plan(nbrs, interior, device="cpu").col_tile is None
    assert tr.build_best_slice_plan(nbrs, interior, device="cpu").col_tile is None
    plan = tr.build_best_slice_plan(nbrs, interior, build_col_tile=True, device="cpu")
    assert plan.col_tile is not None
