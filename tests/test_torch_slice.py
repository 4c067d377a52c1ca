"""Port slice-plan SpMV and neighbour gather (orc_tpu_torch/ops/
slice_spmv.py, the plain versions of kernels 7-11) against orc_tpu:

- the plain slice SpMV against orc_tpu's XLA `spmv.slice_spmv` (f64,
  1e-12) and against `slice_spmv_pallas(..., interpret=True)` (f32, rtol
  2e-6 as tests/test_pallas_slice.py), on its `_random_banded` shapes
  (C = 300 and 1410), the heavy-tail split (rtol 2e-5, as there), wide
  tiles and the batched [3,C] form;
- `EllMatrix.prepare()` against orc_tpu's (bitwise) and, with the slice
  `jacobi_preconditioned`, against the port's gather SpMV (1e-12);
- the plain slice neighbour gather against orc_tpu's
  `slice_nbr_values(interpret=True)` at interior slots, exactly.
"""

import numpy as np
import pytest
import torch

from torch_parity import np_

import jax.numpy as jnp
from orc_tpu.mesh.reorder import build_slice_plan as jplan
from orc_tpu.ops import spmv as jspmv
from orc_tpu.ops.pallas_slice import slice_nbr_values as jnbr
from orc_tpu.ops.pallas_slice import slice_spmv_pallas

from orc_tpu_torch.interop import slice_plan_from_numpy
from orc_tpu_torch.mesh.reorder import build_slice_plan as tplan
from orc_tpu_torch.ops.slice_spmv import slice_nbr_values, slice_spmv
from orc_tpu_torch.ops.spmv import EllMatrix


def _random_banded(C, K=4, bw=10, seed=0, empty_tiles=(), tile=128):
    """tests/test_pallas_slice.py's banded sparsity (what RCM produces)
    and both packages' plans of it; `empty_tiles` get no interior
    entries."""
    rng = np.random.default_rng(seed)
    base = np.arange(C)[:, None]
    nbrs = base + rng.integers(-bw, bw + 1, (C, K))
    valid = (nbrs >= 0) & (nbrs < C) & (nbrs != base)
    t = np.arange(C) // 128
    for et in empty_tiles:
        valid[t == et] = False
    nbrs = np.where(valid, nbrs, base)
    pj = jplan(nbrs, valid, tile=tile, build_col_tile=True)
    pt = tplan(nbrs, valid, tile=tile, build_col_tile=True, device="cpu")
    return nbrs, valid, pj, pt


def _skewed(C=6400, K=6, band=400, seed=3):
    """tests/test_pallas_slice.py's `_skewed_mesh`: orc_tpu's heavy-tail
    split is on for its plan."""
    rng = np.random.default_rng(seed)
    ntiles = -(-C // 128)
    n_d = np.minimum(2 + rng.geometric(0.2, ntiles), 30)
    tile_deltas = rng.integers(-band, band + 1, (ntiles, int(n_d.max())))
    t_of = np.arange(C) // 128
    pick = rng.integers(0, 10_000, (C, K)) % n_d[t_of][:, None]
    nbrs = np.arange(C)[:, None] + tile_deltas[t_of[:, None], pick]
    valid = (nbrs >= 0) & (nbrs < C) & (rng.random((C, K)) < 0.9)
    nbrs = np.where(valid, np.clip(nbrs, 0, C - 1), np.arange(C)[:, None])
    pj = jplan(nbrs, valid, tile=128, build_col_tile=True)
    pt = tplan(nbrs, valid, tile=128, build_col_tile=True, device="cpu")
    return nbrs, valid, pj, pt


def _system(nbrs, valid, batch=(), seed=1, dtype=np.float64):
    rng = np.random.default_rng(seed)
    C, K = nbrs.shape
    off = (rng.standard_normal((*batch, C, K)) * valid).astype(dtype)
    diag = (rng.standard_normal((*batch, C)) + 5.0).astype(dtype)
    x = rng.standard_normal((*batch, C)).astype(dtype)
    return off, diag, x


def _coefs(off, nbrs, pj, pt):
    """orc_tpu's and the port's prepared [..., ntiles, n_max, T]."""
    cj = jspmv.EllMatrix(
        diag=jnp.zeros(off.shape[:-1], off.dtype), off=jnp.asarray(off),
        neighbors=jnp.asarray(nbrs), plan=pj,
    ).prepare().off
    ct = EllMatrix(
        diag=torch.zeros(off.shape[:-1], dtype=torch.from_numpy(off).dtype),
        off=torch.from_numpy(off), neighbors=torch.from_numpy(nbrs), plan=pt,
    ).prepare().off
    return cj, ct


@pytest.mark.parametrize("C", [300, 1410])
def test_plain_slice_spmv_matches_xla_f64(C):
    nbrs, valid, pj, pt = _random_banded(C, seed=C % 97)
    off, diag, x = _system(nbrs, valid)
    cj, ct = _coefs(off, nbrs, pj, pt)
    np.testing.assert_array_equal(np_(ct), np_(cj))
    y_ref = jspmv.slice_spmv(jnp.asarray(diag), cj, pj, jnp.asarray(x))
    y = slice_spmv(torch.from_numpy(diag), ct, pt, torch.from_numpy(x))
    np.testing.assert_allclose(np_(y), np_(y_ref), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("C", [300, 1410])
def test_plain_slice_spmv_matches_pallas_interpret_f32(C):
    nbrs, valid, pj, pt = _random_banded(C, seed=C % 97)
    assert C % 128 != 0 and pt.ntiles % 8 != 0  # partial tile and group
    off, diag, x = _system(nbrs, valid, dtype=np.float32)
    cj, ct = _coefs(off, nbrs, pj, pt)
    y_ref = slice_spmv_pallas(
        jnp.asarray(diag), cj, pj, jnp.asarray(x), interpret=True
    )
    y = slice_spmv(torch.from_numpy(diag), ct, pt, torch.from_numpy(x))
    np.testing.assert_allclose(np_(y), np_(y_ref), rtol=2e-6, atol=2e-6)


def test_plain_slice_spmv_matches_heavy_split_kernel():
    """orc_tpu's `_kernel` + `_kernel_heavy` split against the port's
    one loop bounded by tile_nj."""
    nbrs, valid, pj, pt = _skewed()
    assert pj.j0 > 0 and pj.n_heavy > 0
    off, diag, x = _system(nbrs, valid, dtype=np.float32)
    cj, ct = _coefs(off, nbrs, pj, pt)
    y_ref = slice_spmv_pallas(
        jnp.asarray(diag), cj, pj, jnp.asarray(x), interpret=True
    )
    y = slice_spmv(torch.from_numpy(diag), ct, pt, torch.from_numpy(x))
    np.testing.assert_allclose(np_(y), np_(y_ref), rtol=2e-5, atol=2e-5)


def test_plain_slice_spmv_matches_wide_tile_kernel():
    """tile = 1024 (orc_tpu's `_kernel_wide`), partial last tile."""
    nbrs, valid, pj, pt = _random_banded(4196, bw=6, seed=21, tile=1024)
    assert pt.tile == 1024
    off, diag, x = _system(nbrs, valid, dtype=np.float32)
    cj, ct = _coefs(off, nbrs, pj, pt)
    y_ref = slice_spmv_pallas(
        jnp.asarray(diag), cj, pj, jnp.asarray(x), interpret=True
    )
    y = slice_spmv(torch.from_numpy(diag), ct, pt, torch.from_numpy(x))
    np.testing.assert_allclose(np_(y), np_(y_ref), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_row"])
def test_plain_slice_spmv_batched(shared):
    """The [3,C] momentum form: x [3,C] with one matrix shared by the
    three rows (as prepare() gives it for the shared momentum matrix) or
    one per row; against orc_tpu's XLA slice SpMV row by row."""
    nbrs, valid, pj, pt = _random_banded(500, seed=2)
    off, diag, x = _system(nbrs, valid, batch=() if shared else (3,))
    x = np.random.default_rng(5).standard_normal((3, nbrs.shape[0]))
    cj, ct = _coefs(off, nbrs, pj, pt)
    y = np_(slice_spmv(torch.from_numpy(diag), ct, pt, torch.from_numpy(x)))
    for b in range(3):
        row = (lambda a: a) if shared else (lambda a: a[b])
        y_ref = jspmv.slice_spmv(
            jnp.asarray(row(diag)), row(cj), pj, jnp.asarray(x[b])
        )
        np.testing.assert_allclose(y[b], np_(y_ref), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_prepare_and_jacobi_preconditioned_match_gather(batch):
    nbrs, valid, _, pt = _random_banded(700, K=6, seed=4, empty_tiles=(2,))
    off, diag, x = (torch.from_numpy(a) for a in _system(nbrs, valid, batch))
    nb = torch.from_numpy(nbrs).to(torch.int32)
    gather = EllMatrix(diag=diag, off=off, neighbors=nb)
    sliced = EllMatrix(diag=diag, off=off, neighbors=nb, plan=pt).prepare()
    assert sliced.slice_layout and sliced.prepare() is sliced
    np.testing.assert_allclose(
        np_(sliced.matvec(x)), np_(gather.matvec(x)), rtol=1e-12, atol=1e-12
    )
    (Ap, dp), (Ag, dg) = sliced.jacobi_preconditioned(), gather.jacobi_preconditioned()
    np.testing.assert_array_equal(np_(dp), np_(dg))
    np.testing.assert_allclose(
        np_(Ap.matvec(x)), np_(Ag.matvec(x)), rtol=1e-12, atol=1e-12
    )


def _nbr_case(C, K, bw, seed, empty_tiles=(), tile=128):
    nbrs, valid, pj, pt = _random_banded(
        C, K=K, bw=bw, seed=seed, empty_tiles=empty_tiles, tile=tile
    )
    rng = np.random.default_rng(1)
    return nbrs, valid, pj, pt, rng


@pytest.mark.parametrize(
    "C,bw,tile,empty", [(300, 6, 128, (1,)), (4196, 6, 1024, ())],
    ids=["tile128", "tile1024"],
)
def test_plain_slice_nbr_values_match_pallas_interpret(C, bw, tile, empty):
    """Scalar and 3-vector fields; orc_tpu's kernel leaves non-interior
    slots arbitrary, the port's returns the own value there."""
    nbrs, valid, pj, pt, rng = _nbr_case(C, 6 if tile == 128 else 4, bw, 7, empty, tile)
    for shape in ((C,), (C, 3)):
        x = rng.standard_normal(shape).astype(np.float32)
        ref = np_(jnbr(pj, jnp.asarray(x), interpret=True))
        got = np_(slice_nbr_values(pt, torch.from_numpy(x), torch.from_numpy(valid)))
        v = valid.reshape(valid.shape + (1,) * (x.ndim - 1))
        np.testing.assert_array_equal(np.where(v, got, 0), np.where(v, ref, 0))
        np.testing.assert_array_equal(got, x[nbrs])  # self at non-interior


def test_plain_slice_nbr_values_take_nine_fields():
    """The [C,3,3] velocity gradient: one gather of 9 fields."""
    nbrs, valid, _, pt, rng = _nbr_case(700, 6, 8, 3)
    x = rng.standard_normal((700, 3, 3))
    got = slice_nbr_values(pt, torch.from_numpy(x), torch.from_numpy(valid))
    assert got.shape == (700, 6, 3, 3)
    np.testing.assert_array_equal(np_(got), x[nbrs])


def test_plan_carries_across_with_interop():
    nbrs, valid, pj, pt = _random_banded(300, seed=8)
    fields = {
        f: getattr(pj, f)
        for f in ("starts", "col_of", "tile_nj", "col_tile", "tile", "n_max",
                  "pad_lo", "pad_hi", "n_cells", "j0", "n_heavy")
    }
    carried = slice_plan_from_numpy(
        {k: np.asarray(v) if hasattr(v, "shape") else v for k, v in fields.items()},
        device="cpu",
    )
    for f in ("starts", "col_of", "tile_nj", "col_tile"):
        assert torch.equal(getattr(carried, f), getattr(pt, f)), f
    assert (carried.tile, carried.n_max, carried.pad_lo) == (pt.tile, pt.n_max, pt.pad_lo)


def test_interop_plan_needs_every_table():
    """A plan carried across without its gather table is refused: the
    port's nbr_values reads col_tile on every irregular mesh."""
    nbrs, valid, _, _ = _random_banded(300, seed=8)
    pj = jplan(nbrs, valid, tile=128)
    fields = {
        f: np.asarray(getattr(pj, f)) if f in ("starts", "col_of", "tile_nj")
        else getattr(pj, f)
        for f in ("starts", "col_of", "tile_nj", "col_tile", "tile", "n_max",
                  "pad_lo", "pad_hi", "n_cells")
    }
    assert fields["col_tile"] is None
    with pytest.raises(KeyError):
        slice_plan_from_numpy(fields, device="cpu")
