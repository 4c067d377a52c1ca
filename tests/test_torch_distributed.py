"""The sharded runtime: orc_tpu_torch/parallel against orc_tpu/parallel
and against the port's own single-device runs, on the CPU, float64.

- Partitions: slab and RCB tables (owned_global, owned_mask, the
  exchange plan, c_max, h_max) and the local meshes' arrays equal
  orc_tpu's at P = 2, 3, 4 and 8, on a 2-D box, a wider 2-D box, a 3-D
  box and a permuted cavity (RCB only).
- orc_tpu's tests/test_distributed.py tests of the partition layer,
  ported: RCB balance, the state round trip, the halo refresh and the
  slab's ghost layers; and the scatter of one state in both packages,
  partition by partition.
- Sharded against single-device at orc_tpu's tolerance (rtol 1e-8, atol
  1e-12): every case of tests/test_distributed.py (P = 2, 4, 8; slab and
  RCB; the (c,k) and face-major steps; Rhie-Chow + SecondOrder; AMG on an
  irregular mesh), and SIMPLE_FC, the transient march, RANS on the
  16x12 channel of test_torch_turbulence.py and GMG on a box.
- The port's sharded run against orc_tpu's sharded run on its virtual
  CPU devices, within 1e-8.
- The rendezvous: every partition receives the same bits from each
  reduction; a partition that raises ends the run with its exception,
  and partitions that reach different collectives end it too, without
  a hang.
- The kernel gate under sharding: `_kernel_asm_spec(..., sharded=True)`
  decides as orc_tpu's `_pallas_asm_spec(..., sharded=True)` (gg off),
  and the slab windows' boxes.
"""

import threading
import time

import numpy as np
import pytest
import torch

from torch_parity import both, compiled_both, np_, permuted_arrays, to_jax_settings

import jax
from orc_tpu.mesh import structured_box_mesh as jbox
from orc_tpu.mesh.zones import FaceCondition as JFC
from orc_tpu.parallel import partition as jpart
from orc_tpu.parallel import sharded as jsh
from orc_tpu.solver import simple as jsimple

from orc_tpu_torch.interop import flow_states_to_numpy
from orc_tpu_torch.mesh.generate import structured_box_mesh as tbox
from orc_tpu_torch.mesh.zones import FaceCondition as TFC
from orc_tpu_torch.parallel import partition as tpart
from orc_tpu_torch.parallel import sharded as tsh
from orc_tpu_torch.solver import simple as tsimple
from orc_tpu_torch.utils import settings as tset

TOL = dict(rtol=1e-8, atol=1e-12)


def case(pkg="torch", nx=8, ny=8, nz=1):
    """tests/test_distributed.py case(): a pressure-driven channel with a
    moving top wall."""
    box, fc = (jbox, JFC) if pkg == "jax" else (tbox, TFC)
    kw = {} if pkg == "jax" else dict(device="cpu")
    mesh, table = box(nx, ny, nz, lengths=(0.002, 0.001, 0.0001), **kw)
    table.set("TOP_WALL", fc.WALL, vector_value=(5e-4, 0, 0))
    table.set("INLET", fc.PRESSURE_INLET, scalar_value=0.01)
    table.set("OUTLET", fc.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", fc.SYMMETRY)
    table.set("PERIODIC_+Z", fc.SYMMETRY)
    return mesh, table


#: tests/test_distributed.py SETTINGS.
SETTINGS = tset.NumericalSettings(
    momentum=tset.MomentumScheme.UD,
    pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED,
    velocity_interpolation=tset.VelocityInterpolation.LINEAR_WEIGHTED,
    matrix_solver=tset.MatrixSolverSettings(
        solver_type=tset.SolutionMethod.BICGSTAB,
        iterations=30,
        preconditioner=tset.PreconditionMethod.JACOBI,
    ),
)


def _assert_states(a, b, tol=TOL, fields=("vel", "p")):
    for f in fields:
        np.testing.assert_allclose(np_(getattr(a, f)), np_(getattr(b, f)), **tol, err_msg=f)


# --- partitions ----------------------------------------------------------

PARTITION_CASES = {
    "box": lambda pkg: case(pkg),
    "box2d": lambda pkg: case(pkg, 16, 4),
    "box3d": lambda pkg: case(pkg, 4, 4, 4),
}


def _meshes(name):
    if name == "permuted":
        (mj, _), (mt, _) = both("permuted")
        return mj, mt
    return PARTITION_CASES[name]("jax")[0], PARTITION_CASES[name]("torch")[0]


INT_FIELDS = (
    "face_owner", "face_neighbor", "face_interior", "face_zone_slot",
    "cell_faces", "cell_face_mask", "cell_neighbors",
)
FLOAT_FIELDS = (
    "face_area", "face_normal", "face_centroid", "face_lw", "face_r_on",
    "face_dist_on", "face_dist_fo", "cell_centroid", "cell_volume",
    "cell_face_sign",
)


@pytest.mark.parametrize("n_parts", [2, 3, 4, 8])
@pytest.mark.parametrize(
    "name,method",
    [(c, m) for c in PARTITION_CASES for m in ("slab", "rcb")]
    + [("permuted", "rcb")],
)
def test_partition_tables_equal_orc_tpu(name, method, n_parts):
    mj, mt = _meshes(name)
    jp = jpart.partition_mesh(mj, n_parts, method=method)
    tp = tpart.partition_mesh(mt, n_parts, method=method)
    assert (tp.offsets, tp.n_parts, tp.c_max, tp.h_max) == (
        jp.offsets, jp.n_parts, jp.c_max, jp.h_max
    )
    np.testing.assert_array_equal(tp.owned_global, np.asarray(jp.owned_global))
    np.testing.assert_array_equal(tp.owned_mask, np.asarray(jp.owned_mask))
    assert len(tp.send_idx) == len(jp.send_idx) == len(tp.recv_idx)
    for a, b in zip(tp.send_idx + tp.recv_idx, jp.send_idx + jp.recv_idx):
        np.testing.assert_array_equal(a, np.asarray(b))
    lm = jp.local_mesh
    for p, m in enumerate(tp.local_meshes):
        assert m.neighbor_offsets == lm.neighbor_offsets
        assert (m.ck_constants is None) == (lm.ck_constants is None)
        for f in INT_FIELDS:
            np.testing.assert_array_equal(np_(getattr(m, f)), np.asarray(getattr(lm, f))[p], f)
        for f in FLOAT_FIELDS:
            np.testing.assert_array_equal(np_(getattr(m, f)), np.asarray(getattr(lm, f))[p], f)


def test_rcb_partition_balance():
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((1000, 3))
    for n in (2, 3, 8):
        parts = tpart.rcb_partition(pts, n)
        counts = np.bincount(parts, minlength=n)
        assert counts.min() >= 1000 // n - 2
        assert counts.max() <= 1000 // n + 2
        np.testing.assert_array_equal(parts, jpart.rcb_partition(pts, n))


@pytest.mark.parametrize("method", ["slab", "rcb"])
def test_partition_roundtrip_state(method):
    mesh, _ = case()
    part = tpart.partition_mesh(mesh, 4, method=method)
    rng = np.random.default_rng(1)
    st = tsimple.initial_state(
        mesh, vel=rng.standard_normal((mesh.n_cells, 3)), p=rng.standard_normal(mesh.n_cells)
    )
    back = tsh.gather_state(part, tsh.scatter_state(part, st), mesh.n_cells)
    _assert_states(back, st, dict(rtol=0, atol=0), ("vel", "p", "mom_diag"))


@pytest.mark.parametrize("method", ["slab", "rcb"])
def test_scatter_state_equals_orc_tpu(method):
    """One state scattered by both packages: orc_tpu's stacked [P, L]
    local state equals the port's per-partition states (interop's
    stacked layout), partition by partition, and each package gathers
    the other's scatter back to the state."""
    (mj, _), (mt, _) = (case("jax"), case("torch"))
    rng = np.random.default_rng(2)
    vel, p = rng.standard_normal((mt.n_cells, 3)), rng.standard_normal(mt.n_cells)
    md = rng.uniform(0.5, 2.0, (3, mt.n_cells))
    jst = jsimple.initial_state(mj, vel=vel, p=p)
    jst = jst.__class__(vel=jst.vel, p=jst.p, mom_diag=jax.numpy.asarray(md))
    tst = tsimple.FlowState(
        vel=torch.tensor(vel), p=torch.tensor(p), mom_diag=torch.tensor(md)
    )
    jp = jpart.partition_mesh(mj, 4, method=method)
    tp = tpart.partition_mesh(mt, 4, method=method)
    jl = jsh.scatter_state(jp, jst)
    tl = tsh.scatter_state(tp, tst)
    for got, ref in zip(flow_states_to_numpy(tl), (jl.vel, jl.p, jl.mom_diag)):
        np.testing.assert_array_equal(got, np.asarray(ref))
    from orc_tpu_torch.interop import flow_states_from_numpy

    back = tsh.gather_state(
        tp, flow_states_from_numpy(*(np.asarray(a) for a in (jl.vel, jl.p, jl.mom_diag)),
                                   devices=tp.devices), mt.n_cells,
    )
    _assert_states(back, tst, dict(rtol=0, atol=0), ("vel", "p", "mom_diag"))


def _refreshed(part, local_p):
    """Each partition's p after one ShardedComm.refresh, in threads."""
    group = tsh.ShardGroup(part.n_parts)
    comms = tsh.make_comms(part, group)
    out = tsh.run_partitions(
        part.devices, lambda r: comms[r].refresh(local_p[r]), group
    )
    return np.stack([np_(x) for x in out])


def _ids_state(mesh):
    ids = np.arange(mesh.n_cells, dtype=float)
    return tsimple.initial_state(mesh, vel=np.tile(ids[:, None], (1, 3)), p=ids)


def test_halo_refresh_correctness():
    """After a refresh, each partition's halo slots hold the owners'
    values (here, global cell ids), and equal orc_tpu's refresh."""
    mesh, _ = case(nx=8, ny=4)
    n = 4
    part = tpart.partition_mesh(mesh, n)
    refreshed = _refreshed(part, [s.p for s in tsh.scatter_state(part, _ids_state(mesh))])
    nbrs = [np_(m.cell_neighbors) for m in part.local_meshes]
    mask = [np_(m.cell_face_mask) for m in part.local_meshes]
    g_nbrs = np_(mesh.cell_neighbors)
    og, om = part.owned_global, part.owned_mask
    checked = 0
    for p in range(n):
        for c in range(part.c_max):
            if not om[p, c]:
                continue
            for k in range(nbrs[p].shape[1]):
                j = nbrs[p][c, k]
                if mask[p][c, k] and not om[p, j]:
                    v = refreshed[p, j]
                    assert v == int(v) and int(v) in set(g_nbrs[og[p, c]].tolist())
                    checked += 1
    assert checked > 0
    jmesh, _ = case("jax", nx=8, ny=4)
    np.testing.assert_array_equal(refreshed, _orc_tpu_refresh(jmesh, n, "auto"))


def _orc_tpu_refresh(jmesh, n, method):
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    part = jpart.partition_mesh(jmesh, n, method=method)
    ids = np.arange(jmesh.n_cells, dtype=float)
    local = jsh.scatter_state(
        part, jsimple.initial_state(jmesh, vel=np.tile(ids[:, None], (1, 3)), p=ids)
    )
    device_mesh = Mesh(np.array(jax.devices()[:n]), (jsh.AXIS,))

    def f(send_idx, recv_idx, x):
        sq = lambda t: jax.tree.map(lambda a: a[0], t)  # noqa: E731
        comm = jsh.ShardedComm(part, sq(send_idx), sq(recv_idx))
        return comm.refresh(sq(x))[None]

    spec = P(jsh.AXIS)
    return np.asarray(
        jax.jit(
            shard_map(f, mesh=device_mesh, in_specs=(spec, spec, spec),
                      out_specs=spec, check_vma=False)
        )(part.send_idx, part.recv_idx, local.p)
    )


def test_slab_preserves_offsets():
    mesh, _ = case(nx=16, ny=4)
    part = tpart.partition_mesh(mesh, 4, method="slab")
    assert all(m.neighbor_offsets == mesh.neighbor_offsets for m in part.local_meshes)
    rcb = tpart.partition_mesh(mesh, 4, method="rcb")
    assert all(m.neighbor_offsets is None for m in rcb.local_meshes)


def test_slab_ghost_layers_refresh():
    """After a refresh, every in-window ghost slot of the slab layout
    holds the owning partition's value (= global cell id here)."""
    mesh, _ = case(nx=16, ny=4)
    n = 4
    part = tpart.partition_mesh(mesh, n, method="slab")
    refreshed = _refreshed(part, [s.p for s in tsh.scatter_state(part, _ids_state(mesh))])
    og, om = part.owned_global, part.owned_mask
    checked = 0
    for p in range(n):
        sl = np.nonzero(om[p])[0]
        w0 = og[p, sl[0]] - sl[0]
        for i in range(part.local_size - 1):
            g = w0 + i
            if 0 <= g < mesh.n_cells and not om[p, i]:
                assert refreshed[p, i] == g, (p, i, g)
                checked += 1
    assert checked > 0


# --- sharded against single-device -----------------------------------------


def _steady_pair(mesh, table, settings, rho, mu, iterations, **kw):
    ref, _ = tsimple.solve_steady(
        mesh, table, settings, rho, mu, state=tsimple.initial_state(mesh),
        iterations=iterations, reporting_interval=iterations, verbose=False,
        use_ck=kw.get("ref_ck", "auto"),
    )
    kw.pop("ref_ck", None)
    sh, hist = tsh.solve_steady_sharded(
        mesh, table, settings, rho, mu, state=tsimple.initial_state(mesh),
        iterations=iterations, reporting_interval=iterations, verbose=False, **kw,
    )
    return ref, sh, hist


@pytest.mark.parametrize(
    "n_devices,method,ck",
    [(2, "slab", "auto"), (8, "slab", True), (8, "slab", False), (4, "rcb", "auto")],
)
def test_sharded_matches_single_device(n_devices, method, ck):
    """tests/test_distributed.py's cases: slab (the (c,k) and the face-
    major step) and RCB partitions reproduce the single-device run."""
    mesh, table = case()
    ref, sh, hist = _steady_pair(
        mesh, table, SETTINGS, 1000.0, 0.001, 20, n_devices=n_devices,
        partition_method=method, use_ck=ck,
    )
    _assert_states(sh, ref)
    assert hist[0].vel_avg.shape == (20, 3)


def test_rhie_chow_sharded_matches():
    """Rhie-Chow + SecondOrder: halo exchange of gradients and momentum
    diagonals."""
    mesh, table = case(nx=8, ny=4)
    settings = SETTINGS.replace(
        pressure_interpolation=tset.PressureInterpolation.SECOND_ORDER,
        velocity_interpolation=tset.VelocityInterpolation.RHIE_CHOW,
    )
    ref, sh, _ = _steady_pair(mesh, table, settings, 1000.0, 0.001, 10, n_devices=4)
    _assert_states(sh, ref, fields=("vel",))


MG = SETTINGS.replace(
    matrix_solver=tset.MatrixSolverSettings(
        solver_type=tset.SolutionMethod.MULTIGRID,
        iterations=30,
        multigrid_levels=2,
        multigrid_smoother_iterations=4,
        preconditioner=tset.PreconditionMethod.JACOBI,
    )
)


def test_sharded_amg_matches_single_device_irregular():
    """Algebraic multigrid on an irregular mesh: the fine level
    distributed, the level-0 Galerkin product and residual summed from
    owned rows, the coarse correction replicated."""
    _, mesh = compiled_both(permuted_arrays(14, seed=5)[0])
    table = both("permuted")[1][1]
    ref, sh, _ = _steady_pair(
        mesh, table, MG, 1.0, 0.01, 15, n_devices=4, partition_method="rcb",
        use_ck=False,
    )
    _assert_states(sh, ref)


@pytest.mark.parametrize("ck", [False, "auto"])
def test_sharded_gmg_matches_single_device(ck):
    """tests/test_gmg.py's sharded case: geometric multigrid on the 8x8
    box, fine level distributed, coarse levels replicated."""
    mesh, table = case()
    mg = MG.replace(
        matrix_solver=tset.MatrixSolverSettings(
            solver_type=tset.SolutionMethod.MULTIGRID,
            iterations=25,
            multigrid_levels=3,
            multigrid_smoother_iterations=5,
            preconditioner=tset.PreconditionMethod.JACOBI,
        )
    )
    ref, sh, _ = _steady_pair(
        mesh, table, mg, 1000.0, 0.001, 20, n_devices=4, use_ck=ck,
        ref_ck=ck,
    )
    _assert_states(sh, ref)


def test_sharded_tables_hold_only_owned_entries():
    """A partition's transfer tables are as wide as the most entries one
    coarse slot takes from its owned rows (at most 8 fine cells x 4
    entries on a 3-D box), whatever share of its window is ghost or
    padding."""
    from orc_tpu_torch.solver.gmg import (
        _coarse_tables,
        build_gmg_hierarchy,
        infer_box_dims,
    )

    mesh, _ = case(nx=4, ny=4, nz=8)
    part = tpart.partition_mesh(mesh, 4, method="slab")
    level = build_gmg_hierarchy(
        infer_box_dims(mesh.neighbor_offsets, mesh.n_cells), mesh.neighbor_offsets,
        MG.matrix_solver,
    )[0]
    K = len(mesh.neighbor_offsets)
    for p in range(4):
        gal, res = _coarse_tables(
            level, torch.tensor(part.owned_mask[p]), torch.tensor(part.owned_global[p]), K
        )
        assert gal.src.shape[1] <= 8 * 4 and res.src.shape[1] <= 8


def _fc_settings():
    return SETTINGS.replace(
        velocity_interpolation=tset.VelocityInterpolation.RHIE_CHOW,
        pressure_velocity_coupling=tset.PressureVelocityCoupling.SIMPLE_FC,
        relaxation_mode=tset.RelaxationMode.IMPLICIT,
        momentum_relaxation=0.6,
        pressure_relaxation=0.3,
    )


@pytest.mark.parametrize("ck", [False, "auto"])
def test_fc_sharded_matches_single_device(ck):
    """SIMPLE_FC on both local steps: each partition seeds its own flux
    from refreshed fields, and every reduction and refresh rides the
    comm hooks."""
    mesh, table = case()
    table.set("BOTTOM_WALL", TFC.WALL)
    ref, sh, _ = _steady_pair(
        mesh, table, _fc_settings(), 1000.0, 0.001, 30, n_devices=4,
        use_ck=ck, ref_ck=ck,
    )
    _assert_states(sh, ref, dict(rtol=1e-8, atol=1e-14), ("vel",))
    _assert_states(sh, ref, TOL, ("p",))


@pytest.mark.parametrize("coupling", ["SIMPLE", "SIMPLE_FC"])
def test_sharded_transient_matches_single_device(coupling):
    """tests/test_transient.py's sharded case (the 4x12 Couette start-
    up), both couplings, here at the steady tolerance."""
    from orc_tpu_torch.solver.transient import solve_transient, solve_transient_sharded

    mesh, table = tbox(4, 12, 1, lengths=(4e-4, 1e-3, 1e-4), device="cpu")
    table.set("TOP_WALL", TFC.WALL, vector_value=(1e-3, 0, 0))
    table.set("BOTTOM_WALL", TFC.WALL)
    table.set("INLET", TFC.PRESSURE_INLET, scalar_value=0.0)
    table.set("OUTLET", TFC.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", TFC.SYMMETRY)
    table.set("PERIODIC_+Z", TFC.SYMMETRY)
    s = SETTINGS.replace(momentum_relaxation=0.8, pressure_relaxation=0.2)
    if coupling == "SIMPLE_FC":
        s = s.replace(
            pressure_velocity_coupling=tset.PressureVelocityCoupling.SIMPLE_FC,
            pressure_relaxation=0.3,
        )
    kw = dict(dt=0.005, n_steps=4, inner_iterations=6, verbose=False)
    s1, m1 = solve_transient(mesh, table, s, 1.0, 1e-3, **kw)
    s4, m4 = solve_transient_sharded(
        mesh, table, s, 1.0, 1e-3, n_devices=4, report_interval=3, **kw
    )
    _assert_states(s4, s1)
    assert m4.vel_avg.shape == m1.vel_avg.shape


def _channel(nx=16, ny=12):
    """test_torch_turbulence.py channel(): the developing channel."""
    mesh, table = tbox(nx, ny, 1, lengths=(8.0, 2.0, 0.5), device="cpu")
    table.set("TOP_WALL", TFC.WALL)
    table.set("BOTTOM_WALL", TFC.WALL)
    table.set("INLET", TFC.VELOCITY_INLET, vector_value=(1.0, 0, 0))
    table.set("OUTLET", TFC.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", TFC.SYMMETRY)
    table.set("PERIODIC_+Z", TFC.SYMMETRY)
    return mesh, table


RANS_SETTINGS = SETTINGS.replace(momentum_relaxation=0.6, pressure_relaxation=0.05)
RANS_KW = dict(u_ref=1.0, intensity=0.05, length_scale=0.14, verbose=False)


@pytest.mark.parametrize("method", ["slab", "rcb"])
def test_sharded_turbulent_matches_single_device(method):
    """k-epsilon RANS on the 16x12 developing channel: the sharded outer
    step refreshes the flow and k, eps and mu_t, and completes all four
    solves' reductions. Two outer iterations, as orc_tpu's tight check
    takes one: the reduction order alone moves the third iteration's
    fields by 7e-11 of their scale and k by 2e-10 (the same inner
    iteration counts), and this channel amplifies such gaps, as it parts
    the port from orc_tpu after iteration 12 (ROADMAP Queue 3)."""
    from orc_tpu_torch.solver.turbulence import (
        solve_steady_turbulent,
        solve_steady_turbulent_sharded,
    )

    mesh, table = _channel()
    kw = dict(iterations=2, reporting_interval=2, **RANS_KW)
    f1, t1, _ = solve_steady_turbulent(mesh, table, RANS_SETTINGS, 1.0, 1e-5, **kw)
    f4, t4, _ = solve_steady_turbulent_sharded(
        mesh, table, RANS_SETTINGS, 1.0, 1e-5, n_devices=4,
        partition_method=method, **kw,
    )
    _assert_states(f4, f1)
    for name in ("k", "eps", "mu_t"):
        np.testing.assert_allclose(np_(getattr(t4, name)), np_(getattr(t1, name)), **TOL)


def test_sharded_matches_orc_tpu_sharded():
    """The port's sharded run against orc_tpu's sharded run on its
    virtual CPU devices: same mesh, same partitions."""
    (mj, tj), (mt, tt) = case("jax"), case("torch")
    kw = dict(iterations=20, reporting_interval=20, verbose=False, n_devices=4)
    js_, _ = jsh.solve_steady_sharded(
        mj, tj, to_jax_settings(SETTINGS), 1000.0, 0.001,
        state=jsimple.initial_state(mj), **kw,
    )
    ts_, _ = tsh.solve_steady_sharded(
        mt, tt, SETTINGS, 1000.0, 0.001, state=tsimple.initial_state(mt), **kw
    )
    for f in ("vel", "p"):
        np.testing.assert_allclose(
            np_(getattr(ts_, f)), np.asarray(getattr(js_, f)), rtol=1e-8, atol=1e-12
        )


def test_solve_cavity_sharded_runs():
    from orc_tpu_torch.models.cavity import solve_cavity

    one = solve_cavity(n=8, iterations=6, reporting_interval=3, verbose=False, device="cpu")
    two = solve_cavity(
        n=8, iterations=6, reporting_interval=3, n_devices=2, verbose=False, device="cpu"
    )
    _assert_states(two["state"], one["state"])
    assert len(two["history"]) == 2


# --- the rendezvous --------------------------------------------------------


def _comms(n):
    mesh, _ = case()
    part = tpart.partition_mesh(mesh, n)
    group = tsh.ShardGroup(n)
    return part, group, tsh.make_comms(part, group)


def test_reductions_give_every_partition_the_same_bits():
    n = 4
    part, group, comms = _comms(n)
    rng = np.random.default_rng(3)
    vals = [torch.tensor(rng.standard_normal(3)) for _ in range(n)]

    def work(r):
        c = comms[r]
        return (
            c.axis_sum(vals[r]), c.axis_min(vals[r]), c.axis_max(vals[r]),
            c.axis_max(vals[r] > 1.0), c.axis_sum(torch.tensor(r + 1)),
        )

    out = tsh.run_partitions(part.devices, work, group)
    total = vals[0] + vals[1] + vals[2] + vals[3]
    for res in out:
        assert torch.equal(res[0], total)
        assert torch.equal(res[1], torch.stack(vals).amin(0))
        assert torch.equal(res[2], torch.stack(vals).amax(0))
        assert torch.equal(res[3], (torch.stack(vals) > 1.0).any(0))
        assert int(res[4]) == 10


def test_rendezvous_under_thread_switching():
    """More partitions than cores, the interpreter switching threads
    every microsecond: every partition gets the exact partition-order
    sum of every one of 200 reductions and the right halo values of 50
    exchanges, and no launch count is lost: the kernel wrappers bump
    their counters from every partition's thread with a plain `+= 1`,
    which the turn-taking keeps to one thread at a time."""
    import sys

    n = 12
    group = tsh.ShardGroup(n)

    class Counted:
        launches = 0

    def work(r):
        out = []
        for i in range(200):
            got = group.reduce(r, torch.tensor([float(r * 1000 + i)]), torch.add)
            out.append(float(got))
            Counted.launches += 1
        for i in range(50):
            got = group.exchange(r, [torch.tensor([r, i])], (1,))
            assert got[0].tolist() == [(r - 1) % n, i]
        return out

    interval = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-6)
        out = tsh.run_partitions([torch.device("cpu")] * n, work, group)
    finally:
        sys.setswitchinterval(interval)
    want = [float(sum(r * 1000 + i for r in range(n))) for i in range(200)]
    assert all(o == want for o in out)
    assert Counted.launches == 200 * n


def _ended_within(fn, seconds=30):
    """fn()'s exception, raised within `seconds` (the test fails on a
    hang)."""
    box = {}

    def run():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001
            box["e"] = e

    t = threading.Thread(target=run, daemon=True)
    t0 = time.perf_counter()
    t.start()
    t.join(seconds)
    assert not t.is_alive(), "the sharded run hung"
    assert time.perf_counter() - t0 < seconds
    return box.get("e")


def test_a_failing_partition_ends_the_run():
    n = 4
    part, group, comms = _comms(n)

    def work(r):
        x = torch.ones(3, dtype=torch.float64)
        for i in range(10):
            if r == 1 and i == 3:
                raise ValueError("partition 1 failed")
            x = comms[r].axis_sum(x) / n
        return x

    e = _ended_within(lambda: tsh.run_partitions(part.devices, work, group))
    assert isinstance(e, ValueError) and "partition 1" in str(e)


def test_a_partition_that_diverges_ends_the_run(monkeypatch):
    """SolverDivergedError raised in one partition's step ends the
    sharded run with that error; the other partitions stop at their
    next collective."""
    mesh, table = case()
    real = tsimple.ck_simple_step
    calls = {}

    def step(*a, comm=None, **k):
        calls[comm.rank] = calls.get(comm.rank, 0) + 1
        if comm.rank == 2 and calls[2] == 3:
            raise tsimple.SolverDivergedError(3)
        return real(*a, comm=comm, **k)

    monkeypatch.setattr(tsimple, "ck_simple_step", step)
    e = _ended_within(
        lambda: tsh.solve_steady_sharded(
            mesh, table, SETTINGS, 1000.0, 0.001, iterations=10,
            reporting_interval=10, n_devices=4, verbose=False,
        )
    )
    assert isinstance(e, tsimple.SolverDivergedError) and e.iteration == 3


def test_different_collectives_end_the_run():
    n = 3
    part, group, comms = _comms(n)

    def work(r):
        x = torch.ones(2, dtype=torch.float64)
        for _ in range(3 if r else 4):  # partition 0 calls one more
            x = comms[r].axis_sum(x)
        return x

    e = _ended_within(lambda: tsh.run_partitions(part.devices, work, group))
    assert isinstance(e, tsh.ShardAborted)


# --- the kernel gate under sharding -----------------------------------------


@pytest.mark.parametrize("fc", [False, True])
def test_kernel_gate_sharded_matches_orc_tpu(monkeypatch, fc):
    """_kernel_asm_spec(..., sharded=True) against orc_tpu's
    _pallas_asm_spec(..., sharded=True): the same configurations get a
    spec, with gg off (a slab's ghost layer is one plane deep)."""
    from orc_tpu.ops import ck_ops as jck

    from orc_tpu_torch.ops.ck_ops import build_ck_geometry

    monkeypatch.setenv("ORC_TPU_PALLAS_ASM", "force")
    monkeypatch.setattr(tsimple, "_on_cuda", lambda mesh: True)
    (mj, tj), (mt, tt) = both("cavity", "f32")
    ckj = jck.build_ck_geometry(mj, len(tj.zone_ids))
    ckt = build_ck_geometry(mt, len(tt.zone_ids))
    admitted = 0
    for vi in tset.VelocityInterpolation:
        for pi in tset.PressureInterpolation:
            s = tset.NumericalSettings(
                momentum=tset.MomentumScheme.CD1,
                velocity_interpolation=vi, pressure_interpolation=pi,
                relaxation_mode=tset.RelaxationMode.IMPLICIT,
            )
            ref = jsimple._pallas_asm_spec(
                mj, tj, to_jax_settings(s), ckj, fc=fc, sharded=True
            )
            got = tsimple._kernel_asm_spec(mt, tt, s, ckt, fc=fc, sharded=True)
            assert (got is None) == (ref is None), (vi, pi)
            if got is None:
                continue
            admitted += 1
            for f in ("scheme", "rc", "p_so", "vol", "gg"):
                assert getattr(got[1], f) == getattr(ref[1], f), f
            assert not got[1].gg
    assert admitted == 9


@pytest.mark.parametrize(
    "dims,n_parts,boxes",
    [
        ((8, 8, 1), 2, [(8, 7, 1, 0)] * 2),
        ((8, 8, 1), 4, [(8, 5, 1, 0)] * 4),
        # 22 cells a partition: windows start 0, 6 and 4 cells into a row
        ((8, 8, 1), 3, [(8, 5, 1, 0), (8, 6, 1, 6), (8, 6, 1, 4)]),
        ((4, 4, 8), 4, [(4, 4, 5, 0)] * 4),
        ((16, 4, 1), 4, [(16, 4, 1, 0)] * 4),
        # 115 cells a partition of 7 x 7 x 7: planes of 49 cells
        ((7, 7, 7), 3, [(7, 7, 5, 0), (7, 7, 5, 17), (7, 7, 6, 34)]),
    ],
)
def test_slab_kernel_box(dims, n_parts, boxes):
    """The box of each slab window: the global box with its slowest axis
    cut to the planes that hold the window's rows (both ghost layers and
    the trash row), row0 the window's first row's place in its plane,
    whether or not the partition holds a whole number of planes."""
    from orc_tpu_torch.ops.fused_assembly import column_specs, kernel_box

    mesh, table = case("torch", *dims)
    part = tpart.partition_mesh(mesh, n_parts, method="slab")
    cols = column_specs(mesh, table)
    got = tsh.slab_kernel_box(mesh, part, cols)
    assert got == tuple(boxes)
    L = part.local_size
    for box in got:
        assert kernel_box(cols, L, box) == box
        nx, ny, nz, row0 = box
        assert row0 + L <= nx * ny * nz < row0 + L + nx * ny
    nx, ny, nz, row0 = got[-1]
    for bad in ((nx, ny, nz - 1, row0), (nx, ny, nz + 1, row0), (nx, ny, nz, nx * ny)):
        with pytest.raises(ValueError, match="box"):
            kernel_box(cols, L, bad)


# --- signatures --------------------------------------------------------------


def _hook_pairs():
    import orc_tpu.models.cavity as jcav
    import orc_tpu.solver.amg as ja
    import orc_tpu.solver.fc as jf
    import orc_tpu.solver.gmg as jg
    import orc_tpu.solver.krylov as jk
    import orc_tpu.solver.refine as jr
    import orc_tpu.solver.turbulence as jt

    import orc_tpu_torch.models.cavity as tcav
    import orc_tpu_torch.solver.amg as ta
    import orc_tpu_torch.solver.fc as tf
    import orc_tpu_torch.solver.gmg as tg
    import orc_tpu_torch.solver.krylov as tk
    import orc_tpu_torch.solver.refine as tr
    import orc_tpu_torch.solver.turbulence as tt

    names = {
        (jk, tk): [
            "constant_deflation", "_mv", "jacobi_solve", "jacobi_smooth_solve",
            "bicgstab_solve", "gauss_seidel_solve", "iterative_solve",
        ],
        (jr, tr): ["df32_ir_solve"],
        (jsimple, tsimple): [
            "_refresh_rows", "_solve_p_prime", "simple_step", "ck_simple_step",
        ],
        (jf, tf): ["simple_step_fc", "ck_simple_step_fc"],
        (jg, tg): ["gmg_solve", "_gmg_correction", "_local_coarse_contrib", "gmg_solve_sharded"],
        (ja, ta): ["_smooth", "multigrid_solve", "multigrid_solve_sharded", "_mg_correction"],
        (jt, tt): ["turbulence_step", "rans_outer_step", "solve_steady_turbulent_sharded"],
        (jsh, tsh): [
            "scatter_state", "gather_state", "solve_steady_sharded",
            "solve_transient_sharded", "_refresh_state",
        ],
        (jpart, tpart): ["rcb_partition", "partition_mesh"],
        (jcav, tcav): ["solve_cavity"],
    }
    for (jm, tm), fns in names.items():
        for fn in fns:
            yield f"{tm.__name__.split('.', 1)[1]}.{fn}", getattr(jm, fn), getattr(tm, fn)
    yield "parallel.sharded.ShardedComm", jsh.ShardedComm.__init__, tsh.ShardedComm.__init__
    yield "solver.simple._kernel_asm_spec", jsimple._pallas_asm_spec, tsimple._kernel_asm_spec


HOOK_SIGNATURES = list(_hook_pairs())
#: Names the port gives orc_tpu's parameters: its kernels are no Pallas
#: calls.
RENAMED = {"pallas_asm": "kernel_asm"}
#: Parameters only the port has, last: the placement of partitions and
#: tensors (devices, device, dtype) and the rendezvous of a comm.
PORT_ADDED = {"devices", "device", "dtype", "group", "rank"}


@pytest.mark.parametrize(
    "label,jf,tf", HOOK_SIGNATURES, ids=[s[0] for s in HOOK_SIGNATURES]
)
def test_hooked_signatures_match_orc_tpu(label, jf, tf):
    """Every step and solver that takes orc_tpu's sharded hooks keeps
    orc_tpu's parameter names and order, the hooks included."""
    import inspect

    j = [RENAMED.get(n, n) for n in inspect.signature(jf).parameters]
    t = list(inspect.signature(tf).parameters)
    assert t[: len(j)] == j, (j, t)
    assert set(t[len(j):]) <= PORT_ADDED, t[len(j):]


def test_make_sharded_step_signature():
    """orc_tpu's parameters but its device mesh (the partition carries its
    devices), with pallas_asm named kernel_asm."""
    import inspect

    j = [
        RENAMED.get(n, n) for n in inspect.signature(jsh.make_sharded_step).parameters
        if n != "device_mesh"
    ]
    assert list(inspect.signature(tsh.make_sharded_step).parameters) == j
