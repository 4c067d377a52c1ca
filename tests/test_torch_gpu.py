"""The port's CUDA kernels on the card, each against its plain torch
version (the exact slice product bitwise; the momentum kernels also in
their transient instances), the SIMPLE and SIMPLE_FC slices on CUDA
against the same slices on CPU, on structured boxes and on permuted
(irregular) cavities, steady, transient and under MULTIGRID, and a
DF32_IR solve.

Every test here is marked `gpu` and skips where torch.cuda.is_available()
is false. The file imports neither JAX nor orc_tpu, so it runs on a GPU
machine without them:

    ORC_TPU_TEST_CACHE= python -m pytest tests/test_torch_gpu.py -m gpu -q

Tolerances: float64 rtol 1e-12 and float32 rtol 1e-5 of the largest
reference magnitude (the kernels keep the plain versions' order of
operations; nvcc contracts multiply-adds into FMAs, and reductions over
columns may associate differently).
"""

import numpy as np
import pytest
import torch

from orc_tpu_torch.models.cavity import (
    cavity_case,
    default_settings,
    flagship_settings,
)
from orc_tpu_torch.models.channel_flow import ChannelFlowParameters, couette_case
from orc_tpu_torch.ops import fused_assembly as asm
from orc_tpu_torch.ops.ck_ops import (
    build_ck_geometry,
    ck_bc,
    ck_flux,
    ck_pressure_gradient,
    ck_velocity_gradient,
)
from orc_tpu_torch.ops.fields import device_bc
from orc_tpu_torch.ops.fused_smooth import fused_jacobi_sweeps, sweeps_plain
from orc_tpu_torch.ops.shift_spmv import shift_spmv, shift_spmv_plain
from orc_tpu_torch.solver import simple
from orc_tpu_torch.utils import settings as tset

pytestmark = pytest.mark.gpu

DTYPES = {"f64": torch.float64, "f32": torch.float32}
TOL = {"f64": 1e-12, "f32": 1e-5}
KERNELS = (shift_spmv, fused_jacobi_sweeps, asm.momentum_assembly, asm.pc_assembly)
FC_KERNELS = (
    shift_spmv, fused_jacobi_sweeps, asm.fc_momentum_assembly, asm.fc_pc_assembly
)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _close(actual, desired, rtol, name=""):
    d = desired.detach().double().cpu().numpy()
    np.testing.assert_allclose(
        actual.detach().double().cpu().numpy(), d, rtol=rtol,
        atol=rtol * float(np.max(np.abs(d))), err_msg=name,
    )


def _system(C, offsets, B, dtype, dev, seed=0):
    """Seeded diagonally dominant system with off == 0 wherever
    c + d strays outside [0, C) (the EllMatrix offsets contract)."""
    rng = np.random.default_rng(seed)
    off = rng.uniform(-1.0, 0.0, size=(C, len(offsets)))
    c = np.arange(C)
    for k, d in enumerate(offsets):
        off[((c + d) < 0) | ((c + d) >= C) | (d == 0), k] = 0.0
    diag = 1.0 + np.abs(off).sum(axis=1) + rng.random(C)
    shape = (B, C) if B else (C,)
    arrays = (diag, off, rng.standard_normal(shape), rng.standard_normal(shape))
    return [torch.tensor(a, dtype=dtype, device=dev) for a in arrays]


@pytest.mark.parametrize("split", [False, True], ids=["ck", "split"])
@pytest.mark.parametrize("batch", [0, 3])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_shift_spmv_kernel_matches_plain(dev, dtype, batch, split):
    """Guards orc_tpu/ops/pallas_spmv.py `_kernel` (via shift_spmv)."""
    offsets = (-64, -1, 1, 64, 0, 0)
    diag, off, _b, x = _system(64 * 50, offsets, batch, DTYPES[dtype], dev)
    o = tuple(off[:, k] for k in range(6)) if split else off
    before = shift_spmv.launches
    y = shift_spmv(diag, o, offsets, x)
    torch.cuda.synchronize()
    assert shift_spmv.launches == before + 1
    _close(y, shift_spmv_plain(diag, off, offsets, x), TOL[dtype])


#: name -> (C, offsets, batch, x an offset view): the edges of the
#: vectorised stencil kernel. An odd C starts every split plane after
#: the first unaligned; an offset view of x starts unaligned; a 24^2 x 6
#: box's +-576 lies beyond the shared-memory window; B = 3 with a ragged
#: C starts batch rows 1 and 2 unaligned.
SPMV_EDGES = {
    "odd_c": (33 * 31, (-33, -1, 1, 33), 0, False),
    "offset_x": (40 * 30, (-40, -1, 1, 40), 0, True),
    "k6_3d": (24 * 24 * 6, (-576, -24, -1, 1, 24, 576), 0, False),
    "b3_ragged": (1001, (-13, -1, 1, 13), 3, False),
}


@pytest.mark.parametrize("case", sorted(SPMV_EDGES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_shift_spmv_kernel_edges(dev, dtype, case):
    """Guards orc_tpu/ops/pallas_spmv.py `_kernel` (via shift_spmv) at
    the edges of the kernel's 16-byte loads and shared-memory window,
    split planes against the plain version."""
    C, offsets, batch, view = SPMV_EDGES[case]
    diag, off, _b, x = _system(C, offsets, batch, DTYPES[dtype], dev)
    if view:
        buf = torch.zeros(x.numel() + 1, dtype=x.dtype, device=dev)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(x.shape)
    planes = off.T.contiguous()
    before = shift_spmv.launches
    y = shift_spmv(diag, tuple(planes), offsets, x)
    torch.cuda.synchronize()
    assert shift_spmv.launches == before + 1
    _close(y, shift_spmv_plain(diag, off, offsets, x), TOL[dtype])


def test_shift_spmv_kernel_refuses_a_batched_matrix(dev):
    """Guards orc_tpu/ops/pallas_spmv.py `_kernel`'s contract: a matrix
    is shared by the batch (diag [C], [C] columns) or held per row (diag
    [B,C], [B,C] columns); a CUDA call mixing the two raises."""
    diag, off, _b, x = _system(100, (-10, -1, 1, 10), 3, torch.float64, dev)
    with pytest.raises(ValueError):
        shift_spmv(diag.expand(3, -1), off, (-10, -1, 1, 10), x)


def _per_row(C, offsets, B, dtype, dev, seed=0):
    """One seeded system per batch row: diag [B,C], K columns [B,C]
    (views of [B,C,K] coefficients over contiguous [B,K,C] storage, the
    layout ck_momentum gives), b and x [B,C]."""
    rows = [_system(C, offsets, 0, dtype, dev, seed + r) for r in range(B)]
    diag = torch.stack([r[0] for r in rows])
    off = torch.stack([r[1] for r in rows]).permute(0, 2, 1).contiguous().transpose(1, 2)
    b, x = (torch.stack([r[i] for r in rows]) for i in (2, 3))
    return diag, tuple(off[..., k] for k in range(len(offsets))), b, x


#: name -> (box, periodic axes, batch): the per-row instances of rows 1
#: and 2 on a 2-D box, a ragged C (batch rows 1 and up start unaligned),
#: a 3-D box whose +-576 lies beyond the shift SpMV's window, a periodic
#: box and B = 1 and 4.
PER_ROW_CASES = {
    "2d_b3": ((64, 50, 1), (), 3),
    "ragged_b3": ((13, 77, 1), (), 3),
    "k6_3d_b3": ((24, 24, 6), (), 3),
    "periodic_b3": ((24, 20, 1), ("x", "y"), 3),
    "2d_b1": ((64, 50, 1), (), 1),
    "2d_b4": ((37, 23, 1), (), 4),
}


def _per_row_case(case, dtype, dev, seed=0):
    shape, periodic, B = PER_ROW_CASES[case]
    offsets = _box_offsets(shape, periodic)
    C = shape[0] * shape[1] * shape[2]
    return (C, offsets, B) + tuple(_per_row(C, offsets, B, DTYPES[dtype], dev, seed))


@pytest.mark.parametrize("case", sorted(PER_ROW_CASES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_per_row_shift_spmv_kernel_matches_plain(dev, dtype, case):
    """Guards orc_tpu/ops/pallas_spmv.py `_kernel` (via shift_spmv's
    per-row instance): one matrix per batch row, strided and contiguous
    columns, against the plain version; equal rows give the shared
    instance's bits."""
    C, offsets, B, diag, cols, _b, x = _per_row_case(case, dtype, dev)
    for form in (cols, tuple(c.contiguous() for c in cols)):
        before = (shift_spmv.launches, shift_spmv.per_row_launches)
        y = shift_spmv(diag, form, offsets, x)
        torch.cuda.synchronize()
        assert (shift_spmv.launches, shift_spmv.per_row_launches) == (
            before[0] + 1, before[1] + 1
        )
        _close(y, shift_spmv_plain(diag, form, offsets, x), TOL[dtype])
    same = shift_spmv(
        diag[:1].expand(B, -1).contiguous(),
        tuple(c[:1].expand(B, -1).contiguous() for c in cols), offsets, x,
    )
    shared = shift_spmv(diag[0].contiguous(), tuple(c[0].contiguous() for c in cols), offsets, x)
    torch.cuda.synchronize()
    assert torch.equal(same, shared)


@pytest.mark.parametrize("case", sorted(PER_ROW_CASES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_per_row_sweeps_kernel_matches_plain(dev, dtype, case):
    """Guards orc_tpu/ops/pallas_smooth.py `_kernel` (via
    fused_jacobi_sweeps' per-row instances): six sweeps, in one launch of
    the per-row tiles on a 2-D box and a launch each on 3-D and periodic
    boxes, against the plain sweeps and bitwise against the per-sweep
    per-row kernel; equal rows give the shared per-sweep instance's
    bits."""
    from orc_tpu_torch.ops import fused_smooth as fs

    C, offsets, B, diag, cols, b, x0 = _per_row_case(case, dtype, dev, seed=4)
    shape, periodic, _B = PER_ROW_CASES[case]
    launches = 6 if shape[2] > 1 or periodic else 1
    before = (fused_jacobi_sweeps.launches, fused_jacobi_sweeps.per_row_launches)
    y = fused_jacobi_sweeps(diag, cols, offsets, b, x0, 6, 0.8)
    torch.cuda.synchronize()
    assert (fused_jacobi_sweeps.launches, fused_jacobi_sweeps.per_row_launches) == (
        before[0] + launches, before[1] + launches
    )
    _close(y, sweeps_plain(diag, cols, offsets, b, x0, 6, 0.8), TOL[dtype])
    per_sweep = fs._launch_sweeps(
        diag, cols, offsets, b, x0, 6, 0.8, fs.SweepPlan(per_row=True)
    )
    torch.cuda.synchronize()
    assert torch.equal(y, per_sweep)
    plan = fs.sweep_plan(offsets, C, 6, DTYPES[dtype], depth=0, per_row=True)
    same = fs._launch_sweeps(
        diag[:1].expand(B, -1), tuple(c[:1].expand(B, -1) for c in cols),
        offsets, b, x0, 6, 0.8, plan,
    )
    shared = fs._launch_sweeps(
        diag[0].contiguous(), tuple(c[0].contiguous() for c in cols), offsets,
        b, x0, 6, 0.8, fs.SweepPlan(),
    )
    torch.cuda.synchronize()
    assert torch.equal(same, shared)


@pytest.mark.parametrize("sweeps", [1, 6])
@pytest.mark.parametrize("batch", [0, 3])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_jacobi_sweeps_kernel_matches_plain(dev, dtype, batch, sweeps):
    """Guards orc_tpu/ops/pallas_smooth.py `_kernel` (via
    fused_jacobi_sweeps -> _fused_batched): on a 2-D box every sweep in
    one tiled launch."""
    offsets = (-64, -1, 1, 64)
    diag, off, b, x0 = _system(64 * 50, offsets, batch, DTYPES[dtype], dev, 1)
    before = fused_jacobi_sweeps.launches
    y = fused_jacobi_sweeps(diag, off, offsets, b, x0, sweeps, 0.8)
    torch.cuda.synchronize()
    assert fused_jacobi_sweeps.launches == before + 1
    _close(y, sweeps_plain(diag, off, offsets, b, x0, sweeps, 0.8), TOL[dtype])


def _box_offsets(shape, periodic=()):
    from orc_tpu_torch.mesh.generate import structured_box_mesh

    mesh, _ = structured_box_mesh(*shape, periodic=periodic, device="cpu")
    return tuple(int(o) for o in mesh.neighbor_offsets if int(o) != 0)


#: name -> (box, periodic axes, batch, sweeps, launches of the call):
#: the instances of the Jacobi sweeps and their edges. A 2-D box takes
#: every sweep in one tiled launch (three batch rows a launch); an axis
#: of extent 1 drops out of the tiles; a 3-D box marches along z, up to
#: three sweeps a launch in even passes (three batch rows a launch);
#: periodic boxes take a launch per sweep (fused_smooth.sweep_plan).
SWEEP_EDGES = {
    "2d_sweeps1": ((64, 50, 1), (), 3, 1, 1),
    "2d_sweeps7": ((64, 50, 1), (), 3, 7, 1),
    "2d_sweeps9_b4": ((37, 23, 1), (), 4, 9, 4),
    "extent1_axis": ((40, 1, 30), (), 3, 6, 1),
    "periodic": ((24, 20, 1), ("x", "y"), 3, 6, 6),
    "cube128": ((128, 128, 128), (), 3, 6, 2),
    "3d_ragged_sweeps5_b4": ((37, 23, 19), (), 4, 5, 4),
    "3d_sweeps1_b1": ((19, 11, 7), (), 0, 1, 1),
}


@pytest.mark.parametrize("case", sorted(SWEEP_EDGES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_jacobi_sweeps_kernel_edges(dev, dtype, case):
    """Guards orc_tpu/ops/pallas_smooth.py `_kernel` at the edges of the
    tiled instance, the march and the per-sweep one: against the plain
    sweeps, with the launches each instance makes."""
    shape, periodic, batch, sweeps, launches = SWEEP_EDGES[case]
    offsets = _box_offsets(shape, periodic)
    C = shape[0] * shape[1] * shape[2]
    diag, off, b, x0 = _system(C, offsets, batch, DTYPES[dtype], dev, 2)
    cols = tuple(off.T.contiguous())
    before = fused_jacobi_sweeps.launches
    y = fused_jacobi_sweeps(diag, cols, offsets, b, x0, sweeps, 0.7)
    torch.cuda.synchronize()
    assert fused_jacobi_sweeps.launches == before + launches
    _close(y, sweeps_plain(diag, cols, offsets, b, x0, sweeps, 0.7), TOL[dtype])


@pytest.mark.parametrize("depth", [1, 2, 6])
@pytest.mark.parametrize("shape", [(37, 23, 1), (300, 7, 1), (19, 11, 7)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tiled_sweeps_equal_per_sweep_bitwise(dev, dtype, shape, depth):
    """Guards orc_tpu/ops/pallas_smooth.py `_kernel`: the tiled instance
    at `depth` sweeps a launch bit for bit the per-sweep kernel's result
    (the same contraction, spelt out), on ragged 2-D and 3-D tiles."""
    from orc_tpu_torch.ops import fused_smooth as fs

    offsets = _box_offsets(shape)
    C = shape[0] * shape[1] * shape[2]
    diag, off, b, x0 = _system(C, offsets, 3, DTYPES[dtype], dev, 3)
    cols = tuple(off.T.contiguous())
    if depth == 6 and shape[2] > 1:
        with pytest.raises(ValueError):
            fs.sweep_plan(offsets, C, 6, DTYPES[dtype], depth=depth)
        return
    plan = fs.sweep_plan(offsets, C, 6, DTYPES[dtype], depth=depth)
    y = fs._launch_sweeps(diag, cols, offsets, b, x0, 6, 0.8, plan)
    per_sweep = fs._launch_sweeps(diag, cols, offsets, b, x0, 6, 0.8, fs.SweepPlan())
    torch.cuda.synchronize()
    assert torch.equal(y, per_sweep)


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("shape", [(19, 11, 7), (37, 23, 19)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_march_equals_per_sweep_bitwise(dev, dtype, shape, depth):
    """Guards orc_tpu/ops/pallas_smooth.py `_kernel` on 3-D boxes: the
    z-march at `depth` sweeps a launch, in the windows march_shape picks
    and in small ones (ragged xy tiles, several z-chunks), bit for bit
    the per-sweep kernel's result (the same contraction, spelt out)."""
    from orc_tpu_torch.ops import fused_smooth as fs

    offsets = _box_offsets(shape)
    C = shape[0] * shape[1] * shape[2]
    diag, off, b, x0 = _system(C, offsets, 3, DTYPES[dtype], dev, 5)
    cols = tuple(off.T.contiguous())
    per_sweep = fs._launch_sweeps(diag, cols, offsets, b, x0, 6, 0.8, fs.SweepPlan())
    picked = fs.sweep_plan(offsets, C, 6, DTYPES[dtype], depth=depth, march=True)
    small = fs.SweepPlan(depth, shape, (7, 5, 3), march=True)
    for plan in (picked, small):
        y = fs._launch_sweeps(diag, cols, offsets, b, x0, 6, 0.8, plan)
        torch.cuda.synchronize()
        assert torch.equal(y, per_sweep), plan.label()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_march_on_the_128_cube_equals_per_sweep_bitwise(dev, dtype):
    """Guards orc_tpu/ops/pallas_smooth.py `_kernel` at cavity3d-128's
    smoother shape (K = 6, B = 3, six sweeps): the instance sweep_plan
    picks against the plain sweeps and bitwise against the per-sweep
    kernel."""
    from orc_tpu_torch.ops import fused_smooth as fs

    shape = (128, 128, 128)
    offsets = _box_offsets(shape)
    C = 128**3
    diag, off, b, x0 = _system(C, offsets, 3, DTYPES[dtype], dev, 6)
    cols = tuple(off.T.contiguous())
    plan = fs.sweep_plan(offsets, C, 6, DTYPES[dtype])
    assert plan.march
    y = fused_jacobi_sweeps(diag, cols, offsets, b, x0, 6, 0.8)
    per_sweep = fs._launch_sweeps(diag, cols, offsets, b, x0, 6, 0.8, fs.SweepPlan())
    torch.cuda.synchronize()
    assert torch.equal(y, per_sweep)
    _close(y, sweeps_plain(diag, cols, offsets, b, x0, 6, 0.8), TOL[dtype])


@pytest.mark.parametrize("depth", [1, 2, 6])
@pytest.mark.parametrize("case", ["2d_b3", "ragged_b3", "2d_b4"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_per_row_tiled_sweeps_equal_per_sweep_bitwise(dev, dtype, case, depth):
    """Guards orc_tpu/ops/pallas_smooth.py `_kernel` with one matrix per
    batch row: the per-row tiles at `depth` sweeps a launch bit for bit
    the per-sweep per-row kernel's result."""
    from orc_tpu_torch.ops import fused_smooth as fs

    C, offsets, B, diag, cols, b, x0 = _per_row_case(case, dtype, dev, seed=7)
    plan = fs.sweep_plan(offsets, C, 6, DTYPES[dtype], depth=depth, per_row=True)
    assert plan.per_row and plan.launches(6, B) == -(-6 // depth)
    y = fs._launch_sweeps(diag, cols, offsets, b, x0, 6, 0.8, plan)
    per_sweep = fs._launch_sweeps(
        diag, cols, offsets, b, x0, 6, 0.8, fs.SweepPlan(per_row=True)
    )
    torch.cuda.synchronize()
    assert torch.equal(y, per_sweep)


def _asm_mesh(name, dtype, dev):
    if name == "cavity":
        return cavity_case(n=20, dtype=dtype, device=dev)
    if name == "cavity3d":
        return cavity_case(n=8, nz=8, dtype=dtype, device=dev)
    vinlet = 1e-3 if name == "vinlet" else None
    return couette_case(
        16, 8, params=ChannelFlowParameters(top_wall_velocity=5e-4, dp_dx=5.0),
        velocity_inlet=vinlet, dtype=dtype, device=dev,
    )


def _asm_case(name, dtype, dev):
    mesh, table = _asm_mesh(name, dtype, dev)
    _zc, zs, zv = device_bc(table, dtype=dtype, device=dev)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    rng = np.random.default_rng(3)
    C = mesh.n_cells
    vel = torch.tensor(rng.standard_normal((C, 3)) * 0.1, dtype=dtype, device=dev)
    p = torch.tensor(rng.standard_normal(C) * 0.05, dtype=dtype, device=dev)
    md = torch.tensor(rng.uniform(0.5, 2.0, C), dtype=dtype, device=dev)
    cols = asm.column_specs(mesh, table)
    flags = asm.pack_flags(ck.interior, ck.mask)
    return vel, p, md, asm.bc_value_table(zs, zv), flags, cols


@pytest.mark.parametrize("scheme", ["ud", "cd1"])
@pytest.mark.parametrize("case", ["cavity", "couette", "vinlet"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_assembly_kernels_match_plain(dev, dtype, case, scheme):
    """Guards orc_tpu/ops/pallas_assembly.py `_momentum_kernel` (via
    momentum_assembly) and `_pc_kernel` (via pc_assembly)."""
    vel, p, md, bcv, flags, cols = _asm_case(case, DTYPES[dtype], dev)
    spec = asm.AsmSpec(scheme=scheme)
    args = (vel, p, bcv, flags, cols, 1.0, 1e-3, 0.7)
    got = asm.momentum_assembly(*args, spec=spec)
    ref = asm.momentum_assembly_plain(*args, spec=spec)
    for name, a, r in zip(("diag", "off", "b"), got, ref):
        _close(a, r, TOL[dtype], "momentum " + name)
    pargs = (vel, md, bcv, flags, cols, 1.0)
    got = asm.pc_assembly(*pargs, spec=spec)
    ref = asm.pc_assembly_plain(*pargs, spec=spec)
    torch.cuda.synchronize()
    for name, a, r in zip(("diag", "off", "b"), got, ref):
        _close(a, r, TOL[dtype], "pc " + name)


#: (scheme, limiter) of the parity branch tests: every momentum kernel
#: instance family; each test runs the seven face-model instances of its
#: family (Linear, and Rhie-Chow / SecondOrder / both with a streamed or
#: in-kernel gradient).
PARITY_FAMILIES = {
    "ud": ("ud", None),
    "cd1": ("cd1", None),
    "tvd_dc-lud": ("tvd_dc", tset.tvd_lud),
    "tvd_dc-quick": ("tvd_dc", tset.tvd_quick),
    "tvd_dc-umist": ("tvd_dc", tset.tvd_umist),
}
FACE_MODELS = [
    (False, False, False), (True, False, False), (True, False, True),
    (False, True, False), (False, True, True), (True, True, False),
    (True, True, True),
]


@pytest.mark.parametrize("family", sorted(PARITY_FAMILIES))
@pytest.mark.parametrize("case", ["cavity", "cavity3d", "couette", "vinlet"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_parity_branch_kernels_match_plain(dev, dtype, case, family):
    """Guards orc_tpu/ops/pallas_assembly.py `_momentum_kernel`, parity
    branch, in every steady instance (scheme x limiter x Rhie-Chow x
    SecondOrder x in-kernel GG) and `_pc_kernel` under Rhie-Chow (GG and
    streamed), against the plain versions."""
    dt = DTYPES[dtype]
    vel, p, md, bcv, flags, cols = _asm_case(case, dt, dev)
    mesh, table = _asm_mesh(case, dt, dev)
    zc, zs, zv = device_bc(table, dtype=dt, device=dev)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    grad_p = ck_pressure_gradient(mesh, ck, bc, p)
    grad_v = ck_velocity_gradient(mesh, ck, bc, vel)
    scheme, psi = PARITY_FAMILIES[family]
    vol = float(mesh.cell_volume[0])
    for rc, p_so, gg in FACE_MODELS:
        spec = asm.AsmSpec(scheme=scheme, rc=rc, p_so=p_so, psi=psi, vol=vol, gg=gg)
        margs = (vel, p, bcv, flags, cols, 1.0, 1e-3, 0.7)
        mkw = dict(grad_p=None if gg else grad_p, mom_diag=md, grad_vel=grad_v, spec=spec)
        before = asm.momentum_assembly.launches
        got = asm.momentum_assembly(*margs, **mkw)
        ref = asm.momentum_assembly_plain(*margs, **mkw)
        torch.cuda.synchronize()
        assert asm.momentum_assembly.launches == before + 1
        for name, a, r in zip(("diag", "off", "b"), got, ref):
            _close(a, r, TOL[dtype], f"momentum {spec} {name}")
        if scheme == "ud" and rc and not p_so:
            pkw = dict(p=p, grad_p=None if gg else grad_p, spec=spec)
            got = asm.pc_assembly(vel, md, bcv, flags, cols, 1.0, **pkw)
            ref = asm.pc_assembly_plain(vel, md, bcv, flags, cols, 1.0, **pkw)
            torch.cuda.synchronize()
            for name, a, r in zip(("diag", "off", "b"), got, ref):
                _close(a, r, TOL[dtype], f"pc {spec} {name}")


#: name -> (nx, ny, nz, velocity inlet or None for a pressure inlet):
#: boxes whose sides are no multiple of the momentum kernel's tile
#: (32 x 8 in 2-D, 16 x 4 x 4 in 3-D), each with a pressure outlet.
TILE_BOXES = {
    "37x23_vinlet": (37, 23, 1, 1e-3),
    "19x11x7_pressure": (19, 11, 7, None),
}


@pytest.mark.parametrize("family", sorted(PARITY_FAMILIES))
@pytest.mark.parametrize("box", sorted(TILE_BOXES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_momentum_kernel_tile_edges(dev, dtype, box, family):
    """Guards orc_tpu/ops/pallas_assembly.py `_momentum_kernel`, parity
    branch, at the edges of the kernel's box tiles (ragged on every side,
    velocity-inlet and pressure zones): every face-model instance of the
    family, steady and with the inertia term, against the plain version."""
    nx, ny, nz, vinlet = TILE_BOXES[box]
    dt = DTYPES[dtype]
    mesh, table = couette_case(
        nx, ny, nz, params=ChannelFlowParameters(top_wall_velocity=5e-4, dp_dx=5.0),
        velocity_inlet=vinlet, dtype=dt, device=dev,
    )
    zc, zs, zv = device_bc(table, dtype=dt, device=dev)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    cols = asm.column_specs(mesh, table)
    assert asm.box_dims(cols, mesh.n_cells) == (nx, ny, nz)
    C = mesh.n_cells
    rng = np.random.default_rng(3)
    vel = torch.tensor(rng.standard_normal((C, 3)) * 0.1, dtype=dt, device=dev)
    p = torch.tensor(rng.standard_normal(C) * 0.05, dtype=dt, device=dev)
    md = torch.tensor(rng.uniform(0.5, 2.0, C), dtype=dt, device=dev)
    grad_p = ck_pressure_gradient(mesh, ck, bc, p)
    grad_v = ck_velocity_gradient(mesh, ck, bc, vel)
    vel_n = torch.tensor(rng.standard_normal((C, 3)) * 0.1, dtype=dt, device=dev)
    margs = (vel, p, asm.bc_value_table(zs, zv), asm.pack_flags(ck.interior, ck.mask),
             cols, 1.0, 1e-3, 0.7)
    scheme, psi = PARITY_FAMILIES[family]
    vol = float(mesh.cell_volume[0])
    for rc, p_so, gg in FACE_MODELS:
        spec = asm.AsmSpec(scheme=scheme, rc=rc, p_so=p_so, psi=psi, vol=vol, gg=gg)
        for inertia in (None, (1000.0 * mesh.cell_volume / 0.01, vel_n)):
            kw = dict(grad_p=None if gg else grad_p, mom_diag=md, grad_vel=grad_v,
                      inertia=inertia, spec=spec)
            before = asm.momentum_assembly.launches
            got = asm.momentum_assembly(*margs, **kw)
            ref = asm.momentum_assembly_plain(*margs, **kw)
            torch.cuda.synchronize()
            assert asm.momentum_assembly.launches == before + 1
            for name, a, r in zip(("diag", "off", "b"), got, ref):
                _close(a, r, TOL[dtype], f"momentum {spec} inertia={inertia is not None} {name}")


def _tile_case(box, dt, dev):
    """A box of TILE_BOXES with seeded fields on the card: (mesh, ck
    geometry, ck BC, BC value table, flags, cols, fields)."""
    nx, ny, nz, vinlet = TILE_BOXES[box]
    mesh, table = couette_case(
        nx, ny, nz, params=ChannelFlowParameters(top_wall_velocity=5e-4, dp_dx=5.0),
        velocity_inlet=vinlet, dtype=dt, device=dev,
    )
    zc, zs, zv = device_bc(table, dtype=dt, device=dev)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    cols = asm.column_specs(mesh, table)
    assert asm.box_dims(cols, mesh.n_cells) == (nx, ny, nz)
    C = mesh.n_cells
    rng = np.random.default_rng(3)
    f = {name: torch.tensor(a, dtype=dt, device=dev) for name, a in (
        ("vel", rng.standard_normal((C, 3)) * 0.1),
        ("p", rng.standard_normal(C) * 0.05),
        ("md", rng.uniform(0.5, 2.0, C)),
        ("vel_n", rng.standard_normal((C, 3)) * 0.1),
        ("vel2", rng.standard_normal((C, 3)) * 0.1),
    )}
    f["grad_p"] = ck_pressure_gradient(mesh, ck, bc, f["p"])
    f["grad_v"] = ck_velocity_gradient(mesh, ck, bc, f["vel"])
    flags = asm.pack_flags(ck.interior, ck.mask)
    return mesh, ck, bc, asm.bc_value_table(zs, zv), flags, cols, f


@pytest.mark.parametrize("family", sorted(PARITY_FAMILIES))
@pytest.mark.parametrize("box", sorted(TILE_BOXES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fc_momentum_kernel_tile_edges(dev, dtype, box, family):
    """Guards orc_tpu/ops/pallas_assembly.py `_momentum_kernel`, SIMPLE_FC
    branch, at the edges of the kernel's box tiles: the family with
    Linear and SecondOrder face pressures, steady and with the inertia
    term, against the plain version."""
    dt = DTYPES[dtype]
    mesh, ck, bc, bcv, flags, cols, f = _tile_case(box, dt, dev)
    flux = ck_flux(mesh, ck, bc, f["vel2"], tset.VelocityInterpolation.LINEAR_WEIGHTED)
    flux = flux.T.contiguous().T  # the planes layout of FlowState.flux
    margs = (f["vel"], f["p"], flux, bcv, flags, cols, 1.0, 1e-3, 0.7)
    scheme, psi = PARITY_FAMILIES[family]
    for p_so in (False, True):
        spec = asm.AsmSpec(scheme=scheme, p_so=p_so, psi=psi)
        for inertia in (None, (1000.0 * mesh.cell_volume / 0.01, f["vel_n"])):
            kw = dict(grad_p=f["grad_p"], grad_vel=f["grad_v"], inertia=inertia, spec=spec)
            before = asm.fc_momentum_assembly.launches
            got = asm.fc_momentum_assembly(*margs, **kw)
            ref = asm.fc_momentum_assembly_plain(*margs, **kw)
            torch.cuda.synchronize()
            assert asm.fc_momentum_assembly.launches == before + 1
            for name, a, r in zip(("diag", "off", "b"), got, ref):
                _close(a, r, TOL[dtype], f"fc momentum {spec} inertia={inertia is not None} {name}")


@pytest.mark.parametrize("rc", [False, True], ids=["linear", "rc"])
@pytest.mark.parametrize("box", sorted(TILE_BOXES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fc_pc_kernel_tile_edges(dev, dtype, box, rc):
    """Guards orc_tpu/ops/pallas_assembly.py `_fc_pc_kernel` at the edges
    of the kernel's box tiles, with Linear and Rhie-Chow predictors,
    against the plain version."""
    dt = DTYPES[dtype]
    mesh, _ck, _bc, bcv, flags, cols, f = _tile_case(box, dt, dev)
    spec = asm.AsmSpec(rc=rc, vol=float(mesh.cell_volume[0]))
    pargs = (f["vel"], f["md"], bcv, flags, cols, 1.0)
    before = asm.fc_pc_assembly.launches
    got = asm.fc_pc_assembly(*pargs, grad_p=f["grad_p"], spec=spec)
    ref = asm.fc_pc_assembly_plain(*pargs, grad_p=f["grad_p"], spec=spec)
    torch.cuda.synchronize()
    assert asm.fc_pc_assembly.launches == before + 1
    for name, a, r in zip(("diag", "off", "b", "flux_h"), got, ref):
        _close(a, r, TOL[dtype], f"fc pc {spec} {name}")


@pytest.mark.parametrize("instance", ["linear", "rc-gg", "rc-streamed"])
@pytest.mark.parametrize("box", sorted(TILE_BOXES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pc_kernel_tile_edges(dev, dtype, box, instance):
    """Guards orc_tpu/ops/pallas_assembly.py `_pc_kernel` at the edges of
    the kernel's box tiles, in each of its instances, against the plain
    version."""
    dt = DTYPES[dtype]
    mesh, _ck, _bc, bcv, flags, cols, f = _tile_case(box, dt, dev)
    rc, gg = instance != "linear", instance == "rc-gg"
    spec = asm.AsmSpec(rc=rc, gg=gg, vol=float(mesh.cell_volume[0]))
    kw = dict(p=f["p"] if rc else None, grad_p=None if gg else f["grad_p"], spec=spec)
    before = asm.pc_assembly.launches
    got = asm.pc_assembly(f["vel"], f["md"], bcv, flags, cols, 1.0, **kw)
    ref = asm.pc_assembly_plain(f["vel"], f["md"], bcv, flags, cols, 1.0, **kw)
    torch.cuda.synchronize()
    assert asm.pc_assembly.launches == before + 1
    for name, a, r in zip(("diag", "off", "b"), got, ref):
        _close(a, r, TOL[dtype], f"pc {spec} {name}")


def test_parity_kernels_refuse_what_they_cannot_run(dev):
    """A CUDA call the parity kernels cannot serve raises: a missing
    streamed gradient, diagonal or velocity gradient, a limiter without
    a kernel code, no cell volume, an inertia pair of the wrong shape."""
    vel, p, md, bcv, flags, cols = _asm_case("cavity", torch.float64, dev)
    C = vel.shape[0]
    gv = torch.zeros((C, 3, 3), dtype=vel.dtype, device=dev)
    args = (vel, p, bcv, flags, cols, 1.0, 1e-3, 0.7)
    for spec, kw in (
        (asm.AsmSpec(rc=True, vol=1.0), dict(mom_diag=md)),
        (asm.AsmSpec(rc=True, gg=True, vol=1.0), {}),
        (asm.AsmSpec(p_so=True, gg=True), {}),
        (asm.AsmSpec(scheme="tvd_dc", psi=tset.tvd_umist), {}),
        (asm.AsmSpec(scheme="tvd_dc", psi=lambda r: r), dict(grad_vel=gv)),
    ):
        with pytest.raises(ValueError):
            asm.momentum_assembly(*args, spec=spec, **kw)
    with pytest.raises(ValueError):
        asm.pc_assembly(vel, md, bcv, flags, cols, 1.0, spec=asm.AsmSpec(rc=True, gg=True, vol=1.0))
    with pytest.raises(ValueError):
        asm.momentum_assembly(*args, inertia=(vel[:-1, 0], vel))


#: (momentum scheme, limiter, Rhie-Chow, SecondOrder pressure) of the
#: SIMPLE_FC kernel tests: the windows of tests/test_pallas_assembly.py
#: plus the other limiters and face pressures.
FC_SPECS = {
    "ud-linear": ("ud", None, False, False),
    "default": ("cd1", None, True, True),
    "tvd_dc-rc": ("tvd_dc", tset.tvd_umist, True, False),
    "tvd_dc-lud-so": ("tvd_dc", tset.tvd_lud, False, True),
    "tvd_dc-quick": ("tvd_dc", tset.tvd_quick, True, True),
}


@pytest.mark.parametrize("spec_name", sorted(FC_SPECS))
@pytest.mark.parametrize("case", ["cavity", "cavity3d", "couette", "vinlet"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fc_assembly_kernels_match_plain(dev, dtype, case, spec_name):
    """Guards orc_tpu/ops/pallas_assembly.py `_momentum_kernel`, SIMPLE_FC
    branch (via fc_momentum_assembly), and `_fc_pc_kernel` (via
    fc_pc_assembly): a stored flux from another velocity field, the
    Green-Gauss gradients of the fields, both kernels against their
    plain versions."""
    dt = DTYPES[dtype]
    vel, p, md, bcv, flags, cols = _asm_case(case, dt, dev)
    mesh, table = _asm_mesh(case, dt, dev)
    zc, zs, zv = device_bc(table, dtype=dt, device=dev)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    rng = np.random.default_rng(12)
    vel2 = torch.tensor(rng.standard_normal(vel.shape) * 0.1, dtype=dt, device=dev)
    flux = ck_flux(mesh, ck, bc, vel2, tset.VelocityInterpolation.LINEAR_WEIGHTED)
    flux = flux.T.contiguous().T  # the planes layout of FlowState.flux
    grad_p = ck_pressure_gradient(mesh, ck, bc, p)
    grad_v = ck_velocity_gradient(mesh, ck, bc, vel)
    scheme, psi, rc, p_so = FC_SPECS[spec_name]
    spec = asm.AsmSpec(
        scheme=scheme, rc=rc, p_so=p_so, psi=psi,
        vol=float(mesh.cell_volume[0]),
    )
    before = (asm.fc_momentum_assembly.launches, asm.fc_pc_assembly.launches)
    margs = (vel, p, flux, bcv, flags, cols, 1.0, 1e-3, 0.7)
    mkw = dict(grad_p=grad_p, grad_vel=grad_v, spec=spec)
    got = asm.fc_momentum_assembly(*margs, **mkw)
    ref = asm.fc_momentum_assembly_plain(*margs, **mkw)
    for name, a, r in zip(("diag", "off", "b"), got, ref):
        _close(a, r, TOL[dtype], "fc momentum " + name)
    pargs = (vel, md, bcv, flags, cols, 1.0)
    got = asm.fc_pc_assembly(*pargs, grad_p=grad_p, spec=spec)
    ref = asm.fc_pc_assembly_plain(*pargs, grad_p=grad_p, spec=spec)
    torch.cuda.synchronize()
    for name, a, r in zip(("diag", "off", "b", "flux_h"), got, ref):
        _close(a, r, TOL[dtype], "fc pc " + name)
    assert (asm.fc_momentum_assembly.launches, asm.fc_pc_assembly.launches) == (
        before[0] + 1, before[1] + 1
    )


def test_fc_kernels_refuse_what_they_cannot_run(dev):
    """A CUDA call the SIMPLE_FC kernels cannot serve raises: a limiter
    without a kernel code, a missing gradient, an inertia pair of the
    wrong shape."""
    vel, p, _md, bcv, flags, cols = _asm_case("cavity", torch.float64, dev)
    C, K = vel.shape[0], len(cols)
    flux = torch.zeros((C, K), dtype=vel.dtype, device=dev)
    grad_v = torch.zeros((C, 3, 3), dtype=vel.dtype, device=dev)
    args = (vel, p, flux, bcv, flags, cols, 1.0, 1e-3, 0.7)
    with pytest.raises(ValueError):
        asm.fc_momentum_assembly(
            *args, grad_vel=grad_v,
            spec=asm.AsmSpec(scheme="tvd_dc", psi=lambda r: r),
        )
    with pytest.raises(ValueError):
        asm.fc_momentum_assembly(
            *args, spec=asm.AsmSpec(scheme="tvd_dc", psi=tset.tvd_umist)
        )
    with pytest.raises(ValueError):
        asm.fc_momentum_assembly(*args, spec=asm.AsmSpec(p_so=True))
    with pytest.raises(ValueError):
        asm.fc_momentum_assembly(*args, inertia=(vel[:, 0], vel[:, :2]))


@pytest.mark.parametrize("case", ["cavity", "cavity3d", "couette", "vinlet"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_inertia_kernels_match_plain(dev, dtype, case):
    """Guards the transient branch of orc_tpu/ops/pallas_assembly.py
    `_momentum_kernel` (:410-417), parity and SIMPLE_FC: with inertia =
    (rho V/dt, vel^n) every parity face-model instance of the UD, CD1 and
    TVD_DC + UMIST families and every SIMPLE_FC spec against the plain
    versions, each launch counted as transient."""
    dt = DTYPES[dtype]
    vel, p, md, bcv, flags, cols = _asm_case(case, dt, dev)
    mesh, table = _asm_mesh(case, dt, dev)
    zc, zs, zv = device_bc(table, dtype=dt, device=dev)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    grad_p = ck_pressure_gradient(mesh, ck, bc, p)
    grad_v = ck_velocity_gradient(mesh, ck, bc, vel)
    rng = np.random.default_rng(21)
    vel_n = torch.tensor(rng.standard_normal(vel.shape) * 0.1, dtype=dt, device=dev)
    inertia = (1000.0 * mesh.cell_volume / 0.01, vel_n)
    vol = float(mesh.cell_volume[0])
    before = (asm.momentum_assembly.transient_launches,
              asm.fc_momentum_assembly.transient_launches)
    n_parity = 0
    for scheme, psi in (("ud", None), ("cd1", None), ("tvd_dc", tset.tvd_umist)):
        for rc, p_so, gg in FACE_MODELS:
            spec = asm.AsmSpec(scheme=scheme, rc=rc, p_so=p_so, psi=psi, vol=vol, gg=gg)
            margs = (vel, p, bcv, flags, cols, 1.0, 1e-3, 0.7)
            mkw = dict(grad_p=None if gg else grad_p, mom_diag=md, grad_vel=grad_v,
                       inertia=inertia, spec=spec)
            got = asm.momentum_assembly(*margs, **mkw)
            ref = asm.momentum_assembly_plain(*margs, **mkw)
            torch.cuda.synchronize()
            n_parity += 1
            for name, a, r in zip(("diag", "off", "b"), got, ref):
                _close(a, r, TOL[dtype], f"transient momentum {spec} {name}")
    flux = ck_flux(mesh, ck, bc, vel_n, tset.VelocityInterpolation.LINEAR_WEIGHTED)
    flux = flux.T.contiguous().T
    for scheme, psi, rc, p_so in FC_SPECS.values():
        spec = asm.AsmSpec(scheme=scheme, rc=rc, p_so=p_so, psi=psi, vol=vol)
        margs = (vel, p, flux, bcv, flags, cols, 1.0, 1e-3, 0.7)
        mkw = dict(grad_p=grad_p, grad_vel=grad_v, inertia=inertia, spec=spec)
        got = asm.fc_momentum_assembly(*margs, **mkw)
        ref = asm.fc_momentum_assembly_plain(*margs, **mkw)
        torch.cuda.synchronize()
        for name, a, r in zip(("diag", "off", "b"), got, ref):
            _close(a, r, TOL[dtype], f"transient fc momentum {spec} {name}")
    assert (asm.momentum_assembly.transient_launches,
            asm.fc_momentum_assembly.transient_launches) == (
        before[0] + n_parity, before[1] + len(FC_SPECS)
    )


@pytest.mark.parametrize("coupling", ["SIMPLE", "SIMPLE_FC"])
def test_transient_slice_on_cuda_matches_cpu(dev, coupling):
    """solve_transient on a 16^2 f64 cavity (solve_cavity's numerics with
    a Jacobi(50) pressure solve, under each coupling; 3 steps x 4
    iterations) on the card, through the inertia kernels, against the
    same run on the CPU: equal inner counts, fields to 1e-9 of scale."""
    from orc_tpu_torch.solver.transient import solve_transient

    settings = default_settings().replace(
        pressure_velocity_coupling=tset.PressureVelocityCoupling[coupling],
        matrix_solver=JACOBI_50,
    )
    out = []
    for d in (dev, torch.device("cpu")):
        mesh, table = cavity_case(n=16, device=d)
        out.append(solve_transient(
            mesh, table, settings, 1.0, 0.01, dt=0.05, n_steps=3,
            inner_iterations=4, verbose=False,
        ))
    (sg, hg), (sc, hc) = out
    assert torch.equal(hg.pc_iters.cpu(), hc.pc_iters)
    for name in ("vel", "p"):
        _close(getattr(sg, name), getattr(sc, name), 1e-9, name)


#: The reference's default numerics under forced SIMPLE with implicit
#: relaxation (scripts/bench_cavity.py, ORC_TPU_BENCH_SCHEME=default):
#: the parity kernels' Rhie-Chow + SecondOrder branch with the in-kernel
#: Green-Gauss gradient.
REF_DEFAULT = default_settings().replace(
    momentum=tset.MomentumScheme.CD1,
    pressure_velocity_coupling=tset.PressureVelocityCoupling.SIMPLE,
    velocity_interpolation=tset.VelocityInterpolation.RHIE_CHOW,
    pressure_interpolation=tset.PressureInterpolation.SECOND_ORDER,
)

#: The pressure solve of the SIMPLE_FC slice comparisons: Jacobi. The
#: full-p BiCGSTAB amplifies one-ulp differences chaotically (ROADMAP
#: Queue 3), so only a stationary solver lets a device comparison hold
#: whole trajectories to 1e-9.
JACOBI_50 = tset.MatrixSolverSettings(
    solver_type=tset.SolutionMethod.JACOBI, iterations=50
)
#: The geometric multigrid pressure solve of tests/test_gmg.py's cavity
#: (3 levels, 5 BiCGSTAB smoother iterations each, Jacobi-preconditioned).
MG_3 = tset.MatrixSolverSettings(
    solver_type=tset.SolutionMethod.MULTIGRID, iterations=40,
    multigrid_levels=3, multigrid_smoother_iterations=5,
    preconditioner=tset.PreconditionMethod.JACOBI,
)


def _solve(dev, name, iterations):
    if name == "cavity":
        mesh, table = cavity_case(n=16, device=dev)
        settings, rho, mu = default_settings(), 1.0, 0.01
    elif name == "fc_cavity":
        mesh, table = cavity_case(n=16, device=dev)
        settings = flagship_settings().replace(matrix_solver=JACOBI_50)
        rho, mu = 1.0, 1e-3
    elif name == "ref_default":
        mesh, table = cavity_case(n=16, device=dev)
        settings, rho, mu = REF_DEFAULT, 1.0, 0.01
    elif name == "multigrid":
        mesh, table = cavity_case(n=16, device=dev)
        settings, rho, mu = default_settings().replace(matrix_solver=MG_3), 1.0, 0.01
    elif name == "fc_couette":
        mesh, table = couette_case(
            32, 16,
            params=ChannelFlowParameters(top_wall_velocity=5e-4, dp_dx=10.0),
            device=dev,
        )
        settings = tset.NumericalSettings(
            matrix_solver=JACOBI_50,
            relaxation_mode=tset.RelaxationMode.IMPLICIT,
            momentum_relaxation=0.7,
            pressure_relaxation=0.3,
        )
        rho, mu = 1000.0, 0.001
    else:
        mesh, table = couette_case(
            32, 16,
            params=ChannelFlowParameters(top_wall_velocity=5e-4, dp_dx=10.0),
            device=dev,
        )
        settings = tset.NumericalSettings(
            matrix_solver=tset.MatrixSolverSettings(
                solver_type=tset.SolutionMethod.BICGSTAB, iterations=50
            )
        )
        rho, mu = 1000.0, 0.001
    state, hist = simple.solve_steady(
        mesh, table, settings, rho, mu, iterations=iterations,
        reporting_interval=iterations, verbose=False,
    )
    return state, simple.stack_history(hist)


@pytest.mark.parametrize(
    "name,iterations,kernels",
    [
        ("cavity", 10, KERNELS),
        ("ref_default", 10, KERNELS),
        ("multigrid", 10, KERNELS),
        ("couette", 50, (shift_spmv,)),
        ("fc_cavity", 10, FC_KERNELS),
        ("fc_couette", 50, FC_KERNELS),
    ],
)
def test_slice_on_cuda_matches_cpu(dev, name, iterations, kernels):
    """Guards the replacements together (pallas_spmv.py `_kernel`,
    pallas_smooth.py `_kernel`, pallas_assembly.py `_momentum_kernel`
    (both branches; the parity one also under Rhie-Chow + SecondOrder with
    the in-kernel gradient), `_pc_kernel` and `_fc_pc_kernel`): float64 SIMPLE or
    SIMPLE_FC on the card against the same run on CPU (plain versions),
    with equal inner iteration counts, fields to 1e-9 of their scale,
    every kernel of the path launched and no kernel of the other
    coupling."""
    every = set(KERNELS) | set(FC_KERNELS)
    for k in every:
        k.launches = 0
    sg, hg = _solve(dev, name, iterations)
    counts = {k.__name__: k.launches for k in every}
    sc, hc = _solve("cpu", name, iterations)
    for k in kernels:
        assert counts[k.__name__] > 0, counts
    for k in every - set(FC_KERNELS if name.startswith("fc_") else KERNELS):
        assert counts[k.__name__] == 0, counts
    np.testing.assert_array_equal(hg.mom_iters, hc.mom_iters)
    np.testing.assert_array_equal(hg.pc_iters, hc.pc_iters)
    _close(sg.vel, sc.vel, 1e-9, "vel")
    _close(sg.p, sc.p, 1e-9, "p")
    if sg.flux is not None:
        _close(sg.flux, sc.flux, 1e-9, "flux")


# --- the slice-plan kernels of irregular meshes ---------------------------


def _permuted_cavity(n, dtype, dev, seed=0):
    """The n x n cavity with randomly permuted cells, compiled on `dev`
    (RCM order + slice plan): (mesh, table, perm)."""
    from orc_tpu_torch.mesh.compile import compile_from_arrays

    box, table = cavity_case(n=n, device="cpu")
    a = lambda t: t.numpy()  # noqa: E731
    C = box.n_cells
    perm = np.random.default_rng(seed).permutation(C)
    inv = np.empty(C, np.int64)
    inv[perm] = np.arange(C)
    interior = a(box.face_interior)
    mesh = compile_from_arrays(
        dim=3,
        face_owner=inv[a(box.face_owner)],
        face_neighbor=np.where(interior, inv[a(box.face_neighbor)], -1),
        face_area=a(box.face_area),
        face_normal=a(box.face_normal),
        face_centroid=a(box.face_centroid),
        face_zone_slot=a(box.face_zone_slot),
        cell_centroid=a(box.cell_centroid)[perm],
        cell_volume=a(box.cell_volume)[perm],
        dtype=dtype,
        device=dev,
    )
    return mesh, table, perm


@pytest.mark.parametrize("form", ["shared", "per_row"])
@pytest.mark.parametrize("batch", [0, 3])
@pytest.mark.parametrize("n", [40, 96])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_slice_spmv_kernel_matches_plain(dev, dtype, n, batch, form):
    """Guards orc_tpu/ops/pallas_slice.py `_kernel`, `_kernel_heavy` and
    `_kernel_wide` (via slice_spmv): the prepared, Jacobi-scaled system
    of a permuted cavity (96^2 picks 1024-row tiles), the batch sharing
    one matrix or holding one per row."""
    from orc_tpu_torch.ops.slice_spmv import slice_spmv, slice_spmv_plain
    from orc_tpu_torch.ops.spmv import EllMatrix

    if form == "per_row" and not batch:
        pytest.skip("one matrix per row needs a batch")
    dt = DTYPES[dtype]
    mesh, _, _ = _permuted_cavity(n, dt, dev)
    plan = mesh.slice_plan
    C, K = mesh.cell_neighbors.shape
    interior = mesh.face_interior[mesh.cell_faces.long()] & mesh.cell_face_mask
    rng = np.random.default_rng(4)
    rows = (batch,) if form == "per_row" else ()
    off = torch.tensor(rng.uniform(-1, 0, rows + (C, K)), dtype=dt, device=dev) * interior
    diag = 1.0 + off.abs().sum(-1) + torch.tensor(rng.random(rows + (C,)), dtype=dt, device=dev)
    A, _ = EllMatrix(diag, off, mesh.cell_neighbors, plan=plan).prepare().jacobi_preconditioned()
    x = torch.tensor(rng.standard_normal((batch, C) if batch else (C,)), dtype=dt, device=dev)
    before = slice_spmv.launches
    y = slice_spmv(A.diag, A.off, plan, x)
    torch.cuda.synchronize()
    assert slice_spmv.launches == before + 1
    _close(y, slice_spmv_plain(A.diag, A.off, plan, x), TOL[dtype])
    # The unscaled system through the gather form: D (D^-1 A) x = A x.
    ref = diag * x + torch.sum(off * x[..., mesh.cell_neighbors.long()], dim=-1)
    _close(y * diag, ref, 10 * TOL[dtype])


#: name -> (n of the permuted n x n cavity, plan tile or None for the
#: mesh's own, batch rows, one matrix per batch row): the edges of the
#: chunked slice SpMV. The 12^2 cavity's two tiles leave 32-row chunks
#: (the split for 264 CTAs); 23^2 = 529 cells end in a ragged tile;
#: 1024-row tiles take eight 128-row chunks; B = 5 takes a group of
#: four batch rows and a group of one.
SLICE_EDGES = {
    "chunk_split": (12, None, 0, False),
    "ragged_c": (23, None, 0, False),
    "tile1024": (96, 1024, 0, False),
    "b3_shared": (40, None, 3, False),
    "b3_per_row": (40, None, 3, True),
    "b5_shared": (40, None, 5, False),
}


@pytest.mark.parametrize("case", sorted(SLICE_EDGES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_slice_spmv_kernel_edges(dev, dtype, case):
    """Guards orc_tpu/ops/pallas_slice.py `_kernel`, `_kernel_heavy` and
    `_kernel_wide` (via slice_spmv) at the edges of the chunked kernel:
    against the plain version and, in float32, bitwise against the
    rounding the kernel spells out (tests/torch_kernel_refs.py)."""
    from orc_tpu_torch.mesh.reorder import build_slice_plan
    from orc_tpu_torch.ops.slice_spmv import slice_spmv, slice_spmv_plain
    from orc_tpu_torch.ops.spmv import EllMatrix
    from torch_kernel_refs import slice_spmv_fma_chain

    n, tile, batch, per_row = SLICE_EDGES[case]
    dt = DTYPES[dtype]
    mesh, _, _ = _permuted_cavity(n, dt, dev)
    C, K = mesh.cell_neighbors.shape
    interior = mesh.face_interior[mesh.cell_faces.long()] & mesh.cell_face_mask
    plan = mesh.slice_plan
    if tile is not None:
        plan = build_slice_plan(
            mesh.cell_neighbors.cpu().numpy(), interior.cpu().numpy(), tile=tile,
            device=dev,
        )
        assert plan.tile == tile
    if case == "ragged_c":
        assert C % plan.tile != 0
    rng = np.random.default_rng(6)
    rows = (batch,) if per_row else ()
    off = torch.tensor(rng.uniform(-1, 0, rows + (C, K)), dtype=dt, device=dev) * interior
    diag = 1.0 + off.abs().sum(-1) + torch.tensor(rng.random(rows + (C,)), dtype=dt, device=dev)
    A, _ = EllMatrix(diag, off, mesh.cell_neighbors, plan=plan).prepare().jacobi_preconditioned()
    x = torch.tensor(rng.standard_normal((batch, C) if batch else (C,)), dtype=dt, device=dev)
    before = slice_spmv.launches
    y = slice_spmv(A.diag, A.off, plan, x)
    torch.cuda.synchronize()
    assert slice_spmv.launches == before + 1
    _close(y, slice_spmv_plain(A.diag, A.off, plan, x), TOL[dtype])
    if dt == torch.float32:
        assert torch.equal(y, slice_spmv_fma_chain(A.diag, A.off, plan, x))


@pytest.mark.parametrize("fields", [1, 3, 9])
@pytest.mark.parametrize("n", [40, 96])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_slice_nbr_kernel_matches_plain_exactly(dev, dtype, n, fields):
    """Guards orc_tpu/ops/pallas_slice.py `_nbr_kernel` and
    `_nbr_kernel_wide` (via slice_nbr_values): bitwise equal to the
    plain version and to the gather over cell_neighbors."""
    from orc_tpu_torch.ops.slice_spmv import slice_nbr_values, slice_nbr_values_plain

    dt = DTYPES[dtype]
    mesh, _, _ = _permuted_cavity(n, dt, dev)
    C = mesh.n_cells
    interior = mesh.face_interior[mesh.cell_faces.long()] & mesh.cell_face_mask
    shape = {1: (C,), 3: (C, 3), 9: (C, 3, 3)}[fields]
    x = torch.tensor(np.random.default_rng(2).standard_normal(shape), dtype=dt, device=dev)
    before = slice_nbr_values.launches
    got = slice_nbr_values(mesh.slice_plan, x, interior)
    torch.cuda.synchronize()
    assert slice_nbr_values.launches == before + 1
    assert torch.equal(got, slice_nbr_values_plain(mesh.slice_plan, x, interior))
    assert torch.equal(got, x[mesh.cell_neighbors.long()])


#: name -> (n, dtype, trailing field shape, plan tile or None for the
#: mesh's own plan): the edges of the staged gather. 1024-row tiles at
#: 9 float64 fields take several row chunks per tile; F = 2 runs the
#: generic instance; 23^2 = 529 cells end in a ragged tile; 2000 float64
#: fields per cell outgrow the stage and are copied straight.
NBR_EDGES = {
    "tile1024_f9_f64": (96, torch.float64, (3, 3), 1024),
    "f2": (40, torch.float32, (2,), None),
    "ragged_c": (23, torch.float64, (3,), None),
    "wide_rows": (12, torch.float64, (2000,), None),
}


@pytest.mark.parametrize("case", sorted(NBR_EDGES))
def test_slice_nbr_kernel_edges(dev, case):
    """Guards orc_tpu/ops/pallas_slice.py `_nbr_kernel` and
    `_nbr_kernel_wide` (via slice_nbr_values) at the edges of the staged
    gather: bitwise equal to the plain version and to x[cell_neighbors]."""
    from orc_tpu_torch.mesh.reorder import build_slice_plan
    from orc_tpu_torch.ops.slice_spmv import slice_nbr_values, slice_nbr_values_plain

    n, dt, tail, tile = NBR_EDGES[case]
    mesh, _, _ = _permuted_cavity(n, dt, dev)
    C = mesh.n_cells
    interior = mesh.face_interior[mesh.cell_faces.long()] & mesh.cell_face_mask
    plan = mesh.slice_plan
    if tile is not None:
        plan = build_slice_plan(
            mesh.cell_neighbors.cpu().numpy(), interior.cpu().numpy(), tile=tile,
            build_col_tile=True, device=dev,
        )
        assert plan.tile == tile
    if case == "ragged_c":
        assert C % plan.tile != 0
    x = torch.tensor(np.random.default_rng(5).standard_normal((C,) + tail), dtype=dt, device=dev)
    before = slice_nbr_values.launches
    got = slice_nbr_values(plan, x, interior)
    torch.cuda.synchronize()
    assert slice_nbr_values.launches == before + 1
    assert torch.equal(got, slice_nbr_values_plain(plan, x, interior))
    assert torch.equal(got, x[mesh.cell_neighbors.long()])


def test_slice_kernels_refuse_what_they_cannot_run(dev):
    """A CUDA call outside the kernels' contract raises: a coefficient
    batch that does not match x, an interior mask that does not match
    the plan."""
    from orc_tpu_torch.ops.slice_spmv import slice_nbr_values, slice_spmv

    mesh, _, _ = _permuted_cavity(20, torch.float64, dev)
    plan = mesh.slice_plan
    C = mesh.n_cells
    coef = torch.zeros((2, plan.ntiles, plan.n_max, plan.tile), dtype=torch.float64, device=dev)
    diag = torch.ones(C, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        slice_spmv(diag, coef, plan, torch.ones((3, C), dtype=torch.float64, device=dev))
    interior = mesh.face_interior[mesh.cell_faces.long()] & mesh.cell_face_mask
    with pytest.raises(ValueError):
        slice_nbr_values(plan, diag, interior[:, :-1])


@pytest.mark.parametrize("name", ["cavity", "fc_cavity"])
def test_irregular_slice_on_cuda_matches_cpu(dev, name):
    """Guards the slice kernels on the solver path: SIMPLE (BiCGSTAB
    pressure, Jacobi-smoother momentum) and SIMPLE_FC (Jacobi pressure)
    on a permuted 16^2 f64 cavity, card against CPU, 10 iterations:
    equal inner iteration counts, fields to 1e-9 of their scale, both
    slice kernels launched and no structured kernel."""
    from orc_tpu_torch.ops.slice_spmv import slice_nbr_values, slice_spmv

    settings = (
        default_settings() if name == "cavity"
        else flagship_settings().replace(matrix_solver=JACOBI_50)
    )
    mu = 0.01 if name == "cavity" else 1e-3
    out = []
    every = set(KERNELS) | set(FC_KERNELS)
    for d in (dev, "cpu"):
        for k in every | {slice_spmv, slice_nbr_values}:
            k.launches = 0
        mesh, table, _ = _permuted_cavity(16, torch.float64, d, seed=3)
        state, hist = simple.solve_steady(
            mesh, table, settings, 1.0, mu, iterations=10,
            reporting_interval=10, verbose=False,
        )
        if d == dev:
            assert slice_spmv.launches > 0 and slice_nbr_values.launches > 0
            assert all(k.launches == 0 for k in every)
        out.append((state, simple.stack_history(hist)))
    (sg, hg), (sc, hc) = out
    np.testing.assert_array_equal(hg.mom_iters, hc.mom_iters)
    np.testing.assert_array_equal(hg.pc_iters, hc.pc_iters)
    _close(sg.vel, sc.vel, 1e-9, "vel")
    _close(sg.p, sc.p, 1e-9, "p")


@pytest.mark.parametrize("form", ["shared", "per_row"])
@pytest.mark.parametrize("batch", [0, 3])
@pytest.mark.parametrize("n", [40, 96])
def test_slice_spmv_exact_kernel_matches_plain_bitwise(dev, n, batch, form):
    """Guards orc_tpu/ops/pallas_slice.py `_kernel_exact` and
    `_kernel_wide_exact` (via slice_spmv_exact): float32 hi planes of a
    permuted cavity's prepared f64 system, (y, err) bitwise equal to the
    plain version, y + err the f64 product to 1e-13 of sum |coef x|."""
    from orc_tpu_torch.ops.df32 import df_from_f64
    from orc_tpu_torch.ops.slice_spmv import slice_spmv_exact, slice_spmv_exact_plain
    from orc_tpu_torch.ops.spmv import EllMatrix

    if form == "per_row" and not batch:
        pytest.skip("one coefficient set per row needs a batch")
    mesh, _, _ = _permuted_cavity(n, torch.float64, dev)
    plan = mesh.slice_plan
    C, K = mesh.cell_neighbors.shape
    interior = mesh.face_interior[mesh.cell_faces.long()] & mesh.cell_face_mask
    rng = np.random.default_rng(5)
    rows = (batch,) if form == "per_row" else ()
    off = torch.tensor(rng.standard_normal(rows + (C, K)), device=dev) * interior
    A = EllMatrix(torch.ones(C, dtype=torch.float64, device=dev), off,
                  mesh.cell_neighbors, plan=plan).prepare()
    coef, _ = df_from_f64(A.off)
    x, _ = df_from_f64(torch.tensor(rng.standard_normal((batch, C) if batch else C), device=dev))
    before = slice_spmv_exact.launches
    y, e = slice_spmv_exact(coef, plan, x)
    torch.cuda.synchronize()
    assert slice_spmv_exact.launches == before + 1
    yr, er = slice_spmv_exact_plain(coef, plan, x)
    assert torch.equal(y, yr) and torch.equal(e, er)
    zero = torch.zeros(C, dtype=torch.float64, device=dev)
    ref = EllMatrix(zero, coef.double(), None, plan=plan, slice_layout=True).matvec(x.double())
    absrow = EllMatrix(zero, coef.double().abs(), None, plan=plan, slice_layout=True).matvec(x.double().abs())
    assert bool(((y.double() + e.double() - ref).abs() <= 1e-13 * absrow).all())


@pytest.mark.parametrize("case", sorted(SLICE_EDGES))
def test_slice_spmv_exact_kernel_edges(dev, case):
    """Guards orc_tpu/ops/pallas_slice.py `_kernel_exact` and
    `_kernel_wide_exact` (via slice_spmv_exact) at the edges of the
    chunked CTAs it shares with the slice SpMV (SLICE_EDGES): (y, err)
    bitwise equal to the plain version."""
    from orc_tpu_torch.mesh.reorder import build_slice_plan
    from orc_tpu_torch.ops.slice_spmv import slice_spmv_exact, slice_spmv_exact_plain
    from orc_tpu_torch.ops.spmv import EllMatrix

    n, tile, batch, per_row = SLICE_EDGES[case]
    mesh, _, _ = _permuted_cavity(n, torch.float64, dev)
    C, K = mesh.cell_neighbors.shape
    interior = mesh.face_interior[mesh.cell_faces.long()] & mesh.cell_face_mask
    plan = mesh.slice_plan
    if tile is not None:
        plan = build_slice_plan(
            mesh.cell_neighbors.cpu().numpy(), interior.cpu().numpy(), tile=tile,
            device=dev,
        )
    rng = np.random.default_rng(7)
    rows = (batch,) if per_row else ()
    off = torch.tensor(rng.standard_normal(rows + (C, K)), device=dev) * interior
    A = EllMatrix(torch.ones(C, dtype=torch.float64, device=dev), off,
                  mesh.cell_neighbors, plan=plan).prepare()
    coef = A.off.float()
    x = torch.tensor(rng.standard_normal((batch, C) if batch else C),
                     dtype=torch.float32, device=dev)
    before = slice_spmv_exact.launches
    y, e = slice_spmv_exact(coef, plan, x)
    torch.cuda.synchronize()
    assert slice_spmv_exact.launches == before + 1
    yr, er = slice_spmv_exact_plain(coef, plan, x)
    assert torch.equal(y, yr) and torch.equal(e, er)


def test_df32_ir_on_cuda_matches_cpu(dev):
    """DF32_IR (solver/refine.py) on the card: the slice-plan system of
    tests/test_df32.py solved to 1e-11 of x_true on CUDA and on CPU, the
    exact slice kernel launched, the two solutions within 1e-12."""
    from orc_tpu_torch.mesh.reorder import build_slice_plan
    from orc_tpu_torch.ops.slice_spmv import slice_spmv_exact
    from orc_tpu_torch.ops.spmv import EllMatrix
    from orc_tpu_torch.solver.krylov import iterative_solve

    C, K, band = 2000, 4, 40
    rng = np.random.default_rng(0)
    nbrs = np.clip(np.arange(C)[:, None] + rng.integers(-band, band, (C, K)), 0, C - 1)
    valid = nbrs != np.arange(C)[:, None]
    off = rng.standard_normal((C, K)) * valid * 0.2
    diag = np.abs(off).sum(1) + rng.uniform(1.0, 2.0, C)
    x_true = rng.standard_normal(C)
    settings = tset.MatrixSolverSettings(
        solver_type=tset.SolutionMethod.BICGSTAB, iterations=100,
        relative_convergence_threshold=1e-8,
        preconditioner=tset.PreconditionMethod.JACOBI,
        precision=tset.SolverPrecision.DF32_IR,
    )
    out = []
    for d in (dev, "cpu"):
        A = EllMatrix(
            torch.tensor(diag, device=d), torch.tensor(off, device=d),
            torch.tensor(nbrs, dtype=torch.int32, device=d),
            plan=build_slice_plan(nbrs, valid, tile=128, device=d),
        )
        b = A.matvec(torch.tensor(x_true, device=d))
        slice_spmv_exact.launches = 0
        x, info = iterative_solve(A, b, torch.zeros_like(b), settings)
        if d == dev:
            assert slice_spmv_exact.launches > 0
        err = float((x.cpu() - torch.tensor(x_true)).abs().max()) / np.abs(x_true).max()
        assert err < 1e-11, (d, err)
        out.append(x.cpu())
    assert float((out[0] - out[1]).abs().max()) < 1e-12


#: The (c,k) step's least-squares and per-component schemes on the
#: 16^2 cavity, implicit relaxation: least squares with in-matrix TVD
#: (UMIST) and Rhie-Chow, and CD2; BiCGSTAB(50) pressure.
SCHEMES = {
    "lsq_tvd": default_settings().replace(
        momentum=tset.MomentumScheme.TVD, tvd_psi=tset.tvd_umist,
        gradient_reconstruction=tset.GradientReconstruction.LEAST_SQUARES,
        velocity_interpolation=tset.VelocityInterpolation.RHIE_CHOW,
        pressure_velocity_coupling=tset.PressureVelocityCoupling.SIMPLE,
    ),
    "cd2": default_settings().replace(momentum=tset.MomentumScheme.CD2),
}


@pytest.mark.parametrize("mesh_kind", ["box", "permuted"])
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_scheme_slice_on_cuda_matches_cpu(dev, scheme, mesh_kind):
    """Guards the per-row branches of pallas_spmv.py `_kernel` and
    pallas_smooth.py `_kernel` (and, permuted, the slice kernels with one
    matrix per row and CD2's 9-field gradient gather) on the solver path:
    5 iterations on the 16^2 f64 cavity (one under TVD, whose limiter
    flips branches on rounding: the permuted cavity parted by 1.6e-3 of
    scale in 5 on an H100), card against CPU, equal inner counts, fields
    to 1e-9 of their scale; on the box the per-row instances launched and
    no plain version of a kernel ran on the card."""
    from orc_tpu_torch.ops import fused_smooth as fs
    from orc_tpu_torch.ops import shift_spmv as sh

    settings = SCHEMES[scheme]
    out = []
    for d in (dev, "cpu"):
        shift_spmv.per_row_launches = fused_jacobi_sweeps.per_row_launches = 0
        if mesh_kind == "box":
            mesh, table = cavity_case(n=16, device=d)
        else:
            mesh, table, _ = _permuted_cavity(16, torch.float64, d, seed=3)
        plain_on_card = []
        real = (sh.shift_spmv_plain, fs.sweeps_plain)

        def spy(fn):
            def counted(*a, **k):
                if any(isinstance(t, torch.Tensor) and t.is_cuda for t in a):
                    plain_on_card.append(fn.__name__)
                return fn(*a, **k)
            return counted

        sh.shift_spmv_plain, fs.sweeps_plain = (spy(f) for f in real)
        try:
            n = 1 if settings.momentum == tset.MomentumScheme.TVD else 5
            state, hist = simple.solve_steady(
                mesh, table, settings, 1.0, 0.01, iterations=n,
                reporting_interval=n, verbose=False,
            )
        finally:
            sh.shift_spmv_plain, fs.sweeps_plain = real
        assert not plain_on_card
        if d == dev and mesh_kind == "box":
            assert shift_spmv.per_row_launches > 0
            assert fused_jacobi_sweeps.per_row_launches > 0
        out.append((state, simple.stack_history(hist)))
    (sg, hg), (sc, hc) = out
    np.testing.assert_array_equal(hg.mom_iters, hc.mom_iters)
    np.testing.assert_array_equal(hg.pc_iters, hc.pc_iters)
    for f in ("vel", "p", "mom_diag"):
        _close(getattr(sg, f), getattr(sc, f), 1e-9, f)


def test_rans_channel_on_cuda_matches_cpu(dev):
    """Guards the solver kernels under k-epsilon RANS: the developing
    channel 16x12 f64 (tests/test_turbulence.py), 10 iterations, card
    against CPU: equal inner counts, vel, p, k, eps and mu_t to 1e-6 of
    their scale (the RANS loop amplifies roundoff about tenfold every
    four iterations, ROADMAP Queue 3: 3.2e-8 measured here on an H100);
    no assembly kernel launched (the viscosity varies per face)."""
    from orc_tpu_torch.mesh.generate import structured_box_mesh
    from orc_tpu_torch.mesh.zones import FaceCondition
    from orc_tpu_torch.solver.turbulence import solve_steady_turbulent

    settings = tset.NumericalSettings(
        momentum=tset.MomentumScheme.UD,
        pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=tset.VelocityInterpolation.LINEAR_WEIGHTED,
        matrix_solver=tset.MatrixSolverSettings(
            solver_type=tset.SolutionMethod.BICGSTAB, iterations=30,
            preconditioner=tset.PreconditionMethod.JACOBI,
        ),
        momentum_relaxation=0.6, pressure_relaxation=0.05,
    )
    out = []
    for d in (dev, "cpu"):
        mesh, table = structured_box_mesh(16, 12, 1, lengths=(8.0, 2.0, 0.5), device=d)
        table.set("TOP_WALL", FaceCondition.WALL)
        table.set("BOTTOM_WALL", FaceCondition.WALL)
        table.set("INLET", FaceCondition.VELOCITY_INLET, vector_value=(1.0, 0, 0))
        table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
        table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
        table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
        for k in KERNELS + FC_KERNELS:
            k.launches = 0
        flow, turb, hist = solve_steady_turbulent(
            mesh, table, settings, 1.0, 1e-5, u_ref=1.0, iterations=10,
            reporting_interval=10, intensity=0.05, length_scale=0.14, verbose=False,
        )
        if d == dev:
            assert shift_spmv.launches > 0
            assert all(k.launches == 0 for k in KERNELS[2:] + FC_KERNELS[2:])
        out.append((flow, turb, simple.stack_history(hist)))
    (fg, tg, hg), (fc, tc, hc) = out
    np.testing.assert_array_equal(hg.mom_iters, hc.mom_iters)
    np.testing.assert_array_equal(hg.pc_iters, hc.pc_iters)
    for name, a, b in (("vel", fg.vel, fc.vel), ("p", fg.p, fc.p), ("k", tg.k, tc.k),
                       ("eps", tg.eps, tc.eps), ("mu_t", tg.mu_t, tc.mu_t)):
        _close(a, b, 1e-6, name)


# --- algebraic multigrid, Gauss-Seidel and initialisation ---------------


def _amg_levels(mesh, table, dev):
    """The AMG hierarchy of a mesh (aggregated on its diffusion system)
    on `dev`, and that system."""
    from orc_tpu_torch.ops.assembly import diffusion_system
    from orc_tpu_torch.ops.fields import face_bc
    from orc_tpu_torch.solver.amg import build_hierarchy

    zc, zs, zv = device_bc(table, mesh.dtype, device=mesh.device)
    diff = diffusion_system(
        mesh, face_bc(mesh, zc, zs, zv),
        torch.tensor(0.01, dtype=mesh.dtype, device=mesh.device),
    )
    return build_hierarchy(mesh, diff, tset.MatrixSolverSettings()), diff


@pytest.mark.parametrize("batch", [0, 3])
@pytest.mark.parametrize("n", [40, 96])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_slice_spmv_on_amg_coarse_plans(dev, dtype, n, batch):
    """Guards orc_tpu/ops/pallas_slice.py `_kernel` (via slice_spmv) on
    the coarse levels of the algebraic multigrid: each level's Galerkin
    matrix, prepared on its own plan (built without the gather table)
    and Jacobi-scaled, against the plain version and, in float32,
    bitwise against the rounding the kernel spells out. Levels whose
    128-row plan would be degenerate have none (orc_tpu's rule) and
    gather instead; the first coarse level always has one here."""
    from orc_tpu_torch.ops.slice_spmv import slice_spmv, slice_spmv_plain
    from orc_tpu_torch.ops.spmv import EllMatrix
    from orc_tpu_torch.solver.amg import galerkin_values
    from torch_kernel_refs import slice_spmv_fma_chain

    dt = DTYPES[dtype]
    mesh, table, _ = _permuted_cavity(n, dt, dev)
    levels, diff = _amg_levels(mesh, table, dev)
    assert len(levels) == 3
    A = EllMatrix(diff.diag + 1.0, diff.off, mesh.cell_neighbors, plan=mesh.slice_plan)
    rng = np.random.default_rng(8)
    assert levels[0].plan is not None
    for level in levels:
        A = galerkin_values(A, level)
        if level.plan is None:
            continue
        assert level.plan.col_tile is None
        Ap, _ = A.prepare().jacobi_preconditioned()
        C = level.n_coarse
        x = torch.tensor(rng.standard_normal((batch, C) if batch else (C,)), dtype=dt, device=dev)
        before = slice_spmv.launches
        y = slice_spmv(Ap.diag, Ap.off, level.plan, x)
        torch.cuda.synchronize()
        assert slice_spmv.launches == before + 1
        _close(y, slice_spmv_plain(Ap.diag, Ap.off, level.plan, x), TOL[dtype])
        if dt == torch.float32:
            assert torch.equal(y, slice_spmv_fma_chain(Ap.diag, Ap.off, level.plan, x))


def test_amg_sums_on_cuda_equal_cpu_bitwise(dev):
    """The restriction and Galerkin gathers add in one order on the card
    and on the CPU (no atomics): from the same inputs, the same bits on
    every level."""
    from orc_tpu_torch.ops.spmv import EllMatrix
    from orc_tpu_torch.solver.amg import build_hierarchy_from_matrix, galerkin_values, restrict

    mesh, table, _ = _permuted_cavity(40, torch.float64, "cpu")
    _, diff = _amg_levels(mesh, table, "cpu")
    nbrs = mesh.cell_neighbors.numpy()
    r0 = torch.tensor(np.random.default_rng(2).standard_normal((3, mesh.n_cells)))
    out = []
    for d in (dev, "cpu"):
        levels = build_hierarchy_from_matrix(
            diff.diag.numpy(), diff.off.numpy(), nbrs, tset.MatrixSolverSettings(), device=d
        )
        A = EllMatrix(diff.diag.to(d), diff.off.to(d), None)
        r = r0.to(d)
        got = []
        for level in levels:
            A = galerkin_values(A, level)
            r = restrict(r, level)
            got += [A.diag.cpu(), A.off.cpu(), r.cpu()]
        out.append(got)
    assert len(out[0]) == 9
    for a, b in zip(*out):
        assert torch.equal(a, b)


#: name -> (mesh kind, n, solver): the 16^2 cavity's pressure solved by
#: MULTIGRID on the algebraic hierarchy (permuted mesh; a 4^2 box, too
#: small for the geometric one) or by GAUSS_SEIDEL (box and permuted).
AMG_GS = {
    "amg_permuted": ("permuted", 16, "MULTIGRID"),
    "amg_tiny_box": ("box", 4, "MULTIGRID"),
    "gs_box": ("box", 16, "GAUSS_SEIDEL"),
    "gs_permuted": ("permuted", 16, "GAUSS_SEIDEL"),
}


@pytest.mark.parametrize("name", sorted(AMG_GS))
def test_amg_and_gauss_seidel_on_cuda_match_cpu(dev, name):
    """solve_steady (solve_cavity's numerics, 10 iterations) on the card
    against the CPU: equal inner counts, fields to 1e-9 of their scale;
    the slice SpMV launched on the permuted meshes, the shift SpMV on
    the boxes."""
    from orc_tpu_torch.ops.slice_spmv import slice_spmv

    kind, n, method = AMG_GS[name]
    settings = default_settings().replace(
        matrix_solver=tset.MatrixSolverSettings(
            solver_type=tset.SolutionMethod[method], iterations=30,
            relaxation=0.9, multigrid_smoother_iterations=5,
            preconditioner=tset.PreconditionMethod.JACOBI,
        )
    )
    out = []
    for d in (dev, "cpu"):
        if kind == "box":
            mesh, table = cavity_case(n=n, device=d)
        else:
            mesh, table, _ = _permuted_cavity(n, torch.float64, d)
        shift_spmv.launches = slice_spmv.launches = 0
        state, hist = simple.solve_steady(
            mesh, table, settings, 1.0, 0.01, iterations=10, reporting_interval=10,
            verbose=False,
        )
        if d == dev:
            assert (slice_spmv if kind == "permuted" else shift_spmv).launches > 0
        out.append((state, simple.stack_history(hist)))
    (sg, hg), (sc, hc) = out
    np.testing.assert_array_equal(hg.mom_iters, hc.mom_iters)
    np.testing.assert_array_equal(hg.pc_iters, hc.pc_iters)
    for f in ("vel", "p"):
        _close(getattr(sg, f), getattr(sc, f), 1e-9, f)


@pytest.mark.parametrize("kind", ["box", "permuted"])
def test_initialize_flow_on_cuda_matches_cpu(dev, kind):
    """initialize_flow (the Jacobi pressure and BiCGSTAB psi solves on the
    shift or slice SpMV, the per-cell least-squares solve) on the card
    against the CPU to 1e-12 of scale, float64: a velocity-inlet channel
    and the permuted cavity as a pressure-driven duct."""
    from orc_tpu_torch.mesh.zones import FaceCondition
    from orc_tpu_torch.solver.init_fields import initialize_flow

    out = []
    for d in (dev, "cpu"):
        if kind == "box":
            mesh, table = couette_case(16, 8, params=ChannelFlowParameters(), velocity_inlet=1e-3, device=d)
        else:
            mesh, table, _ = _permuted_cavity(16, torch.float64, d)
            table.set("INLET", FaceCondition.PRESSURE_INLET, scalar_value=1.0)
            table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
            table.set("TOP_WALL", FaceCondition.WALL, vector_value=(0.0, 0.0, 0.0))
        out.append(initialize_flow(mesh, table, 1e-3, 1000.0))
    for f in ("vel", "p"):
        _close(getattr(out[0], f), getattr(out[1], f), 1e-12, f)


@pytest.mark.parametrize("kind", ["box", "relabelled"])
def test_cli_run_on_cuda_matches_cpu(dev, kind, tmp_path):
    """`run --device cuda` against `run --device cpu` (orc_tpu_torch.cli)
    on a 16^2 copy of examples/cavity.toml, as a generated box and as a
    TGRID file with relabelled cells (RCM order, slice plan), 20
    iterations: the checkpoints' vel, p and mom_diag within 1e-9 of
    scale, float64, and equal inner iteration counts in the histories."""
    import importlib.util
    from pathlib import Path

    from orc_tpu_torch.cli import main
    from orc_tpu_torch.mesh.generate import write_tgrid

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if kind == "box":
        where = dict(dims=(16, 16, 1))
    else:
        write_tgrid(str(tmp_path / "box.msh"), 16, 16, 1, lengths=(1.0, 1.0, 1.0 / 16))
        smoke.permuted_tgrid(str(tmp_path / "box.msh"), str(tmp_path / "mesh.msh"), seed=5)
        where = dict(mesh=tmp_path / "mesh.msh")
    text = (root / "examples" / "cavity.toml").read_text()
    out = []
    for device in (str(dev), "cpu"):
        d = tmp_path / device
        d.mkdir()
        case = d / "case.toml"
        case.write_text(smoke.case_copy(text, d, iterations=20, data=False, **where))
        assert main(["run", str(case), "--history", str(d / "h.npz"), "--device", device]) == 0
        with np.load(d / "checkpoint.npz") as c, np.load(d / "h.npz") as h:
            out.append(({k: c[k] for k in ("vel", "p", "mom_diag")},
                        {k: h[k] for k in ("mom_iters", "pc_iters")}))
    (cg, hg), (cc, hc) = out
    for k in ("mom_iters", "pc_iters"):
        np.testing.assert_array_equal(hg[k], hc[k])
    for k in ("vel", "p", "mom_diag"):
        _close(torch.from_numpy(cg[k]), torch.from_numpy(cc[k]), 1e-9, k)


@pytest.mark.parametrize(
    "name,parts,method",
    [
        ("default", 2, "slab"), ("flagship", 4, "slab"), ("default", 4, "rcb"),
        ("default", 3, "slab"), ("flagship", 3, "slab"),
    ],
)
def test_sharded_on_cuda_matches_cpu(dev, name, parts, method):
    """solve_steady_sharded with its partitions on the one card
    (devices=[card] * P) against the same sharded run on the CPU, 16^2
    f64 cavity, 6 iterations: vel and p within 1e-9 of scale, equal
    inner iteration counts; slab windows launch the assembly kernels once
    per partition per iteration, RCB partitions (the face-major step)
    none. Three slabs of 86 cells start and end inside rows of 16."""
    from orc_tpu_torch.parallel.sharded import solve_steady_sharded

    settings = default_settings() if name == "default" else flagship_settings()
    kernels = (asm.momentum_assembly, asm.pc_assembly) if name == "default" else (
        asm.fc_momentum_assembly, asm.fc_pc_assembly)
    out = []
    for d in (dev, torch.device("cpu")):
        mesh, table = cavity_case(n=16, device=d)
        before = [k.launches for k in kernels]
        state, hist = solve_steady_sharded(
            mesh, table, settings, 1.0, 0.01, iterations=6, reporting_interval=6,
            devices=[d] * parts, partition_method=method, verbose=False,
        )
        if d.type == "cuda":
            want = 6 * parts if method == "slab" else 0
            assert [k.launches - b for k, b in zip(kernels, before)] == [want, want]
        out.append((state, simple.stack_history(hist)))
    (sg, hg), (sc, hc) = out
    for k in ("mom_iters", "pc_iters"):
        np.testing.assert_array_equal(
            torch.as_tensor(getattr(hg, k)).cpu().numpy(),
            torch.as_tensor(getattr(hc, k)).cpu().numpy(),
        )
    for k in ("vel", "p"):
        _close(getattr(sg, k).cpu(), getattr(sc, k), 1e-9, k)


# --- the face-major momentum assembly (csrc/fm_assembly.cu) ---------------

FM_FAMILIES = {
    "ud": (tset.MomentumScheme.UD, None),
    "cd1": (tset.MomentumScheme.CD1, None),
    "tvd_dc-lud": (tset.MomentumScheme.TVD_DC, tset.tvd_lud),
    "tvd_dc-quick": (tset.MomentumScheme.TVD_DC, tset.tvd_quick),
    "tvd_dc-umist": (tset.MomentumScheme.TVD_DC, tset.tvd_umist),
}


def _off_boundary(t):
    """A copy of `t` whose storage starts one element past a 16-byte
    boundary: the kernel's rows then take one load a slot."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def _fm_meshes(case, dtype, dev):
    """[(mesh, table)] of a face-major kernel case on `dev`: the 37 x 9
    channel with a pressure inlet and the 6 x 5 x 4 one with a velocity
    inlet, the permuted 24^2 cavity (RCM order, a slice plan), the two
    windows of a 2-slab partition of the 37 x 9 channel (ghost, padding
    and trash rows inactive), and the 6 x 5 x 4 channel with its slot
    tables off 16-byte boundaries."""
    import dataclasses

    from orc_tpu_torch.parallel.partition import partition_mesh

    if case == "permuted":
        mesh, table, _ = _permuted_cavity(24, dtype, dev, seed=2)
        return [(mesh, table)]
    shape, vinlet = ((37, 9, 1), None) if case.startswith("37x9") else ((6, 5, 4), 1e-3)
    mesh, table = couette_case(
        *shape, params=ChannelFlowParameters(top_wall_velocity=5e-4, dp_dx=5.0),
        velocity_inlet=vinlet, dtype=dtype, device=dev,
    )
    if case.endswith("slabs"):
        return [(m, table) for m in partition_mesh(mesh, 2, method="slab").local_meshes]
    if case.endswith("unaligned"):
        mesh = dataclasses.replace(mesh, **{
            k: _off_boundary(getattr(mesh, k))
            for k in ("cell_faces", "cell_neighbors", "cell_face_sign", "cell_face_mask")
        })
    return [(mesh, table)]


@pytest.mark.parametrize("family", sorted(FM_FAMILIES))
@pytest.mark.parametrize(
    "case", ["37x9_pressure", "6x5x4_vinlet", "permuted", "37x9_pressure-2slabs",
             "6x5x4_vinlet-unaligned"],
)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fm_momentum_kernel_matches_plain(dev, dtype, case, family):
    """The face-major momentum kernel (ops/fm_assembly.py) against
    face_pressure + momentum_system on the card, each output to the
    dtype's tolerance of its largest value, LINEAR and LINEAR_WEIGHTED
    face pressures, IMPLICIT and EXPLICIT relaxation, steady and
    transient; a second launch gives the same bits (gather only, no
    atomics)."""
    from orc_tpu_torch.ops import fm_assembly as fm
    from orc_tpu_torch.ops.assembly import diffusion_system
    from orc_tpu_torch.ops.fields import face_bc

    dt = DTYPES[dtype]
    scheme, psi = FM_FAMILIES[family]
    for mesh, table in _fm_meshes(case, dt, dev):
        C = mesh.n_cells
        zc, zs, zv = device_bc(table, dtype=dt, device=dev)
        fbc = face_bc(mesh, zc, zs, zv)
        diff = diffusion_system(mesh, fbc, torch.tensor(1e-3, dtype=dt, device=dev))
        if case.endswith("unaligned"):
            diff = diff._replace(off=_off_boundary(diff.off))
        rng = np.random.default_rng(7)
        t = lambda a: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731
        vel, vel_n = t(rng.standard_normal((C, 3)) * 0.1), t(rng.standard_normal((C, 3)) * 0.1)
        p, flux = t(rng.standard_normal(C) * 0.05), t(rng.standard_normal(mesh.n_faces) * 0.1)
        grad_v = t(rng.standard_normal((C, 3, 3)))
        for pi in (tset.PressureInterpolation.LINEAR, tset.PressureInterpolation.LINEAR_WEIGHTED):
            for mode in tset.RelaxationMode:
                s = tset.NumericalSettings(
                    momentum=scheme, tvd_psi=psi, pressure_interpolation=pi,
                    relaxation_mode=mode, momentum_relaxation=0.7,
                )
                for inertia in (None, (1000.0 * mesh.cell_volume / 0.01, vel_n)):
                    args = (mesh, fbc, s, 1.0, vel, flux, p, diff)
                    kw = dict(grad_vel=grad_v, inertia=inertia)
                    before = fm.fm_momentum_assembly.launches
                    A, b, pe = fm.fm_momentum_assembly(*args, **kw)
                    A2, b2, pe2 = fm.fm_momentum_assembly(*args, **kw)
                    assert fm.fm_momentum_assembly.launches == before + 2
                    R, rb, rpe = fm.fm_momentum_plain(*args, **kw)
                    for name, a, a2, r in (("diag", A.diag, A2.diag, R.diag),
                                           ("off", A.off, A2.off, R.off),
                                           ("b", b, b2, rb), ("pe", pe, pe2, rpe)):
                        assert torch.equal(a, a2), name
                        _close(a, r, TOL[dtype], f"{family} {pi.value} {mode.value} {name}")


@pytest.mark.parametrize("coupling", ["SIMPLE", "SIMPLE_FC"])
def test_fm_kernel_steps_on_cuda_match_cpu(dev, coupling):
    """The face-major steps with the face-major momentum kernel on the
    card (one launch an iteration) against the plain steps on the CPU,
    16^2 f64 cavity, Jacobi pressure solves, 10 iterations: fields
    within 1e-9 of their scale."""
    from orc_tpu_torch.ops import fm_assembly as fm

    settings = (
        default_settings().replace(
            pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED)
        if coupling == "SIMPLE" else flagship_settings()
    ).replace(matrix_solver=JACOBI_50)
    out = []
    for d in (dev, "cpu"):
        mesh, table = cavity_case(n=16, device=d)
        before = fm.fm_momentum_assembly.launches
        state, _ = simple.solve_steady(
            mesh, table, settings, 1.0, 0.01, iterations=10, reporting_interval=10,
            verbose=False, use_ck=False,
        )
        assert fm.fm_momentum_assembly.launches - before == (10 if d == dev else 0)
        out.append(state)
    for k in ("vel", "p"):
        _close(getattr(out[0], k).cpu(), getattr(out[1], k), 1e-9, k)
