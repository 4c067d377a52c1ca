"""The port's CUDA kernels on the card, each against its plain torch
version, and the SIMPLE and SIMPLE_FC slices on CUDA against the same
slices on CPU.

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


def test_shift_spmv_kernel_refuses_a_batched_matrix(dev):
    """Guards orc_tpu/ops/pallas_spmv.py `_kernel`'s contract (one
    matrix shared by the batch): a CUDA call outside it raises."""
    diag, off, _b, x = _system(100, (-10, -1, 1, 10), 3, torch.float64, dev)
    with pytest.raises(ValueError):
        shift_spmv(diag.expand(3, -1), off, (-10, -1, 1, 10), x)


@pytest.mark.parametrize("sweeps", [1, 6])
@pytest.mark.parametrize("batch", [0, 3])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_jacobi_sweeps_kernel_matches_plain(dev, dtype, batch, sweeps):
    """Guards orc_tpu/ops/pallas_smooth.py `_kernel` (via
    fused_jacobi_sweeps -> _fused_batched)."""
    offsets = (-64, -1, 1, 64)
    diag, off, b, x0 = _system(64 * 50, offsets, batch, DTYPES[dtype], dev, 1)
    before = fused_jacobi_sweeps.launches
    y = fused_jacobi_sweeps(diag, off, offsets, b, x0, sweeps, 0.8)
    torch.cuda.synchronize()
    assert fused_jacobi_sweeps.launches == before + sweeps
    _close(y, sweeps_plain(diag, off, offsets, b, x0, sweeps, 0.8), TOL[dtype])


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
    without a kernel code, a missing gradient, the transient term."""
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
    with pytest.raises(NotImplementedError):
        asm.fc_momentum_assembly(*args, inertia=(vel[:, 0], vel))


#: The pressure solve of the SIMPLE_FC slice comparisons: Jacobi. The
#: full-p BiCGSTAB amplifies one-ulp differences chaotically (ROADMAP
#: Queue 3), so only a stationary solver lets a device comparison hold
#: whole trajectories to 1e-9.
JACOBI_50 = tset.MatrixSolverSettings(
    solver_type=tset.SolutionMethod.JACOBI, iterations=50
)


def _solve(dev, name, iterations):
    if name == "cavity":
        mesh, table = cavity_case(n=16, device=dev)
        settings, rho, mu = default_settings(), 1.0, 0.01
    elif name == "fc_cavity":
        mesh, table = cavity_case(n=16, device=dev)
        settings = flagship_settings().replace(matrix_solver=JACOBI_50)
        rho, mu = 1.0, 1e-3
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
        ("couette", 50, (shift_spmv,)),
        ("fc_cavity", 10, FC_KERNELS),
        ("fc_couette", 50, FC_KERNELS),
    ],
)
def test_slice_on_cuda_matches_cpu(dev, name, iterations, kernels):
    """Guards the replacements together (pallas_spmv.py `_kernel`,
    pallas_smooth.py `_kernel`, pallas_assembly.py `_momentum_kernel`
    (both branches), `_pc_kernel` and `_fc_pc_kernel`): float64 SIMPLE or
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
    for k in every - set(KERNELS if name in ("cavity", "couette") else FC_KERNELS):
        assert counts[k.__name__] == 0, counts
    np.testing.assert_array_equal(hg.mom_iters, hc.mom_iters)
    np.testing.assert_array_equal(hg.pc_iters, hc.pc_iters)
    _close(sg.vel, sc.vel, 1e-9, "vel")
    _close(sg.p, sc.p, 1e-9, "p")
    if sg.flux is not None:
        _close(sg.flux, sc.flux, 1e-9, "flux")
