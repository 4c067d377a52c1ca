"""Drive orc_tpu_torch's main path on one NVIDIA GPU and check it.

Usage (from the repository root, on a machine with a CUDA GPU):

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
1. device: the card's name and power limit, TF32 off;
2. build: compile csrc/*.cu into build/orc_tpu_torch/ (one nvcc per
   source, in parallel) and print each kernel's registers and spills;
3. each of the six CUDA kernels against its plain torch version at the
   shapes of the main paths, with times (CUDA events): the parity
   kernels on the 1024^2 f32 cavity, the SIMPLE_FC assembly kernels on
   the 1024^2 f32 flagship-numerics cavity and the 128x64 f64 FC
   couette;
3b. the SIMPLE and SIMPLE_FC slices on the card against the same slices
   on the CPU on a 16^2 float64 cavity, and the FC flux's conservation;
4. couette 128x64x1 float64 with bench.py's configuration (parity
   SIMPLE) through solve_steady: 100 warm-up + 300 timed iterations,
   u_mean within 25% of the analytical 1.0833e-3;
5. lid-driven cavity 1024^2 float32 with solve_cavity's configuration
   (parity SIMPLE) at Re = 1000: 10 warm-up + 50 timed iterations,
   finite |u| < 2;
6. SIMPLE_FC couette 128x64x1 float64 with the FC residual fixture's
   settings: 100 warm-up + 500 timed iterations, u_mean within 1e-6 of
   orc_tpu's after those 600 iterations, then 900 more and u_mean within
   25% of the analytical value (the implicitly relaxed FC loop develops
   the flow slowly: orc_tpu is 48% short at 600 iterations);
7. SIMPLE_FC cavity 1024^2 float32 with the Ghia flagship numerics at
   Re = 1000: 10 warm-up + 50 timed iterations from cold, finite
   |u| < 2;
8. solve_steady_sequenced 64^2 -> 128^2 float32, flagship numerics, 200
   iterations per level, finite fields;
phases 4-7 end with a short window under torch.profiler (device time by
kernel, device busy share);
then one JSON line with every kernel's launches, error and times, and
as the last line {"ok": true, "device": {...}}.

Kernel launch counters are set to 0 just before each of phases 4-8 and
read just after it: each phase must launch every kernel of its path,
and the SIMPLE_FC phases none of the parity assembly kernels.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ANALYTICAL_U_MEAN = 5e-4 / 2 + 1e-3**2 / (12 * 0.001) * 10.0  # 1.0833e-3
#: u_mean of orc_tpu's SIMPLE_FC couette 128x64 f64 with the same
#: settings after 600 iterations (JAX on CPU, f64); recomputed from
#: orc_tpu by tests/test_torch_fc.py::test_fc_couette_reference_u_mean.
#: The implicitly relaxed FC loop develops the channel flow slowly:
#: orc_tpu itself is 48% short of the analytical value there, 24% at
#: 1200 and 17% at 1500.
ORC_TPU_FC_COUETTE_U_MEAN_600 = 5.663693306183816e-4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
ASM_OUT = ("diag", "off", "b")  # the assembly kernels' outputs


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps=5, inner=10):
    """Median over `reps` of the mean CUDA-event time of `inner` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def max_err(got, ref):
    """(max abs error, [max error / max |ref| of each output]). Each
    output is held to its own scale, so a small output (pressure
    coefficients beside face fluxes) cannot hide behind a large one."""
    got, ref = (tuple(t) if isinstance(t, tuple) else (t,) for t in (got, ref))
    abs_errs, rels = [], []
    for g, r in zip(got, ref):
        e = float((g.double() - r.double()).abs().max())
        scale = float(r.double().abs().max())
        abs_errs.append(e)
        rels.append(e / scale if scale else e)
    return max(abs_errs), rels


class Kernel:
    """Results of one kernel's comparisons for the JSON summary."""

    def __init__(self, name, fn, source, replaces):
        self.name, self.fn, self.source, self.replaces = name, fn, source, replaces
        self.max_abs_err = 0.0
        self.ms = self.plain_ms = None

    def compare(self, label, kernel_call, plain_call, dtype, nbytes, timed,
                outputs=("y",)):
        """Hold the kernel against its plain version, each of `outputs`
        at TOL[dtype] of its own largest |ref|, then time both."""
        got, ref = kernel_call(), plain_call()
        torch.cuda.synchronize()
        abs_e, rels = max_err(got, ref)
        if len(rels) != len(outputs):
            raise AssertionError(f"{self.name}: {len(rels)} outputs, expected {outputs}")
        self.max_abs_err = max(self.max_abs_err, abs_e)
        ms, plain_ms = time_ms(kernel_call), time_ms(plain_call)
        if timed:
            self.ms, self.plain_ms = ms, plain_ms
        per_output = " ".join(f"{o}={r:.2e}" for o, r in zip(outputs, rels))
        log(
            f"  {self.name:20s} {label:34s} max_abs_err={abs_e:.3e} "
            f"err/scale {per_output} (tol {TOL[dtype]:.0e})  kernel "
            f"{ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"{nbytes / ms / 1e6:.0f} GB/s "
            f"({100 * nbytes / ms / 1e-3 / HBM_BYTES_PER_S:.1f}% of 3.35 TB/s)"
        )
        if not all(r <= TOL[dtype] for r in rels):  # NaN fails too
            raise AssertionError(
                f"{self.name} {label}: kernel disagrees with its plain "
                f"version ({per_output}; tol {TOL[dtype]:.0e})"
            )


def structured_system(C, offsets, B, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    off = rng.uniform(-1.0, 0.0, size=(C, len(offsets)))
    c = np.arange(C)
    for k, d in enumerate(offsets):
        off[((c + d) < 0) | ((c + d) >= C), k] = 0.0
    diag = 1.0 + np.abs(off).sum(axis=1) + rng.random(C)
    shape = (B, C) if B > 1 else (C,)
    arrays = (diag, off, rng.standard_normal(shape))
    return [torch.tensor(a, dtype=dtype, device=dev) for a in arrays]


def phase_device():
    log("== phase 1: device")
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: chip_smoke.py needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"device: {torch.cuda.get_device_name(0)}")
    log(smi)
    log(
        f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}"
    )
    return dev


def phase_build():
    log("== phase 2: build")
    from orc_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    nvcc_s = _cuda.build() if _cuda.is_stale() else 0.0
    _cuda.library()
    log(
        f"kernels built into {_cuda.LIB_PATH} (nvcc {nvcc_s:.1f} s, "
        f"total {time.perf_counter() - t0:.1f} s)"
    )
    if _cuda.PTXAS_LOG.exists():
        for name, regs, spills in ptxas_report(_cuda.PTXAS_LOG.read_text()):
            log(f"  ptxas {name}: {regs} registers, spill stores/loads {spills}")


def ptxas_report(text):
    """(kernel, registers, "stores/loads" spill bytes) per entry function
    of an nvcc -Xptxas=-v log, names demangled where c++filt exists."""
    out, name, spills = [], None, "?"
    cxxfilt = shutil.which("c++filt")
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            if cxxfilt:
                name = subprocess.run(
                    [cxxfilt, name], capture_output=True, text=True, timeout=60
                ).stdout.strip().split("(")[0].replace("void ", "")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = f"{m.group(1)}/{m.group(2)}"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spills))
            name, spills = None, "?"
    return out


def phase_kernels(dev, kernels):
    log("== phase 3: kernels against their plain versions, main-path shapes")
    from orc_tpu_torch.models.cavity import cavity_case, default_settings
    from orc_tpu_torch.ops import fused_assembly as asm
    from orc_tpu_torch.ops.ck_ops import build_ck_geometry
    from orc_tpu_torch.ops.fields import device_bc
    from orc_tpu_torch.ops.fused_smooth import fused_jacobi_sweeps, sweeps_plain
    from orc_tpu_torch.ops.shift_spmv import shift_spmv, shift_spmv_plain
    from orc_tpu_torch.ops.spmv import EllMatrix
    from orc_tpu_torch.solver.simple import solve_steady

    spmv, sweeps, mom, pc = kernels
    # Real inputs: the 1024^2 f32 cavity after 5 iterations.
    mesh, table = cavity_case(n=1024, dtype=torch.float32, device=dev)
    settings = default_settings()
    state, _ = solve_steady(
        mesh, table, settings, 1.0, 1e-3, iterations=5, reporting_interval=5,
        verbose=False,
    )
    _zc, zs, zv = device_bc(table, dtype=mesh.dtype, device=dev)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    cols = asm.column_specs(mesh, table)
    flags = asm.pack_flags(ck.interior, ck.mask)
    bcv = asm.bc_value_table(zs, zv)
    vel, p = state.vel.contiguous(), state.p
    md = state.mom_diag[0].contiguous()
    C, K = mesh.n_cells, len(cols)
    f32 = 4
    m_args = (vel, p, bcv, flags, cols, 1.0, 1e-3, settings.momentum_relaxation)
    mom.compare(
        "cavity 1024^2 f32", lambda: asm.momentum_assembly(*m_args),
        lambda: asm.momentum_assembly_plain(*m_args), torch.float32,
        C * (4 * f32 + 4 + (1 + K + 3) * f32), timed=True, outputs=ASM_OUT,
    )
    p_args = (vel, md, bcv, flags, cols, 1.0)
    pc.compare(
        "cavity 1024^2 f32", lambda: asm.pc_assembly(*p_args),
        lambda: asm.pc_assembly_plain(*p_args), torch.float32,
        C * (4 * f32 + 4 + (1 + K + 1) * f32), timed=True, outputs=ASM_OUT,
    )
    # The solvers' operands: Jacobi-preconditioned split-column systems.
    mdiag, moff, b3 = asm.momentum_assembly(*m_args)
    A = EllMatrix(mdiag, moff, None, mesh.neighbor_offsets).split_columns()
    A, inv_d = A.jacobi_preconditioned()
    b3 = (b3 * inv_d).contiguous()
    x3 = vel.T.contiguous()
    Ks = len(A.off)
    sweeps.compare(
        "cavity 1024^2 f32 B=3 6 sweeps",
        lambda: fused_jacobi_sweeps(A.diag, A.off, A.offsets, b3, x3, 6, 0.8),
        lambda: sweeps_plain(A.diag, A.off, A.offsets, b3, x3, 6, 0.8),
        torch.float32, 6 * C * ((1 + Ks) * f32 + 3 * 3 * f32), timed=True,
        outputs=("x",),
    )
    pdiag, poff, _bp = asm.pc_assembly(*p_args)
    P, _ = EllMatrix(pdiag, poff, None, mesh.neighbor_offsets).split_columns().jacobi_preconditioned()
    for B in (1, 3):
        x = x3[0] if B == 1 else x3
        spmv.compare(
            f"cavity 1024^2 f32 B={B} split",
            lambda: shift_spmv(P.diag, P.off, P.offsets, x),
            lambda: shift_spmv_plain(P.diag, P.off, P.offsets, x),
            torch.float32, C * ((1 + len(P.off)) * f32 + 2 * B * f32),
            timed=B == 1,
        )
    couette_offsets = (-128, -1, 1, 128)
    for B in (1, 3):
        diag, off, x = structured_system(128 * 64, couette_offsets, B, torch.float64, dev)
        cols64 = tuple(off[:, k] for k in range(4))
        spmv.compare(
            f"couette 128x64 f64 B={B} split",
            lambda: shift_spmv(diag, cols64, couette_offsets, x),
            lambda: shift_spmv_plain(diag, cols64, couette_offsets, x),
            torch.float64, 128 * 64 * (5 * 8 + 2 * B * 8), timed=False,
        )
    del state, A, P, b3, x3


def _fc_kernel_inputs(mesh, table, settings, state):
    """The SIMPLE_FC kernels' operands on the main path: the gate's
    (cols, spec), the state's fields and stored flux, flags, BC values
    and the iteration-start gradients."""
    from orc_tpu_torch.ops import fused_assembly as asm
    from orc_tpu_torch.ops.ck_ops import (
        build_ck_geometry,
        ck_bc,
        ck_pressure_gradient,
        ck_velocity_gradient,
    )
    from orc_tpu_torch.ops.fields import device_bc
    from orc_tpu_torch.solver.simple import _kernel_asm_spec

    zc, zs, zv = device_bc(table, dtype=mesh.dtype, device=mesh.device)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    cols, spec = _kernel_asm_spec(mesh, table, settings, ck, fc=True)
    return dict(
        cols=cols, spec=spec, flags=asm.pack_flags(ck.interior, ck.mask),
        bcv=asm.bc_value_table(zs, zv), vel=state.vel.contiguous(), p=state.p,
        flux=state.flux, md=state.mom_diag[0].contiguous(),
        grad_p=ck_pressure_gradient(mesh, ck, bc, state.p),
        grad_vel=ck_velocity_gradient(mesh, ck, bc, state.vel),
    )


def phase_fc_kernels(dev, fc_mom, fc_pc):
    log("== phase 3: SIMPLE_FC assembly kernels against their plain versions")
    from orc_tpu_torch.models.cavity import cavity_case, flagship_settings
    from orc_tpu_torch.ops import fused_assembly as asm
    from orc_tpu_torch.solver.simple import solve_steady

    cases = [
        ("cavity 1024^2 f32 tvd_dc+umist+rc", torch.float32, True,
         lambda: cavity_case(n=1024, dtype=torch.float32, device=dev),
         flagship_settings(), 1.0, 1e-3),
        ("couette 128x64 f64 cd1+so+rc", torch.float64, False,
         lambda: couette_mesh(dev), fc_couette_settings(), 1000.0, 0.001),
    ]
    for label, dtype, timed, make, settings, rho, mu in cases:
        mesh, table = make()
        state, _ = solve_steady(
            mesh, table, settings, rho, mu, iterations=5, reporting_interval=5,
            verbose=False,
        )
        x = _fc_kernel_inputs(mesh, table, settings, state)
        C, K, sz = mesh.n_cells, len(x["cols"]), dtype.itemsize
        spec = x["spec"]
        m_args = (x["vel"], x["p"], x["flux"], x["bcv"], x["flags"], x["cols"],
                  rho, mu, settings.momentum_relaxation)
        m_kw = dict(grad_p=x["grad_p"], grad_vel=x["grad_vel"], spec=spec)
        # vel, p, K flux planes, grad vel / grad p when read; diag, K off, 3 b.
        reads = 3 + 1 + K + 9 * (spec.scheme == "tvd_dc") + 3 * spec.p_so
        fc_mom.compare(
            label, lambda: asm.fc_momentum_assembly(*m_args, **m_kw),
            lambda: asm.fc_momentum_assembly_plain(*m_args, **m_kw), dtype,
            C * (4 + (reads + 1 + K + 3) * sz), timed=timed, outputs=ASM_OUT,
        )
        p_args = (x["vel"], x["md"], x["bcv"], x["flags"], x["cols"], rho)
        p_kw = dict(grad_p=x["grad_p"], spec=spec)
        # vel, md, grad p when read; diag, K off, b, K flux_h.
        fc_pc.compare(
            label, lambda: asm.fc_pc_assembly(*p_args, **p_kw),
            lambda: asm.fc_pc_assembly_plain(*p_args, **p_kw), dtype,
            C * (4 + (4 + 3 * spec.rc + 2 + 2 * K) * sz), timed=timed,
            outputs=ASM_OUT + ("flux_h",),
        )
        del state, x


def couette_mesh(dev):
    """bench.py's couette channel, 128x64x1 float64."""
    from orc_tpu_torch.mesh.generate import structured_box_mesh
    from orc_tpu_torch.mesh.zones import FaceCondition

    mesh, table = structured_box_mesh(
        128, 64, 1, lengths=(0.002, 0.001, 0.0001), dtype=torch.float64,
        device=dev,
    )
    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(5e-4, 0.0, 0.0))
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("INLET", FaceCondition.PRESSURE_INLET, scalar_value=0.02)
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    return mesh, table


def _bicgstab_50():
    from orc_tpu_torch.utils.settings import (
        MatrixSolverSettings,
        PreconditionMethod,
        SolutionMethod,
    )

    return MatrixSolverSettings(
        solver_type=SolutionMethod.BICGSTAB, iterations=50,
        preconditioner=PreconditionMethod.JACOBI,
    )


def fc_couette_settings():
    """scripts/gen_residual_fixture.py build(fc_envelope=True): AUTO
    (-> SIMPLE_FC), CD1 + SecondOrder + Rhie-Chow, implicit relaxation
    0.7 / 0.3, BiCGSTAB(50) Jacobi."""
    from orc_tpu_torch.utils.settings import NumericalSettings, RelaxationMode

    return NumericalSettings(
        matrix_solver=_bicgstab_50(),
        relaxation_mode=RelaxationMode.IMPLICIT,
        momentum_relaxation=0.7,
        pressure_relaxation=0.3,
    )


def phase_small_reference(dev):
    """The slice on the card against the same slice on the CPU (plain
    versions) on a 16^2 float64 cavity: equal inner iteration counts and
    fields to 1e-9 of their scale."""
    log("== phase 3b: slice on the card vs on the CPU, cavity 16^2 f64, 10 iterations")
    from orc_tpu_torch.models.cavity import cavity_case, default_settings
    from orc_tpu_torch.solver.simple import solve_steady, stack_history

    out = []
    for d in (dev, torch.device("cpu")):
        mesh, table = cavity_case(n=16, device=d)
        state, hist = solve_steady(
            mesh, table, default_settings(), 1.0, 0.01, iterations=10,
            reporting_interval=10, verbose=False,
        )
        out.append((state, stack_history(hist)))
    (sg, hg), (sc, hc) = out
    np.testing.assert_array_equal(hg.mom_iters, hc.mom_iters)
    np.testing.assert_array_equal(hg.pc_iters, hc.pc_iters)
    for name in ("vel", "p"):
        rel = max_err(getattr(sg, name).cpu(), getattr(sc, name))[1][0]
        log(f"  {name}: max error / scale = {rel:.3e} (tol 1e-9)")
        if not rel <= 1e-9:
            raise AssertionError(f"cuda vs cpu {name} differ by {rel:.3e}")
    log(f"  pc_iters equal: {hg.pc_iters.tolist()}")
    phase_small_reference_fc(dev)


def _flux_divergence(mesh, flux):
    """(max |sum_k flux A|, max |flux A|) over the cells."""
    area = mesh.face_area[mesh.cell_faces.long()]
    fa = torch.where(mesh.cell_face_mask, flux * area, torch.zeros((), dtype=area.dtype, device=area.device))
    return float(fa.sum(dim=1).abs().max()), float(fa.abs().max())


def phase_small_reference_fc(dev):
    """SIMPLE_FC on the card against the CPU, 16^2 float64 cavity with the
    flagship numerics, 10 iterations, with equal inner iteration counts.
    With the pressure solved by Jacobi(50), fields and flux to 1e-9 of
    scale. With the flagship's own BiCGSTAB(50), which amplifies one-ulp
    differences on the full-p system (ROADMAP Queue 3), to 1e-6 of
    scale (measured 2.8e-8, flux, on the H100). Then the twin of orc_tpu's
    test_fc_flux_conservation_every_iteration on the card: three
    iterations into the 12^2 cavity, max |sum_k flux A| < 1e-3
    max |flux A| (div(flux) is the pressure solve's residual)."""
    log("== phase 3b: SIMPLE_FC on the card vs on the CPU, cavity 16^2 f64, 10 iterations")
    from orc_tpu_torch.models.cavity import cavity_case, flagship_settings
    from orc_tpu_torch.solver.simple import solve_steady, stack_history
    from orc_tpu_torch.utils.settings import MatrixSolverSettings, SolutionMethod

    jacobi = MatrixSolverSettings(solver_type=SolutionMethod.JACOBI, iterations=50)
    for solver in ("jacobi", "bicgstab"):
        settings = flagship_settings()
        if solver == "jacobi":
            settings = settings.replace(matrix_solver=jacobi)
        out = []
        for d in (dev, torch.device("cpu")):
            mesh, table = cavity_case(n=16, device=d)
            state, hist = solve_steady(
                mesh, table, settings, 1.0, 1e-3, iterations=10,
                reporting_interval=10, verbose=False,
            )
            div, scale = _flux_divergence(mesh, state.flux)
            log(f"  {solver} {d.type}: max |div flux| / max |flux A| = {div / scale:.3e}")
            out.append((state, stack_history(hist)))
        (sg, hg), (sc, hc) = out
        errs = {n: max_err(getattr(sg, n).cpu(), getattr(sc, n))[1][0] for n in ("vel", "p", "flux")}
        same_iters = bool(
            np.array_equal(hg.mom_iters, hc.mom_iters)
            and np.array_equal(hg.pc_iters, hc.pc_iters)
        )
        log(
            f"  {solver}: error / scale vel {errs['vel']:.3e} p {errs['p']:.3e} "
            f"flux {errs['flux']:.3e} (tol {1e-9 if solver == 'jacobi' else 1e-6:.0e}); pc_iters card {hg.pc_iters.tolist()} "
            f"cpu {hc.pc_iters.tolist()}"
        )
        if not same_iters:
            raise AssertionError(f"SIMPLE_FC {solver} cuda vs cpu: inner iteration counts differ")
        tol = 1e-9 if solver == "jacobi" else 1e-6
        for n, e in errs.items():
            if not e <= tol:
                raise AssertionError(f"SIMPLE_FC {solver} cuda vs cpu {n} differ by {e:.3e} (tol {tol:.0e})")
    from orc_tpu_torch.utils.settings import (
        MomentumScheme,
        NumericalSettings,
        PressureInterpolation,
        PressureVelocityCoupling,
        RelaxationMode,
    )

    mesh, table = cavity_case(n=12, device=dev)
    twin = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_velocity_coupling=PressureVelocityCoupling.SIMPLE_FC,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        relaxation_mode=RelaxationMode.IMPLICIT,
        momentum_relaxation=0.7,
        pressure_relaxation=0.3,
        matrix_solver=_bicgstab_50(),
    )
    state, _ = solve_steady(
        mesh, table, twin, 1.0, 0.01, iterations=3, reporting_interval=3,
        verbose=False,
    )
    div, scale = _flux_divergence(mesh, state.flux)
    log(f"  conservation, cavity 12^2, 3 iterations: max |div flux| / max |flux A| = {div / scale:.3e} (limit 1e-3)")
    if not div < 1e-3 * scale:
        raise AssertionError("SIMPLE_FC flux not conservative on the card")


def _timed_solve(mesh, table, settings, rho, mu, state, iterations, chunk):
    from orc_tpu_torch.solver.simple import solve_steady

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = solve_steady(
        mesh, table, settings, rho, mu, state=state, iterations=iterations,
        reporting_interval=chunk, verbose=False,
    )
    torch.cuda.synchronize()
    return state, hist, time.perf_counter() - t0


def phase_couette(dev, fc=False):
    """100 warm-up + `timed` timed iterations (iters/s), then the
    u_mean check against the analytical profile. The parity run is cut
    to 300 timed iterations to keep the script's run time down. The
    SIMPLE_FC run is first held against orc_tpu's u_mean after 600
    iterations, then continued to 1500 iterations before the analytical
    check (see ORC_TPU_FC_COUETTE_U_MEAN_600)."""
    from orc_tpu_torch.utils.settings import NumericalSettings

    if fc:
        log("== phase 6: SIMPLE_FC couette 128x64x1 f64, FC residual fixture settings")
        settings, timed = fc_couette_settings(), 500
    else:
        log("== phase 4: couette 128x64x1 f64, bench.py configuration")
        settings, timed = NumericalSettings(matrix_solver=_bicgstab_50()), 300
    mesh, table = couette_mesh(dev)
    state, _, warm_s = _timed_solve(mesh, table, settings, 1000.0, 0.001, None, 100, 100)
    state, hist, dt = _timed_solve(mesh, table, settings, 1000.0, 0.001, state, timed, 100)
    pc_it = np.concatenate([h.pc_iters.cpu().numpy() for h in hist])
    mom_it = np.concatenate([h.mom_iters.cpu().numpy() for h in hist])
    log(
        f"  warm-up 100 iterations {warm_s:.2f} s; {timed} timed iterations "
        f"{dt:.3f} s -> {timed / dt:.1f} iters/s ({1e3 * dt / timed:.3f} ms/iter); "
        f"mean inner iterations: momentum "
        f"{mom_it.mean(axis=0).round(2).tolist()}, pressure {pc_it.mean():.2f}"
    )
    done = 100 + timed
    if fc:
        u_ref = ORC_TPU_FC_COUETTE_U_MEAN_600
        u_600 = float(state.vel[:, 0].mean())
        rel = abs(u_600 - u_ref) / u_ref
        log(f"  u_mean after 600 iterations {u_600:.6e}, orc_tpu {u_ref:.6e} (rel diff {rel:.2e}, limit 1e-6)")
        if not rel < 1e-6:
            raise AssertionError("SIMPLE_FC couette left orc_tpu's trajectory")
        state, _, more_s = _timed_solve(mesh, table, settings, 1000.0, 0.001, state, 900, 300)
        done += 900
        log(f"  900 more iterations {more_s:.2f} s")
    u = state.vel[:, 0].cpu().numpy()
    if not np.isfinite(u).all():
        raise AssertionError("couette produced non-finite fields")
    err = abs(u.mean() - ANALYTICAL_U_MEAN) / ANALYTICAL_U_MEAN
    log(
        f"  u_mean after {done} iterations {u.mean():.4e} (analytical "
        f"{ANALYTICAL_U_MEAN:.4e}, rel err {err:.3f}, limit 0.25)"
    )
    if not err < 0.25:
        raise AssertionError("couette u_mean drifted from the analytical value")
    profile(mesh, table, settings, 1000.0, 0.001, state, iterations=20)
    return dict(iters_per_s=timed / dt, u_mean=float(u.mean()))


def phase_cavity(dev, fc=False):
    from orc_tpu_torch.models.cavity import (
        cavity_case,
        default_settings,
        flagship_settings,
    )

    if fc:
        log("== phase 7: SIMPLE_FC cavity 1024^2 f32, Ghia flagship numerics, Re=1000")
        settings = flagship_settings()
    else:
        log("== phase 5: cavity 1024^2 f32, solve_cavity configuration, Re=1000")
        settings = default_settings()
    mesh, table = cavity_case(n=1024, dtype=torch.float32, device=dev)
    state, _, warm_s = _timed_solve(mesh, table, settings, 1.0, 1e-3, None, 10, 10)
    state, hist, dt = _timed_solve(mesh, table, settings, 1.0, 1e-3, state, 50, 50)
    u = state.vel.cpu().numpy()
    if not (np.isfinite(u).all() and np.abs(u).max() < 2.0):
        raise AssertionError("cavity fields not finite or |u| >= 2")
    pc_it = hist[-1].pc_iters.cpu().numpy()
    mom_it = hist[-1].mom_iters.cpu().numpy()
    log(
        f"  warm-up 10 iterations {warm_s:.2f} s; 50 timed iterations "
        f"{dt:.3f} s -> {1e3 * dt / 50:.2f} ms/iter; |u| max {np.abs(u).max():.3f}"
    )
    log(
        f"  mean inner iterations: momentum {mom_it.mean(axis=0).tolist()}, "
        f"pressure {pc_it.mean():.2f}"
    )
    profile(mesh, table, settings, 1.0, 1e-3, state, iterations=5)
    return dict(ms_per_iter=1e3 * dt / 50)


def phase_sequenced(dev):
    log("== phase 8: solve_steady_sequenced 64^2 -> 128^2 f32, flagship numerics")
    from orc_tpu_torch.models.cavity import cavity_case, flagship_settings
    from orc_tpu_torch.solver.sequencing import solve_steady_sequenced

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hists = solve_steady_sequenced(
        lambda nx, ny, nz: cavity_case(n=nx, dtype=torch.float32, device=dev),
        [(64, 64, 1), (128, 128, 1)], flagship_settings(), 1.0, 1e-3,
        iterations_per_level=200, reporting_interval=200, verbose=False,
    )
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    u = state.vel.cpu().numpy()
    if not (np.isfinite(u).all() and np.isfinite(state.p.cpu().numpy()).all()):
        raise AssertionError("sequenced cascade produced non-finite fields")
    log(
        f"  2 levels x 200 iterations {dt:.2f} s; 128^2 |u| max "
        f"{np.abs(u).max():.3f}; final pressure iterations "
        f"{hists[-1][-1].pc_iters[-1].item()}"
    )


def profile(mesh, table, settings, rho, mu, state, iterations):
    """torch.profiler over a few iterations: device time by kernel and
    the device's busy share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _s, _h, dt = _timed_solve(
            mesh, table, settings, rho, mu, state, iterations, iterations
        )
    rows = [  # device-side kernel events only (op rows would double-count)
        (ev.self_device_time_total, ev.key, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
    ]
    busy_us = sum(t for t, _, _ in rows)
    log(
        f"  profile, {iterations} iterations: wall {1e3 * dt:.1f} ms, kernel "
        f"time {busy_us / 1e3:.1f} ms (device busy {100 * busy_us / 1e6 / dt:.1f}%), "
        f"{sum(c for _, _, c in rows)} kernel launches"
    )
    for t, key, count in sorted(rows, reverse=True)[:12]:
        log(f"    {t / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")


def main():
    from orc_tpu_torch.ops import fused_assembly as asm
    from orc_tpu_torch.ops.fused_smooth import fused_jacobi_sweeps
    from orc_tpu_torch.ops.shift_spmv import shift_spmv

    dev = phase_device()
    phase_build()
    asm_src = "orc_tpu_torch/csrc/assembly.cu"
    kernels = (
        Kernel("shift_spmv", shift_spmv, "orc_tpu_torch/csrc/shift_spmv.cu",
               "orc_tpu/ops/pallas_spmv.py:39"),
        Kernel("fused_jacobi_sweeps", fused_jacobi_sweeps,
               "orc_tpu_torch/csrc/jacobi_sweeps.cu",
               "orc_tpu/ops/pallas_smooth.py:98"),
        Kernel("momentum_assembly", asm.momentum_assembly, asm_src,
               "orc_tpu/ops/pallas_assembly.py:189"),
        Kernel("pc_assembly", asm.pc_assembly, asm_src,
               "orc_tpu/ops/pallas_assembly.py:632"),
        Kernel("fc_momentum_assembly", asm.fc_momentum_assembly, asm_src,
               "orc_tpu/ops/pallas_assembly.py:189"),
        Kernel("fc_pc_assembly", asm.fc_pc_assembly, asm_src,
               "orc_tpu/ops/pallas_assembly.py:856"),
    )
    spmv, sweeps, mom, pc, fc_mom, fc_pc = kernels
    phase_kernels(dev, (spmv, sweeps, mom, pc))
    phase_fc_kernels(dev, fc_mom, fc_pc)
    phase_small_reference(dev)

    # The main paths, each driven with the launch counts set to 0 just
    # before it and read just after it.
    parity, fc = (spmv, sweeps, mom, pc), (spmv, sweeps, fc_mom, fc_pc)
    paths = (
        ("parity couette", lambda: phase_couette(dev), (spmv,), ()),
        ("parity cavity", lambda: phase_cavity(dev), parity, (fc_mom, fc_pc)),
        ("fc couette", lambda: phase_couette(dev, fc=True), fc, (mom, pc)),
        ("fc cavity", lambda: phase_cavity(dev, fc=True), fc, (mom, pc)),
        ("fc sequenced", lambda: phase_sequenced(dev), fc, (mom, pc)),
    )
    results, launches = {}, {k.name: 0 for k in kernels}
    for label, run, must, must_not in paths:
        for k in kernels:
            k.fn.launches = 0
        results[label] = run()
        counts = {k.name: k.fn.launches for k in kernels}
        log(f"launches, {label}: {counts}")
        for k in must:
            if counts[k.name] <= 0:
                raise AssertionError(f"the {label} run launched no {k.name} kernel")
        for k in must_not:
            if counts[k.name] != 0:
                raise AssertionError(f"the {label} run launched {k.name}")
        for name, n in counts.items():
            launches[name] += n
    log(
        f"summary: couette f64 {results['parity couette']['iters_per_s']:.1f} "
        f"iters/s; cavity 1024^2 f32 {results['parity cavity']['ms_per_iter']:.2f} "
        f"ms/iter; SIMPLE_FC couette f64 {results['fc couette']['iters_per_s']:.1f} "
        f"iters/s; SIMPLE_FC cavity 1024^2 f32 "
        f"{results['fc cavity']['ms_per_iter']:.2f} ms/iter"
    )
    log(json.dumps({"kernels": [
        dict(name=k.name, route="cuda", source=k.source, replaces=k.replaces,
             launches=launches[k.name], max_abs_err=k.max_abs_err, ms=k.ms,
             plain_ms=k.plain_ms)
        for k in kernels
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
