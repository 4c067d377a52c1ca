"""Drive orc_tpu_torch's main path on one NVIDIA GPU and check it.

Usage (from the repository root, on a machine with a CUDA GPU):

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
1. device: the card's name and power limit, TF32 off;
2. build: compile csrc/*.cu into build/orc_tpu_torch/ (first use);
3. each of the four CUDA kernels against its plain torch version at the
   shapes of the main path, with times (CUDA events), and the whole
   SIMPLE slice on the card against the same slice on the CPU on a small
   cavity;
4. couette 128x64x1 float64 with bench.py's configuration through
   solve_steady: 100 warm-up + 500 timed iterations, u_mean within 25%
   of the analytical 1.0833e-3;
5. lid-driven cavity 1024^2 float32 with solve_cavity's configuration
   at Re = 1000: 10 warm-up + 50 timed iterations, finite |u| < 2;
phases 4 and 5 end with a short window under torch.profiler (device time
by kernel, device busy share);
then one JSON line with every kernel's launches, error and times, and
as the last line {"ok": true, "device": {...}}.

Kernel launch counters are reset just before phase 4 and read after
phase 5: every kernel of the path must have launched in that run.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

ANALYTICAL_U_MEAN = 5e-4 / 2 + 1e-3**2 / (12 * 0.001) * 10.0  # 1.0833e-3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


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
    """(max abs error, max error relative to the largest |ref|)."""
    got, ref = (tuple(t) if isinstance(t, tuple) else (t,) for t in (got, ref))
    abs_e = max(float((g.double() - r.double()).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.double().abs().max()) for r in ref)
    return abs_e, abs_e / scale if scale else abs_e


class Kernel:
    """Results of one kernel's comparisons for the JSON summary."""

    def __init__(self, name, fn, source, replaces):
        self.name, self.fn, self.source, self.replaces = name, fn, source, replaces
        self.max_abs_err = 0.0
        self.ms = self.plain_ms = None

    def compare(self, label, kernel_call, plain_call, dtype, nbytes, timed):
        got, ref = kernel_call(), plain_call()
        torch.cuda.synchronize()
        abs_e, rel_e = max_err(got, ref)
        self.max_abs_err = max(self.max_abs_err, abs_e)
        ms, plain_ms = time_ms(kernel_call), time_ms(plain_call)
        if timed:
            self.ms, self.plain_ms = ms, plain_ms
        log(
            f"  {self.name:20s} {label:34s} max_abs_err={abs_e:.3e} "
            f"max_rel_err={rel_e:.3e} (tol {TOL[dtype]:.0e})  kernel "
            f"{ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"{nbytes / ms / 1e6:.0f} GB/s "
            f"({100 * nbytes / ms / 1e-3 / HBM_BYTES_PER_S:.1f}% of 3.35 TB/s)"
        )
        if not rel_e <= TOL[dtype]:
            raise AssertionError(
                f"{self.name} {label}: kernel disagrees with its plain "
                f"version (relative error {rel_e:.3e} > {TOL[dtype]:.0e})"
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
        C * (4 * f32 + 4 + (1 + K + 3) * f32), timed=True,
    )
    p_args = (vel, md, bcv, flags, cols, 1.0)
    pc.compare(
        "cavity 1024^2 f32", lambda: asm.pc_assembly(*p_args),
        lambda: asm.pc_assembly_plain(*p_args), torch.float32,
        C * (4 * f32 + 4 + (1 + K + 1) * f32), timed=True,
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
        _abs, rel = max_err(getattr(sg, name).cpu(), getattr(sc, name))
        log(f"  {name}: max error / scale = {rel:.3e} (tol 1e-9)")
        if not rel <= 1e-9:
            raise AssertionError(f"cuda vs cpu {name} differ by {rel:.3e}")
    log(f"  pc_iters equal: {hg.pc_iters.tolist()}")


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


def phase_couette(dev):
    log("== phase 4: couette 128x64x1 f64, bench.py configuration")
    from orc_tpu_torch.mesh.generate import structured_box_mesh
    from orc_tpu_torch.mesh.zones import FaceCondition
    from orc_tpu_torch.utils.settings import (
        MatrixSolverSettings,
        NumericalSettings,
        PreconditionMethod,
        SolutionMethod,
    )

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
    settings = NumericalSettings(
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB, iterations=50,
            preconditioner=PreconditionMethod.JACOBI,
        ),
    )
    state, _, warm_s = _timed_solve(mesh, table, settings, 1000.0, 0.001, None, 100, 100)
    state, hist, dt = _timed_solve(mesh, table, settings, 1000.0, 0.001, state, 500, 100)
    u = state.vel[:, 0].cpu().numpy()
    if not np.isfinite(u).all():
        raise AssertionError("couette produced non-finite fields")
    err = abs(u.mean() - ANALYTICAL_U_MEAN) / ANALYTICAL_U_MEAN
    pc_it = np.concatenate([h.pc_iters.cpu().numpy() for h in hist])
    mom_it = np.concatenate([h.mom_iters.cpu().numpy() for h in hist])
    log(
        f"  warm-up 100 iterations {warm_s:.2f} s; 500 timed iterations "
        f"{dt:.3f} s -> {500 / dt:.1f} iters/s ({1e3 * dt / 500:.3f} ms/iter)"
    )
    log(
        f"  u_mean={u.mean():.4e} (analytical {ANALYTICAL_U_MEAN:.4e}, "
        f"rel err {err:.3f}, limit 0.25); mean inner iterations: momentum "
        f"{mom_it.mean(axis=0).round(2).tolist()}, pressure {pc_it.mean():.2f}"
    )
    if not err < 0.25:
        raise AssertionError("couette u_mean drifted from the analytical value")
    profile(mesh, table, settings, 1000.0, 0.001, state, iterations=20)
    return dict(iters_per_s=500 / dt, u_mean=float(u.mean()))


def phase_cavity(dev):
    log("== phase 5: cavity 1024^2 f32, solve_cavity configuration, Re=1000")
    from orc_tpu_torch.models.cavity import cavity_case, default_settings

    mesh, table = cavity_case(n=1024, dtype=torch.float32, device=dev)
    settings = default_settings()
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
    for t, key, count in sorted(rows, reverse=True)[:10]:
        log(f"    {t / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")


def main():
    from orc_tpu_torch.ops import fused_assembly as asm
    from orc_tpu_torch.ops.fused_smooth import fused_jacobi_sweeps
    from orc_tpu_torch.ops.shift_spmv import shift_spmv

    dev = phase_device()
    phase_build()
    kernels = (
        Kernel("shift_spmv", shift_spmv, "orc_tpu_torch/csrc/shift_spmv.cu",
               "orc_tpu/ops/pallas_spmv.py:39"),
        Kernel("fused_jacobi_sweeps", fused_jacobi_sweeps,
               "orc_tpu_torch/csrc/jacobi_sweeps.cu",
               "orc_tpu/ops/pallas_smooth.py:98"),
        Kernel("momentum_assembly", asm.momentum_assembly,
               "orc_tpu_torch/csrc/assembly.cu",
               "orc_tpu/ops/pallas_assembly.py:189"),
        Kernel("pc_assembly", asm.pc_assembly, "orc_tpu_torch/csrc/assembly.cu",
               "orc_tpu/ops/pallas_assembly.py:632"),
    )
    phase_kernels(dev, kernels)
    phase_small_reference(dev)

    for k in kernels:
        k.fn.launches = 0
    couette = phase_couette(dev)
    after_couette = {k.name: k.fn.launches for k in kernels}
    cavity = phase_cavity(dev)
    launches = {k.name: k.fn.launches for k in kernels}
    log(f"launches: couette {after_couette}; couette + cavity {launches}")
    if after_couette["shift_spmv"] <= 0:
        raise AssertionError("the couette run launched no shift_spmv kernel")
    for k in kernels:
        if launches[k.name] - after_couette[k.name] <= 0:
            raise AssertionError(f"the cavity run launched no {k.name} kernel")
    log(
        f"summary: couette f64 {couette['iters_per_s']:.1f} iters/s; cavity "
        f"1024^2 f32 {cavity['ms_per_iter']:.2f} ms/iter"
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
