"""Benchmark: SIMPLE iterations/sec on the couette 128x64x1 case (the
port's counterpart of the repository's bench.py headline).

Runs the reference's validated configuration (pressure-driven couette
with a moving wall, tests.rs:44-152 / main.rs:84-102) with the
reference's default discretization (CD1 + SecondOrder pressure +
Rhie-Chow face velocities, lib.rs:58-74) and 50-iteration
Jacobi-preconditioned BiCGSTAB on the mesh's device, asserts that the
bulk velocity tracks the analytical channel profile, and prints ONE
JSON line:

    {"metric": ..., "value": N, "unit": "iters/sec"}

Environment: BENCH_DTYPE (f64 | f32), BENCH_SOLVER (a SolutionMethod
value, default bicgstab), BENCH_MG_SMOOTH (multigrid smoother
iterations), BENCH_ITERS (iterations per timed run, default 100) and
BENCH_CK (1: the (c,k) step, 0: the face-major step). The mesh is the
generated 128x64x1 box. One warm-up run of BENCH_ITERS iterations, then
the median of five timed runs, each closed by a device synchronise.

Unless BENCH_EXTENDED is set to anything but "1", the lines of
`extended_metrics` (orc_tpu's names, in its order, at BENCH_EXT_N^2
cells, default 1024) print before the headline, which stays the last
line; an error in them goes to stderr and the headline still prints.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

U_MEAN_ANALYTICAL = 5e-4 / 2 + 1e-3**2 / (12 * 0.001) * 10.0  # 1.0833e-3

#: HBM3 rate of the H100 SXM (GB/s), the bandwidth lines' vs_baseline.
H100_HBM_GBPS = 3350.0


def build_case(device: torch.device | str = "cuda"):
    """(mesh, table) of the couette channel on `device`, in BENCH_DTYPE."""
    from orc_tpu_torch.mesh import structured_box_mesh
    from orc_tpu_torch.mesh.zones import FaceCondition

    dtype = (
        torch.float32
        if os.environ.get("BENCH_DTYPE", "f64") == "f32"
        else torch.float64
    )
    mesh, table = structured_box_mesh(
        128, 64, 1, lengths=(0.002, 0.001, 0.0001), dtype=dtype, device=device
    )
    # BCs of the reference's VALIDATED case (solve_channel_flow,
    # tests.rs:60-76 with main.rs:84-102 parameters): moving top wall
    # 5e-4 m/s + streamwise dp/dx = 10 Pa/m. Analytical
    # u_mean = U/2 + h^2/(12 mu) dp/dx = 1.0833e-3 m/s.
    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(5e-4, 0.0, 0.0))
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("INLET", FaceCondition.PRESSURE_INLET, scalar_value=0.02)
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    return mesh, table


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(device: torch.device | str = "cuda") -> dict:
    """Run the benchmark on `device`; prints the JSON line and returns
    it as a dict."""
    from orc_tpu_torch.solver.simple import initial_state, solve_steady
    from orc_tpu_torch.utils.device import resolve_device
    from orc_tpu_torch.utils.settings import (
        MatrixSolverSettings,
        NumericalSettings,
        PreconditionMethod,
        SolutionMethod,
    )

    device = resolve_device(device)
    name = (
        torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    )
    print(f"device: {device} ({name})", file=sys.stderr)
    mesh, table = build_case(device)
    solver_name = os.environ.get("BENCH_SOLVER", "bicgstab")
    mg_smooth = os.environ.get("BENCH_MG_SMOOTH")  # smoother iters/level
    settings = NumericalSettings(
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod(solver_name),
            iterations=50,
            preconditioner=PreconditionMethod.JACOBI,
            multigrid_smoother_iterations=(
                int(mg_smooth) if mg_smooth else None
            ),
        ),
    )
    rho, mu = 1000.0, 0.001
    n_iters = int(os.environ.get("BENCH_ITERS", "100"))
    use_ck = "auto" if os.environ.get("BENCH_CK", "1") == "1" else False

    def run(state):
        state, _ = solve_steady(
            mesh, table, settings, rho, mu, state=state, iterations=n_iters,
            reporting_interval=n_iters, verbose=False, use_ck=use_ck,
        )
        _sync(device)
        return state

    t0 = time.perf_counter()
    state = run(initial_state(mesh))
    print(f"warmup: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    times = []
    for _i in range(5):
        t0 = time.perf_counter()
        state = run(state)
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]
    print(
        "run times: " + ", ".join(f"{t:.3f}s" for t in times),
        file=sys.stderr,
    )

    u = state.vel[:, 0].cpu().numpy()
    if not np.isfinite(u).all():
        raise AssertionError("benchmark produced non-finite fields")
    print(
        f"sanity: u_mean={u.mean():.3e} (analytical "
        f"{U_MEAN_ANALYTICAL:.3e}) u_min={u.min():.3e} u_max={u.max():.3e}",
        file=sys.stderr,
    )
    # After the warm-up and the timed runs (6 * BENCH_ITERS iterations)
    # the bulk velocity must be tracking the analytical value.
    if not abs(u.mean() - U_MEAN_ANALYTICAL) / U_MEAN_ANALYTICAL < 0.25:
        raise AssertionError(
            "benchmark physics drifted from the analytical solution"
        )
    iters_per_sec = n_iters / dt
    print(
        f"{n_iters} SIMPLE iterations in {dt:.2f}s -> "
        f"{iters_per_sec:.2f} iters/sec ({1e3*dt/n_iters:.2f} ms/iter)",
        file=sys.stderr,
    )
    # The extended lines first; the headline stays the last line.
    if os.environ.get("BENCH_EXTENDED", "1") == "1":
        try:
            for ext in extended_metrics(device):
                print(json.dumps(ext))
        except Exception as e:  # never let the extras break the headline
            print(f"extended metrics failed: {e!r}", file=sys.stderr)
    dtype_name = os.environ.get("BENCH_DTYPE", "f64")
    line = {
        "metric": "SIMPLE iters/sec, couette_128x64x1, "
        f"CD1+SecondOrder+RhieChow+{solver_name}(50), {dtype_name}",
        "value": round(iters_per_sec, 3),
        "unit": "iters/sec",
    }
    print(json.dumps(line))
    return line


# --- extended metrics -------------------------------------------------
# Minimum traffic of each bandwidth line (orc_tpu's formulas), f32.


def spmv_bytes(C, K):
    """Line 1: read diag, K columns and x, write y."""
    return C * 4 * (K + 3)


def assembly_bytes(C, K):
    """Line 2: read vel 3C + p C + mom_diag 3C; write the shared momentum
    off KC + diag C + b 3C, the p' off KC + diag C + b C and the flux C."""
    return C * 4 * (3 + 1 + 3 + K + 1 + 3 + K + 1 + 1 + 1)


def fused_bytes(C, K):
    """Line 3: momentum reads u, v, w, p and the flags and writes diag,
    off and b3; p' reads u, v, w, md and the flags and writes diag, off
    and b."""
    return C * 4 * ((4 + 1 + 1 + K + 3) + (4 + 1 + 1 + K + 1))


def fused_rc_bytes(C, K):
    """Line 4, orc_tpu's round-4 accounting of a 2-D box: a gradient pass
    (read p, write grad p 2C), momentum (read u, v, w, p 4C + grad p 2C +
    md + flags, write diag + off KC + b 3C), p' (read u, v, w, md, p,
    grad p 7C + flags, write diag + off KC + b)."""
    return C * 4 * ((1 + 2) + (4 + 2 + 1 + 1 + 1 + K + 3) + (7 + 1 + 1 + K + 1))


def fused_gg_bytes(C, K):
    """Line 5, the in-kernel gradient's own minimum: momentum reads u, v,
    w, p, md and the flags, writes diag + off + b3 (4C + KC); p' reads
    the same six, writes diag + off + b (2C + KC)."""
    return C * 4 * ((6 + 4 + K) + (6 + 2 + K))


def _bandwidth_line(metric, nbytes, seconds):
    gbps = nbytes / seconds / 1e9
    return {
        "metric": metric,
        "value": round(gbps, 1),
        "unit": "GB/s",
        "vs_baseline": round(gbps / H100_HBM_GBPS, 3),
    }


def spmv_case(n, device, rng):
    """Line 1's system on the n x n x 1 box in f32: (mesh, table, diag,
    off [C,K], x), drawn from `rng` in orc_tpu's order."""
    from orc_tpu_torch.mesh import structured_box_mesh

    mesh, table = structured_box_mesh(n, n, 1, dtype=torch.float32, device=device)
    C, K = mesh.cell_neighbors.shape
    interior = (
        mesh.face_interior[mesh.cell_faces.long()] & mesh.cell_face_mask
    ).cpu().numpy()

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    diag = f32(rng.standard_normal(C))
    off = f32(rng.standard_normal((C, K)) * interior)
    x = f32(rng.standard_normal(C))
    return mesh, table, diag, off, x


def fused_pair(vel, p, md, bcv, flags, cols, spec, grad_p=None):
    """momentum_assembly then pc_assembly, as one SIMPLE iteration issues
    them (lines 3-5): ((diag, off, b [3,C]), (diag, off, b)). Under
    Rhie-Chow the momentum kernel takes `md` and both take p and the
    streamed grad p (None under the in-kernel gradient); p' takes the
    fresh momentum diagonal."""
    from orc_tpu_torch.ops.fused_assembly import momentum_assembly, pc_assembly

    if spec.rc:
        mom = momentum_assembly(
            vel, p, bcv, flags, cols, 1.0, 1e-3, 0.7, grad_p=grad_p,
            mom_diag=md, spec=spec,
        )
        pc = pc_assembly(
            vel, mom[0], bcv, flags, cols, 1.0, p=p, grad_p=grad_p, spec=spec
        )
    else:
        mom = momentum_assembly(vel, p, bcv, flags, cols, 1.0, 1e-3, 0.7, spec=spec)
        pc = pc_assembly(vel, mom[0], bcv, flags, cols, 1.0, spec=spec)
    return mom, pc


def _cavity_chunk_ms(mesh, table, settings, n_it=25):
    """ms/iter of n_it-iteration chunks of solve_steady's (c,k) parity
    SIMPLE step, whatever coupling the settings resolve to, as orc_tpu's
    bench runs it (the fused assembly kernels where the gate allows
    them, the pressure system not pinned): the median of five chunks
    after one warm-up, each closed by a synchronise."""
    from orc_tpu_torch.solver.simple import _make_chunk_runner, initial_state

    run_chunk, prepare = _make_chunk_runner(
        mesh, table, settings, 1.0, 1e-3, use_ck_step=True, use_fc=False,
        maybe_singular=False,
    )

    def run(state):
        state, _ = run_chunk(state, n_it)
        _sync(mesh.device)
        return state

    state = run(prepare(initial_state(mesh)))
    times = []
    for _i in range(5):
        t0 = time.perf_counter()
        state = run(state)
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2] / n_it * 1e3


def extended_metrics(device: torch.device | str = "cuda") -> list:
    """orc_tpu's extended bench lines, in its order and under its names,
    on `device` at BENCH_EXT_N^2 cells (default 1024), f32, inputs from
    numpy.random.default_rng(0):

    1. the shift SpMV (ell_spmv with the box's offsets: kernel 1 on the
       card), GB/s;
    2. the plain (c,k) flux, face pressure, momentum and p' chain (UD,
       LinearWeighted), GB/s;
    3. the fused momentum + p' kernels (kernels 3 and 5) on the cavity,
       the solver's spec, GB/s;
    4. the same pair under CD1 + SecondOrder + Rhie-Chow, GB/s in
       orc_tpu's round-4 accounting, and 5. in the in-kernel gradient's
       own (only when the spec computes the gradient in the kernel);
    6. the cavity's ms/iter under UD + BiCGSTAB(50), and 7. under CD1 +
       SecondOrder + Rhie-Chow (vs_baseline: line 6 over line 7).

    Lines 1-5 time chained steps with `step_slope` (the card's time on
    the card); lines 3-5 exist where the gate gives a kernel spec, which
    it does on CUDA meshes only, as orc_tpu's does on its accelerator.
    Bandwidth lines' vs_baseline: the share of the H100's HBM3 rate."""
    import dataclasses as dc

    from orc_tpu_torch.mesh.zones import FaceCondition
    from orc_tpu_torch.models.cavity import cavity_case
    from orc_tpu_torch.ops.ck_ops import (
        build_ck_geometry,
        ck_bc,
        ck_diffusion,
        ck_face_pressure,
        ck_flux,
        ck_momentum,
        ck_pressure_correction,
        ck_pressure_gradient,
        nbr_values,
    )
    from orc_tpu_torch.ops.fields import device_bc
    from orc_tpu_torch.ops.fused_assembly import bc_value_table, pack_flags
    from orc_tpu_torch.ops.spmv import ell_spmv
    from orc_tpu_torch.solver.simple import _kernel_asm_spec
    from orc_tpu_torch.utils.device import resolve_device
    from orc_tpu_torch.utils.profiling import step_slope
    from orc_tpu_torch.utils.settings import (
        MatrixSolverSettings,
        MomentumScheme,
        NumericalSettings,
        PreconditionMethod,
        PressureInterpolation,
        RelaxationMode,
        SolutionMethod,
        VelocityInterpolation,
    )

    device = resolve_device(device)
    f32 = torch.float32
    lines = []
    n_ext = int(os.environ.get("BENCH_EXT_N", "1024"))
    rng = np.random.default_rng(0)

    # --- 1. the shift SpMV ---
    mesh, table, diag, off, x = spmv_case(n_ext, device, rng)
    C, K = mesh.cell_neighbors.shape
    offsets = mesh.neighbor_offsets
    t = step_slope(lambda v: ell_spmv(diag, off, None, v, offsets), x)
    lines.append(_bandwidth_line(
        f"shift SpMV bandwidth, {n_ext}^2 f32", spmv_bytes(C, K), t
    ))
    del diag, off, x

    # --- 2. the plain flux + momentum + p' assembly chain ---
    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(1.0, 0.0, 0.0))
    zc, zs, zv = device_bc(table, dtype=f32, device=device)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    ud = dc.replace(
        NumericalSettings(),
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
    )
    diff3 = ck_diffusion(mesh, ck, bc, torch.tensor(1e-3, dtype=f32, device=device))

    def assemble(state):
        vel, p, mom_diag = state
        vel_nbr = nbr_values(mesh, vel, ck.interior)
        mom_diag_nbr = nbr_values(mesh, mom_diag, ck.interior)
        flux = ck_flux(
            mesh, ck, bc, vel, ud.velocity_interpolation, p=p,
            mom_diag=mom_diag, mom_diag_nbr=mom_diag_nbr, vel_nbr=vel_nbr,
        )
        F = flux * ck.area
        p_f = ck_face_pressure(mesh, ck, bc, p, ud.pressure_interpolation)
        A3, b3, _pe = ck_momentum(mesh, ck, bc, ud, 1.0, vel, F, p_f, *diff3)
        Ap, bp = ck_pressure_correction(mesh, ck, bc, 1.0, F, mom_diag)
        # Outputs fed back, so each step carries the whole assembly.
        # One launch per tensor (torch.add's alpha, strided reads).
        b3c = b3 if b3.shape[0] == vel.shape[0] else b3.movedim(0, -1)
        d3 = A3.diag
        d3c = d3[:, None] if d3.ndim == 1 else d3.movedim(0, -1)
        return (
            torch.add(vel, b3c, alpha=1e-12),
            torch.add(p, bp, alpha=1e-12),
            torch.add(mom_diag, d3c, alpha=1e-12),
        )

    st0 = (
        torch.tensor(rng.standard_normal((C, 3)) * 1e-3, dtype=f32, device=device),
        torch.tensor(rng.standard_normal(C) * 1e-3, dtype=f32, device=device),
        torch.ones((C, 3), dtype=f32, device=device),
    )
    t_asm = step_slope(assemble, st0, n=128)
    lines.append(_bandwidth_line(
        f"flux+momentum+p-corr assembly bandwidth, {n_ext}^2 f32",
        assembly_bytes(C, K), t_asm,
    ))
    del mesh, ck, bc, diff3, st0

    # --- 3-5. the fused momentum + p' kernels ---
    mesh_f, table_f = cavity_case(n=n_ext, dtype=f32, device=device)
    s_f = dc.replace(
        ud,
        relaxation_mode=RelaxationMode.IMPLICIT,
        momentum_relaxation=0.7,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB, iterations=50,
            preconditioner=PreconditionMethod.JACOBI,
        ),
    )
    s_rc = dc.replace(
        s_f,
        momentum=MomentumScheme.CD1,
        pressure_interpolation=PressureInterpolation.SECOND_ORDER,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
    )
    ck_f = build_ck_geometry(mesh_f, len(table_f.zone_ids))
    Cf = mesh_f.n_cells
    for settings in (s_f, s_rc):
        spec = _kernel_asm_spec(mesh_f, table_f, settings, ck_f)
        if spec is None:
            continue
        cols, aspec = spec
        zc_f, zs_f, zv_f = device_bc(table_f, dtype=f32, device=device)
        flags = pack_flags(ck_f.interior, ck_f.mask)
        bcv = bc_value_table(zs_f, zv_f)
        bc_f = ck_bc(ck_f, zc_f, zs_f, zv_f)
        Kf = len(cols)

        def pair_step(st):
            vel, p, md = st
            grad_p = None
            if aspec.rc and not aspec.gg:
                grad_p = ck_pressure_gradient(mesh_f, ck_f, bc_f, p)
            (_mdiag, _moff, b3), (pdiag, _poff, bp) = fused_pair(
                vel, p, md, bcv, flags, cols, aspec, grad_p
            )
            # Fed back in one launch per tensor: three launches beside
            # the kernels' (and the gradient pass when it is streamed).
            return (
                torch.add(vel, b3.T, alpha=1e-12),
                torch.add(p, bp, alpha=1e-12),
                torch.add(md, pdiag, alpha=1e-12),
            )

        st0 = (
            torch.tensor(rng.standard_normal((Cf, 3)) * 1e-3, dtype=f32, device=device),
            torch.tensor(rng.standard_normal(Cf) * 1e-3, dtype=f32, device=device),
            torch.ones((Cf,), dtype=f32, device=device),
        )
        # 64 steps: a window of about 600 launches stays within the
        # card's launch queue, so the card runs it back to back.
        t_pair = step_slope(pair_step, st0, n=64)
        if not aspec.rc:
            lines.append(_bandwidth_line(
                f"FUSED momentum+p-corr assembly bandwidth, {n_ext}^2 f32 "
                "(shipped default)", fused_bytes(Cf, Kf), t_pair,
            ))
            continue
        lines.append(_bandwidth_line(
            f"FUSED assembly bandwidth, CD1+SecondOrder+RhieChow "
            f"(reference-default schemes), {n_ext}^2 f32",
            fused_rc_bytes(Cf, Kf), t_pair,
        ))
        if aspec.gg:
            lines.append(_bandwidth_line(
                f"FUSED assembly CD1+SecondOrder+RhieChow, "
                f"in-kernel-GG traffic accounting, {n_ext}^2 f32",
                fused_gg_bytes(Cf, Kf), t_pair,
            ))
    del ck_f

    # --- 6-7. the cavity's ms/iter (the same cavity) ---
    settings = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        pressure_relaxation=0.1,
        momentum_relaxation=0.7,
        relaxation_mode=RelaxationMode.IMPLICIT,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=50,
            preconditioner=PreconditionMethod.JACOBI,
        ),
    )
    ms_iter = _cavity_chunk_ms(mesh_f, table_f, settings)
    lines.append({
        "metric": f"cavity {n_ext}^2 f32 UD BiCGSTAB(50), one chip",
        "value": round(ms_iter, 2),
        "unit": "ms/iter",
    })
    s_ref = dc.replace(
        settings,
        momentum=MomentumScheme.CD1,
        pressure_interpolation=PressureInterpolation.SECOND_ORDER,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
    )
    ms_ref = _cavity_chunk_ms(mesh_f, table_f, s_ref)
    lines.append({
        "metric": (
            f"cavity {n_ext}^2 f32 CD1+SecondOrder+RhieChow "
            f"(reference-default schemes), one chip"
        ),
        "value": round(ms_ref, 2),
        "unit": "ms/iter",
        # The cost of the reference's own numerics against the UD pair.
        "vs_baseline": round(ms_iter / ms_ref, 3),
    })
    return lines


if __name__ == "__main__":
    main()
