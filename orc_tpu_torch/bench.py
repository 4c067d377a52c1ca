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
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

U_MEAN_ANALYTICAL = 5e-4 / 2 + 1e-3**2 / (12 * 0.001) * 10.0  # 1.0833e-3


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
    dtype_name = os.environ.get("BENCH_DTYPE", "f64")
    line = {
        "metric": "SIMPLE iters/sec, couette_128x64x1, "
        f"CD1+SecondOrder+RhieChow+{solver_name}(50), {dtype_name}",
        "value": round(iters_per_sec, 3),
        "unit": "iters/sec",
    }
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
