"""The Taylor-Green vortex of tests/test_transient.py at another grid and
time step, in orc_tpu (JAX on CPU, x64) or in the port (CPU, float64):
prints the pointwise error and the kinetic-energy ratio against the
exact e^(-2 nu t) decay after 20 steps.

    python tests/torch_taylor_green_scan.py N DT INNER {jax,torch}

e.g. `256 0.05 10 jax` and `256 0.05 10 torch` (both 7.7e-3 above the
exact kinetic energy: ten inner iterations do not converge a step at
Courant ~2) against `256 0.00625 10 torch` (dt at the 32^2 test's
Courant number, chip_smoke.py phase 16).
"""

import dataclasses
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

RHO, MU, N_STEPS = 1.0, 0.02, 20


def run(n, dt, inner, pkg):
    from test_torch_transient import TG_SETTINGS

    if pkg == "jax":
        import jax.numpy as jnp
        from orc_tpu.mesh.generate import structured_box_mesh
        from orc_tpu.solver import simple, transient
        from torch_parity import to_jax_settings

        mesh, table = structured_box_mesh(
            n, n, 1, lengths=(2 * np.pi, 2 * np.pi, 1.0), periodic=("x", "y"),
            dtype=jnp.float64,
        )
    else:
        from orc_tpu_torch.mesh.generate import structured_box_mesh
        from orc_tpu_torch.solver import simple, transient

        mesh, table = structured_box_mesh(
            n, n, 1, lengths=(2 * np.pi, 2 * np.pi, 1.0), periodic=("x", "y"),
            device="cpu",
        )
    cc = np.asarray(mesh.cell_centroid)
    x, y = cc[:, 0], cc[:, 1]
    u0, v0 = np.sin(x) * np.cos(y), -np.cos(x) * np.sin(y)
    p0 = RHO / 4.0 * (np.cos(2 * x) + np.cos(2 * y))
    vel0 = np.stack([u0, v0, 0 * u0], -1)
    if pkg == "jax":
        state = dataclasses.replace(
            simple.initial_state(mesh), vel=jnp.asarray(vel0), p=jnp.asarray(p0)
        )
        settings = to_jax_settings(TG_SETTINGS)
    else:
        state = simple.initial_state(mesh, vel=vel0, p=p0)
        settings = TG_SETTINGS
    state, metrics = transient.solve_transient(
        mesh, table, settings, RHO, MU, dt, N_STEPS, inner_iterations=inner,
        state=state, verbose=False,
    )
    u, v = np.asarray(state.vel[:, 0]), np.asarray(state.vel[:, 1])
    decay = np.exp(-2 * MU / RHO * dt * N_STEPS)
    err = max(np.abs(u - u0 * decay).max(), np.abs(v - v0 * decay).max())
    ratio = np.sum(u * u + v * v) / (decay**2 * np.sum(u0**2 + v0**2))
    return err, ratio, float(np.asarray(metrics.pc_iters, dtype=float).mean())


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    n, dt, inner, pkg = int(sys.argv[1]), float(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    t0 = time.perf_counter()
    err, ratio, pc = run(n, dt, inner, pkg)
    print(
        f"{pkg} {n}^2 dt {dt} x {inner} inner: max pointwise error {err:.3e}, "
        f"kinetic-energy ratio {ratio:.6f}, mean pressure iterations {pc:.1f}, "
        f"{time.perf_counter() - t0:.1f} s"
    )
