"""Planar channel (Couette/Poiseuille) validation case (port of
orc_tpu/models/channel_flow.py).

Steady flow between parallel plates driven by a moving top wall and/or
a streamwise pressure gradient has the closed-form profile

    u(y) = U y/h + (1/(2 mu)) (dp/dx) (y^2 - h y).

`solve_channel_flow` runs the case from the BC-aware initialisation of
solver/init_fields.py and checks u_mean / u_min / u_max against the
analytical values within a relative tolerance; the comparison and the
core-region statistics are host numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from orc_tpu_torch.mesh.generate import structured_box_mesh
from orc_tpu_torch.mesh.zones import FaceCondition
from orc_tpu_torch.solver.simple import FlowState, solve_steady
from orc_tpu_torch.utils.settings import NumericalSettings

CHANNEL_HEIGHT = 0.001  # m
CHANNEL_LENGTH = 0.002  # m
CHANNEL_DEPTH = 0.0001  # m


@dataclasses.dataclass
class ChannelFlowParameters:
    top_wall_velocity: float = 0.0
    dp_dx: float = 0.0
    mu: float = 0.001
    rho: float = 1000.0


def analytical_profile(params: ChannelFlowParameters, h=CHANNEL_HEIGHT, n=128):
    """(y, u(y)) samples of the analytical solution."""
    y = np.arange(n) / n * h
    u = params.top_wall_velocity * y / h + (
        1.0 / (2.0 * params.mu) * params.dp_dx * (y**2 - h * y)
    )
    return y, u


def analytical_stats(
    params: ChannelFlowParameters, h=CHANNEL_HEIGHT
) -> Tuple[float, float, float]:
    """(u_avg, u_min, u_max) closed forms (dp/dx = 0 guarded)."""
    U, mu, dpdx = params.top_wall_velocity, params.mu, params.dp_dx
    if dpdx != 0.0:
        u_ext = -((2.0 * mu * U - h**2 * dpdx) ** 2) / (8.0 * h**2 * dpdx * mu)
        # Only count the parabola's extremum if it sits inside the channel.
        y_ext = h / 2.0 - mu * U / (h * dpdx)
        if not (0.0 < y_ext < h):
            u_ext = 0.0
    else:
        u_ext = 0.0
    u_avg = U / 2.0 - h**2 / (12.0 * mu) * dpdx
    u_max = max(U, 0.0, u_ext)
    u_min = min(U, 0.0, u_ext)
    return u_avg, u_min, u_max


def couette_case(
    nx: int = 8,
    ny: int = 8,
    nz: int = 1,
    params: Optional[ChannelFlowParameters] = None,
    velocity_inlet: Optional[float] = None,
    mesh_path: Optional[str] = None,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
):
    """Channel-flow mesh + BCs on `device` (the CUDA device unless the
    caller names another): a structured box, or the TGRID mesh at
    `mesh_path`. Pressure inlet/outlet BCs encode dp/dx over the channel
    length, or the inlet is a velocity inlet when `velocity_inlet` is
    set."""
    params = params or ChannelFlowParameters()
    if mesh_path is not None:
        from orc_tpu_torch.mesh.tgrid import read_mesh

        mesh, table = read_mesh(mesh_path, dtype=dtype, device=device)
    else:
        mesh, table = structured_box_mesh(
            nx, ny, nz, lengths=(CHANNEL_LENGTH, CHANNEL_HEIGHT, CHANNEL_DEPTH),
            dtype=dtype, device=device,
        )
    wall_names = [fz.name for fz in table.zones.values() if "WALL" in fz.name]
    if "TOP_WALL" in wall_names:
        table.set(
            "TOP_WALL",
            FaceCondition.WALL,
            vector_value=(params.top_wall_velocity, 0.0, 0.0),
        )
        table.set("BOTTOM_WALL", FaceCondition.WALL)
    else:  # the 8x8 reference fixture merges both walls into "WALL"
        table.set("WALL", FaceCondition.WALL)
    if velocity_inlet is not None:
        table.set(
            "INLET",
            FaceCondition.VELOCITY_INLET,
            vector_value=(velocity_inlet, 0.0, 0.0),
        )
    else:
        table.set(
            "INLET",
            FaceCondition.PRESSURE_INLET,
            scalar_value=-params.dp_dx * CHANNEL_LENGTH,
        )
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    return mesh, table


def solve_channel_flow(
    params: ChannelFlowParameters,
    settings: Optional[NumericalSettings] = None,
    nx: int = 8,
    ny: int = 8,
    iterations: int = 100,
    reporting_interval: int = 10,
    validation_threshold: float = 0.1,
    state: Optional[FlowState] = None,
    mesh_path: Optional[str] = None,
    verbose: bool = True,
    device: torch.device | str = "cuda",
):
    """Run the channel-flow case on `device` (float64) and validate it
    against the analytical profile (the reference harness, tests.rs:
    44-152). Returns a result dict with the mesh, fields, statistics and
    pass/fail flags."""
    settings = settings or NumericalSettings()
    mesh, table = couette_case(
        nx=nx, ny=ny, params=params, mesh_path=mesh_path, device=device
    )
    if state is None:
        from orc_tpu_torch.solver.init_fields import initialize_flow

        state = initialize_flow(mesh, table, params.mu, params.rho)
    state, history = solve_steady(
        mesh,
        table,
        settings,
        params.rho,
        params.mu,
        state=state,
        iterations=iterations,
        reporting_interval=reporting_interval,
        verbose=verbose,
    )
    u = state.vel[:, 0].cpu().numpy()
    u_mean, u_min, u_max = float(u.mean()), float(u.min()), float(u.max())
    # The analytical profile at the cell-centroid heights, so that the
    # min/max comparison is between like quantities (a cell-centred
    # solution never reaches the wall value).
    cc = mesh.cell_centroid.cpu().numpy()
    y_c = cc[:, 1]
    h = CHANNEL_HEIGHT
    u_ana = params.top_wall_velocity * y_c / h + (
        1.0 / (2.0 * params.mu) * params.dp_dx * (y_c**2 - h * y_c)
    )
    a_mean, a_min, a_max = (
        float(u_ana.mean()),
        float(u_ana.min()),
        float(u_ana.max()),
    )

    u_scale = max(abs(a_mean), abs(a_min), abs(a_max))

    def close(a, b):
        # Symmetric relative error; zero analytical values are compared
        # against the overall velocity scale, with a tiny absolute floor
        # so that a quiescent case validates instead of dividing 0 by 0.
        denom = max(abs(a), abs(b), 0.05 * u_scale, 1e-30)
        return abs(a - b) / denom < validation_threshold

    # Core-region statistics: the inlet and outlet quarter-lengths, where
    # Rhie-Chow's pressure-boundary artifacts live, are left out.
    x_c = cc[:, 0]
    lo, hi = np.quantile(x_c, [0.25, 0.75])
    core = (x_c >= lo) & (x_c <= hi)
    core_u = u[core]
    core_ana = u_ana[core]

    result = dict(
        mesh=mesh,
        table=table,
        state=state,
        history=history,
        core_u_mean=float(core_u.mean()),
        core_u_min=float(core_u.min()),
        core_u_max=float(core_u.max()),
        core_u_mean_analytical=float(core_ana.mean()),
        core_u_min_analytical=float(core_ana.min()),
        core_u_max_analytical=float(core_ana.max()),
        u_mean=u_mean,
        u_min=u_min,
        u_max=u_max,
        u_mean_analytical=a_mean,
        u_min_analytical=a_min,
        u_max_analytical=a_max,
        mean_ok=close(u_mean, a_mean),
        min_ok=close(u_min, a_min),
        max_ok=close(u_max, a_max),
    )
    result["passed"] = result["mean_ok"] and result["min_ok"] and result["max_ok"]
    if verbose:
        for name, cfd, ana in (
            ("U_mean", u_mean, a_mean),
            ("U_min", u_min, a_min),
            ("U_max", u_max, a_max),
        ):
            err = (cfd / ana - 1.0) * 100.0 if ana != 0 else float("nan")
            print(
                f" {name}:\tCFD = {cfd:>9.2e}; Analytical = {ana:>9.2e}; "
                f"Error = {err:>6.1f}%"
            )
        print("validation passed" if result["passed"] else "**FAIL**")
    return result
