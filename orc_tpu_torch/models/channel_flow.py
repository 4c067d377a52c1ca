"""Planar channel (Couette/Poiseuille) validation case (port of
orc_tpu/models/channel_flow.py).

Steady flow between parallel plates driven by a moving top wall and/or
a streamwise pressure gradient has the closed-form profile

    u(y) = U y/h + (1/(2 mu)) (dp/dx) (y^2 - h y).

`solve_channel_flow` is not ported yet: it starts from the BC-aware
field initialization of solver/init_fields.py (ROADMAP Queue 1, item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from orc_tpu_torch.mesh.generate import structured_box_mesh
from orc_tpu_torch.mesh.zones import FaceCondition

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
