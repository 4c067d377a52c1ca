"""Transient (unsteady) solver: implicit-Euler SIMPLE time marching
(port of the single-device half of orc_tpu/solver/transient.py).

Each physical time step adds the first-order implicit unsteady term
rho V/dt (phi - phi^n) to the momentum systems and runs
`inner_iterations` SIMPLE (or SIMPLE_FC) iterations to converge the
coupled step. orc_tpu compiles the two scans into one program; here
they are two host loops on the mesh's device. The (c,k) step or the
face-major one runs each inner iteration, as in orc_tpu: use_ck="auto"
picks the (c,k) step by the cell count alone (CK_AUTO_MAX_CELLS), so a
node-based Green-Gauss run under "auto" takes the (c,k) step, which
computes Green-Gauss cell gradients (orc_tpu's behaviour, kept). On a
uniform box on the card the (c,k) step's momentum assembly is the
parity or SIMPLE_FC kernel with its inertia branch, once per inner
iteration.

The steps run as orc_tpu's scan runs them: the state each one returns
is the next one's input, with no Kahan-compensated accumulation (which
`solve_steady` applies to float32 runs). The metrics stay on the device
and are stacked once, and divergence is checked once, after the last
step.

Not ported: `solve_transient_sharded` (ROADMAP Queue 1, item 14).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from orc_tpu_torch.mesh.compile import CompiledMesh, trim_for_ck
from orc_tpu_torch.mesh.zones import BoundaryTable
from orc_tpu_torch.ops.ck_ops import build_ck_geometry, ck_bc, ck_diffusion, ck_flux
from orc_tpu_torch.ops.assembly import diffusion_system
from orc_tpu_torch.ops.fields import device_bc, face_bc
from orc_tpu_torch.solver import fc as fc_step
from orc_tpu_torch.solver.simple import (
    CK_AUTO_MAX_CELLS,
    FlowState,
    SolverDivergedError,
    StepMetrics,
    _kernel_asm_spec,
    _metric_names,
    _solver_extras,
    ck_simple_step,
    initial_flux,
    initial_state,
    simple_step,
    table_has_pressure_bc,
    table_maybe_singular,
)
from orc_tpu_torch.utils.settings import (
    NumericalSettings,
    PressureVelocityCoupling,
    SolutionMethod,
    VelocityInterpolation,
)


def solve_transient(
    mesh: CompiledMesh,
    table: BoundaryTable,
    settings: NumericalSettings,
    rho: float,
    mu: float,
    dt: float,
    n_steps: int,
    inner_iterations: int = 20,
    state: Optional[FlowState] = None,
    report_interval: int = 0,
    verbose: bool = True,
    check_divergence: bool = True,
    use_ck: str | bool = "auto",
):
    """March `n_steps` implicit time steps of size `dt` on the mesh's
    device.

    Returns (FlowState at t = n_steps * dt, StepMetrics of
    [n_steps]-leading tensors, each from its step's last inner
    iteration). SIMPLE or SIMPLE_FC as settings.resolved_coupling()
    says; `use_ck` as in solve_steady (only the (c,k) step is ported).
    `report_interval` keeps orc_tpu's signature: the single-device march
    ignores it, as orc_tpu's does (its sharded driver, not ported, reads
    it)."""
    table.validate_supported()
    use_fc = settings.resolved_coupling() == PressureVelocityCoupling.SIMPLE_FC
    maybe_singular = (
        not table_has_pressure_bc(table) if use_fc else table_maybe_singular(table)
    )
    zc, zs, zv = device_bc(table, dtype=mesh.dtype, device=mesh.device)
    if state is None:
        state = initial_state(mesh)
    mu_t = torch.tensor(mu, dtype=mesh.dtype, device=mesh.device)
    rv_dt = rho * mesh.cell_volume / dt  # [C]
    take_ck = use_ck is True or (use_ck == "auto" and mesh.n_cells <= CK_AUTO_MAX_CELLS)
    diff = None
    if not take_ck or settings.matrix_solver.solver_type == SolutionMethod.MULTIGRID:
        # The face-major step's diffusion system, or the coupling values
        # the algebraic multigrid hierarchy aggregates on.
        diff = diffusion_system(mesh, face_bc(mesh, zc, zs, zv), mu_t)
    extras = _solver_extras(mesh, diff, settings)
    if take_ck:
        diff = None  # the (c,k) step does not read it
        ck = build_ck_geometry(mesh, len(table.zone_ids))
        bc0 = ck_bc(ck, zc, zs, zv)
        ck_diff = ck_diffusion(mesh, ck, bc0, mu_t)
        kernel_asm = _kernel_asm_spec(mesh, table, settings, ck, fc=use_fc)
        if use_fc and state.flux is None:
            # SIMPLE_FC: the stored conservative flux must exist before
            # the first step (solver/fc.py).
            state = dataclasses.replace(
                state, flux=fc_step.ck_initial_flux(mesh, ck, bc0, settings, state)
            )
        if mesh.neighbor_offsets is not None:
            mesh = trim_for_ck(mesh)
        step_fn = fc_step.ck_simple_step_fc if use_fc else ck_simple_step

        def step(s, inertia):
            return step_fn(
                mesh, ck, zc, zs, zv, settings, rho, mu, ck_diff, s,
                kernel_asm=kernel_asm, maybe_singular=maybe_singular,
                inertia=inertia, solver_extras=extras,
            )
    else:
        if use_fc and state.flux is None:
            state = dataclasses.replace(
                state, flux=initial_flux(mesh, zc, zs, zv, settings, state)
            )
        fm_step = fc_step.simple_step_fc if use_fc else simple_step

        def step(s, inertia):
            return fm_step(
                mesh, zc, zs, zv, settings, rho, mu, diff, s, extras,
                inertia=inertia, maybe_singular=maybe_singular,
            )

    t0 = time.perf_counter()
    last = []
    for _ in range(n_steps):
        inertia = (rv_dt, state.vel)  # vel^n: the state at the step's start
        for _ in range(inner_iterations):
            state, metrics = step(state, inertia)
        last.append(metrics)
    metrics = StepMetrics(
        **{f: torch.stack([getattr(m, f) for m in last]) for f in _metric_names()}
    )
    if verbose:
        va = metrics.vel_avg[-1].cpu().tolist()
        print(
            f"transient: {n_steps} steps x {inner_iterations} inner "
            f"iterations in {time.perf_counter() - t0:.2f}s; final avg "
            f"velocity = ({va[0]:.2e}, {va[1]:.2e}, {va[2]:.2e})"
        )
    if check_divergence and bool(torch.any(metrics.diverged)):
        raise SolverDivergedError(n_steps)
    return state, metrics


def courant_numbers(mesh: CompiledMesh, table: BoundaryTable, vel, dt):
    """(avg, min, max) cell Courant numbers Co = dt * sum_f |u_f.n| A /
    (2 V), the standard finite-volume CFL estimate, over the active
    cells; use it to pick `dt` for `solve_transient`.

    orc_tpu sums the face-major Linear face flux over each cell's faces;
    here the same quantity comes from the (c,k) Linear flux over the
    masked (cell, slot) pairs, whose magnitude is the face's."""
    zc, zs, zv = device_bc(table, dtype=mesh.dtype, device=mesh.device)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    flux = ck_flux(mesh, ck, bc, vel, VelocityInterpolation.LINEAR)
    zero = torch.zeros((), dtype=flux.dtype, device=flux.device)
    outflow = torch.where(ck.mask, torch.abs(flux) * ck.area, zero)
    co = dt * torch.sum(outflow, dim=1) / (2.0 * mesh.cell_volume)
    active = ck.mask.any(dim=1)
    inf = torch.full((), float("inf"), dtype=co.dtype, device=co.device)
    return (
        torch.sum(torch.where(active, co, zero)) / torch.sum(active),
        torch.amin(torch.where(active, co, inf)),
        torch.amax(torch.where(active, co, -inf)),
    )
