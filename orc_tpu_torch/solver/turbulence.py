"""Standard k-epsilon RANS with equilibrium wall functions, single device
(port of orc_tpu/solver/turbulence.py).

Each outer iteration (`rans_outer_step`) runs one SIMPLE or SIMPLE_FC
(c,k) step with the effective viscosity mu + mu_t on interior faces and
the log-law wall viscosity on wall faces, then one k/epsilon update
(`turbulence_step`):
- k and epsilon transport with UD advection of the Linear-weighted face
  flux, face diffusivity mu + (mu_t,f - mu)/sigma and implicit
  destruction (`ck_scalar_system`); inlets are Dirichlet at the inlet
  level, walls, symmetry and outlets carry no flux;
- wall-adjacent cells take the equilibrium production
  tau_w u* / (kappa y_p) and the fixed epsilon C_mu^{3/4} k^{3/2} /
  (kappa y_p) (the epsilon row is replaced by an identity row);
- mu_t = rho C_mu k^2 / eps, clipped to [0, 1e5 mu].

The viscosity varies per (c,k) slot, so the momentum assembly is the
plain (c,k) ops (`kernel_asm=None`, as in orc_tpu): no assembly kernel
sees mu + mu_t. The momentum, pressure and k/eps solves run the solver
kernels on the card (the shift SpMV and the Jacobi sweeps on structured
boxes; the slice SpMV and the neighbour gather on irregular meshes).
The run builds orc_tpu's `solver_extras` once: the colouring of
GAUSS_SEIDEL, the multigrid hierarchy of MULTIGRID (geometric on a box
that coarsens, else algebraic, aggregated on the laminar diffusion
system: the Galerkin values come from each solve's own matrix).

`solve_steady_turbulent` drives the step in a Python loop in chunks of
`reporting_interval` iterations and reads the metrics back once per
chunk. Not ported: `solve_steady_turbulent_sharded` (ROADMAP Queue 1,
item 14).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from orc_tpu_torch.ops.ck_ops import (
    build_ck_geometry,
    ck_bc,
    ck_diffusion,
    ck_flux,
    ck_velocity_gradient,
    mesh_matrix,
    nbr_values,
)
from orc_tpu_torch.ops.assembly import diffusion_system
from orc_tpu_torch.ops.fields import (
    PRESSURE_INLET,
    VELOCITY_INLET,
    WALL,
    device_bc,
    face_bc,
)
from orc_tpu_torch.solver.krylov import iterative_solve
from orc_tpu_torch.solver.simple import (
    FlowState,
    StepMetrics,
    _metric_names,
    _solver_extras,
    ck_simple_step,
    initial_state,
)
from orc_tpu_torch.utils.settings import (
    NumericalSettings,
    PressureVelocityCoupling,
    SolutionMethod,
    VelocityInterpolation,
)

C_MU = 0.09
C_1 = 1.44
C_2 = 1.92
SIGMA_K = 1.0
SIGMA_E = 1.3
KAPPA = 0.41
E_WALL = 9.793
YPLUS_LAM = 11.25  # viscous/log-layer crossover
#: Floor of k and epsilon (representable in float32).
FLOOR = 1e-30


@dataclasses.dataclass(frozen=True)
class TurbState:
    k: torch.Tensor  # [C] turbulent kinetic energy
    eps: torch.Tensor  # [C] dissipation rate
    mu_t: torch.Tensor  # [C] eddy viscosity


def initial_turbulence(
    mesh, u_ref: float, intensity: float, length_scale: float, rho: float,
) -> TurbState:
    """Uniform k and epsilon from a turbulence intensity and a length
    scale, and their mu_t."""
    k0 = 1.5 * (intensity * max(abs(u_ref), 1e-12)) ** 2
    e0 = C_MU ** 0.75 * k0 ** 1.5 / max(length_scale, 1e-12)
    C, dt, dev = mesh.n_cells, mesh.dtype, mesh.device
    k = torch.full((C,), k0, dtype=dt, device=dev)
    eps = torch.full((C,), e0, dtype=dt, device=dev)
    return TurbState(k=k, eps=eps, mu_t=rho * C_MU * k * k / eps)


def _strain_sq(grad_vel):
    """S^2 = 2 S_ij S_ij from the velocity-gradient tensor [C,3,3]."""
    s = 0.5 * (grad_vel + grad_vel.transpose(-1, -2))
    return 2.0 * torch.sum(s * s, dim=(-1, -2))


def _wall_adjacent(ck, bc):
    """(has_wall [C], y_p [C]): the distance to the nearest wall face of
    wall-adjacent cells (1 where there is none)."""
    is_wall = (bc.code == WALL) & ck.mask & ~ck.interior
    has_wall = is_wall.any(dim=1)
    dist_fo = ck.dist_fo
    inf = torch.full((), float("inf"), dtype=dist_fo.dtype, device=dist_fo.device)
    y = torch.amin(torch.where(is_wall, dist_fo, inf), dim=1)
    return has_wall, torch.where(has_wall, y, torch.ones_like(y))


def wall_viscosity(k, y_p, has_wall, rho, mu):
    """Log-law effective wall viscosity [C] of the momentum wall flux
    (mu where the cell has no wall or lies in the viscous layer)."""
    u_star = C_MU ** 0.25 * torch.sqrt(torch.clamp(k, min=FLOOR))
    y_plus = rho * u_star * y_p / mu
    mu_log = rho * u_star * KAPPA * y_p / torch.log(
        E_WALL * torch.clamp(y_plus, min=1.06)
    )
    mu_c = torch.full_like(mu_log, mu)
    mu_w = torch.where(y_plus > YPLUS_LAM, mu_log, mu_c)
    return torch.where(has_wall, torch.clamp(mu_w, min=mu), mu_c)


def ck_scalar_system(mesh, ck, bc, F, gamma_ck, diag_src, b_src, inlet_value):
    """UD advection-diffusion system (EllMatrix, b [C]) of a turbulence
    scalar with face diffusivity gamma_ck [C,K]: walls, symmetry and
    outlets carry no flux, velocity and pressure inlets are Dirichlet at
    `inlet_value`."""
    zero = torch.zeros((), dtype=F.dtype, device=F.device)
    one = torch.ones((), dtype=F.dtype, device=F.device)
    mask, interior = ck.mask, ck.interior
    a_nb = torch.where(mask, torch.clamp(F, max=0.0), zero)
    a_p_adv = torch.sum(torch.where(mask, -a_nb + F, zero), dim=1)
    is_inlet = (
        ((bc.code == VELOCITY_INLET) | (bc.code == PRESSURE_INLET))
        & mask
        & ~interior
    )
    area = ck.area
    d_int = torch.where(interior, gamma_ck * area / ck.dist_on, zero)
    d_in = torch.where(is_inlet, gamma_ck * area / ck.dist_fo, zero)
    diag = a_p_adv + torch.sum(d_int + d_in, dim=1) + diag_src
    off = torch.where(interior, a_nb - d_int, zero)
    b = b_src + torch.sum(d_in, dim=1) * inlet_value
    # UD inlet advection: a_nb = min(F, 0) at an inflow face moves
    # -a_nb phi_in to the RHS.
    b = b - torch.sum(torch.where(is_inlet, a_nb, zero), dim=1) * inlet_value
    active = mask.any(dim=1)
    diag = torch.where(active, diag, one)
    b = torch.where(active, b, zero)
    return mesh_matrix(mesh, diag, off), b


def turbulence_step(
    mesh, ck, bc, settings: NumericalSettings, rho, mu, flow: FlowState,
    turb: TurbState, k_in, eps_in, relax=0.7, solver_extras=None,
):
    """One k/epsilon update of the flow field `flow`: returns (TurbState,
    the wall viscosity [C])."""
    vel = flow.vel
    zero = torch.zeros((), dtype=vel.dtype, device=vel.device)
    one = torch.ones((), dtype=vel.dtype, device=vel.device)
    vel_nbr = nbr_values(mesh, vel, ck.interior)
    grad_v = ck_velocity_gradient(mesh, ck, bc, vel, vel_nbr=vel_nbr)
    flux = ck_flux(
        mesh, ck, bc, vel, VelocityInterpolation.LINEAR_WEIGHTED,
        vel_nbr=vel_nbr,
    )
    F = flux * ck.area * rho
    vol = mesh.cell_volume
    has_wall, y_p = _wall_adjacent(ck, bc)

    k = torch.clamp(turb.k, min=FLOOR)
    eps = torch.clamp(turb.eps, min=FLOOR)
    mu_t = turb.mu_t
    mu_t_f = mu + 0.5 * (mu_t[:, None] + nbr_values(mesh, mu_t, ck.interior))

    # Production: mu_t S^2 inside; wall-adjacent cells the equilibrium
    # wall-function form tau_w u* / (kappa y_p), with the cell's speed
    # as the tangential velocity (a wall velocity ~ 0 assumed).
    p_k = mu_t * _strain_sq(grad_v)
    mu_w = wall_viscosity(k, y_p, has_wall, rho, mu)
    u_mag = torch.sqrt(torch.sum(vel**2, dim=-1))
    tau_w = mu_w * u_mag / y_p
    u_star = C_MU ** 0.25 * torch.sqrt(k)
    p_k = torch.where(has_wall, tau_w * u_star / (KAPPA * y_p), p_k)

    active = ck.mask.any(dim=1)
    solver = settings.momentum_matrix_solver()
    extras = solver_extras or {}
    # --- k: implicit destruction rho eps / k. Inactive rows are identity
    # rows with b = 0, so the warm start is zero there.
    A_k, b_k = ck_scalar_system(
        mesh, ck, bc, F, mu + (mu_t_f - mu) / SIGMA_K, rho * eps / k * vol,
        p_k * vol, k_in,
    )
    k_sol, _ = iterative_solve(
        A_k, b_k, torch.where(active, k, zero), solver, **extras
    )
    k_new = torch.clamp(k + relax * (k_sol - k), min=FLOOR)

    # --- epsilon, fixed at its equilibrium value in wall-adjacent cells.
    A_e, b_e = ck_scalar_system(
        mesh, ck, bc, F, mu + (mu_t_f - mu) / SIGMA_E,
        C_2 * rho * eps / k * vol, C_1 * (eps / k) * p_k * vol, eps_in,
    )
    eps_wall = C_MU ** 0.75 * k_new ** 1.5 / (KAPPA * y_p)
    A_e = A_e.with_values(
        torch.where(has_wall, one, A_e.diag),
        torch.where(has_wall[:, None], zero, A_e.off),
    )
    b_e = torch.where(has_wall, eps_wall, b_e)
    e_sol, _ = iterative_solve(
        A_e, b_e, torch.where(active, eps, zero), solver, **extras
    )
    eps_new = torch.clamp(eps + relax * (e_sol - eps), min=FLOOR)

    mu_t_new = torch.clamp(rho * C_MU * k_new * k_new / eps_new, 0.0, 1e5 * mu)
    return TurbState(k=k_new, eps=eps_new, mu_t=mu_t_new), mu_w


def rans_outer_step(
    mesh, ckg, bc0, zc, zs, zv, settings, rho, mu, k_in, eps_in, has_wall,
    y_p, is_wall_face, carry, solver_extras=None,
):
    """One RANS outer iteration on carry = (FlowState, TurbState): a
    SIMPLE (or SIMPLE_FC) step with mu_eff = mu + mu_t (the log-law wall
    viscosity on wall faces), then one k/eps update. Returns (carry,
    StepMetrics)."""
    flow, tb = carry
    mu_t_f = 0.5 * (tb.mu_t[:, None] + nbr_values(mesh, tb.mu_t, ckg.interior))
    mu_w = wall_viscosity(tb.k, y_p, has_wall, rho, mu)
    gamma = torch.where(
        ckg.interior,
        mu + mu_t_f,
        torch.where(is_wall_face, mu_w[:, None], mu + tb.mu_t[:, None]),
    )
    ck_diff = ck_diffusion(mesh, ckg, bc0, gamma)
    # RANS runs have wall zones, so the parity p' system is anchored; the
    # FC full-p system anchors only through pressure zones (a body-force
    # channel has none), so it is always solved deflated.
    if settings.resolved_coupling() == PressureVelocityCoupling.SIMPLE_FC:
        from orc_tpu_torch.solver.fc import ck_simple_step_fc

        flow2, metrics = ck_simple_step_fc(
            mesh, ckg, zc, zs, zv, settings, rho, mu, ck_diff, flow,
            kernel_asm=None, maybe_singular=True, solver_extras=solver_extras,
        )
    else:
        flow2, metrics = ck_simple_step(
            mesh, ckg, zc, zs, zv, settings, rho, mu, ck_diff, flow,
            kernel_asm=None, maybe_singular=False, solver_extras=solver_extras,
        )
    tb2, _ = turbulence_step(
        mesh, ckg, bc0, settings, rho, mu, flow2, tb, k_in, eps_in,
        solver_extras=solver_extras,
    )
    return (flow2, tb2), metrics


def solve_steady_turbulent(
    mesh,
    table,
    settings: NumericalSettings,
    rho: float,
    mu: float,
    u_ref: float,
    iterations: int = 500,
    reporting_interval: int = 100,
    intensity: float = 0.05,
    length_scale: float = 0.1,
    state: Optional[FlowState] = None,
    turb: Optional[TurbState] = None,
    verbose: bool = True,
):
    """Steady RANS loop on the mesh's device: each outer iteration runs
    one SIMPLE step with mu_eff = mu + mu_t, then one k/eps update.
    Returns (FlowState, TurbState, list of per-chunk StepMetrics with
    [n]-leading tensors)."""
    table.validate_supported()
    zc, zs, zv = device_bc(table, dtype=mesh.dtype, device=mesh.device)
    diff = None
    if settings.matrix_solver.solver_type == SolutionMethod.MULTIGRID:
        # The laminar diffusion system, the aggregation's coupling values
        # should the algebraic hierarchy be needed (orc_tpu builds it for
        # meshes that are no box; boxes too small or odd to coarsen need
        # it as well).
        diff = diffusion_system(
            mesh, face_bc(mesh, zc, zs, zv),
            torch.tensor(mu, dtype=mesh.dtype, device=mesh.device),
        )
    extras = _solver_extras(mesh, diff, settings)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc0 = ck_bc(ck, zc, zs, zv)
    if state is None:
        state = initial_state(mesh)
    if (
        settings.resolved_coupling() == PressureVelocityCoupling.SIMPLE_FC
        and state.flux is None
    ):
        from orc_tpu_torch.solver.fc import ck_initial_flux

        state = dataclasses.replace(
            state, flux=ck_initial_flux(mesh, ck, bc0, settings, state)
        )
    if turb is None:
        turb = initial_turbulence(mesh, u_ref, intensity, length_scale, rho)
    k_in = 1.5 * (intensity * abs(u_ref)) ** 2
    eps_in = C_MU ** 0.75 * k_in ** 1.5 / length_scale
    has_wall, y_p = _wall_adjacent(ck, bc0)
    is_wall_face = (bc0.code == WALL) & ck.mask & ~ck.interior

    carry = (state, turb)
    history = []
    done = 0
    t0 = time.perf_counter()
    reporting_interval = max(1, min(reporting_interval, iterations))
    while done < iterations:
        n = min(reporting_interval, iterations - done)
        chunk = []
        for _ in range(n):
            carry, metrics = rans_outer_step(
                mesh, ck, bc0, zc, zs, zv, settings, rho, mu, k_in, eps_in,
                has_wall, y_p, is_wall_face, carry, solver_extras=extras,
            )
            chunk.append(metrics)
        done += n
        history.append(
            StepMetrics(
                **{f: torch.stack([getattr(m, f) for m in chunk]) for f in _metric_names()}
            )
        )
        if verbose:
            va = history[-1].vel_avg[-1].tolist()
            dt_ms = (time.perf_counter() - t0) * 1e3 / n
            t0 = time.perf_counter()
            print(
                f"[k-eps] iter {done}: avg velocity = ({va[0]:.2e}, "
                f"{va[1]:.2e}, {va[2]:.2e})  "
                f"mu_t/mu max = {float(torch.max(carry[1].mu_t)) / mu:.1f}  "
                f"ms/iter = {dt_ms:.3g}"
            )
    flow, tb = carry
    return flow, tb, history


def solve_steady_turbulent_sharded(*args, **kwargs):
    raise NotImplementedError(
        "sharded RANS waits for the port's sharded runtime (ROADMAP Queue 1, "
        "item 14)"
    )
