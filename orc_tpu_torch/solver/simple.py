"""SIMPLE pressure-velocity coupling, the outer loop (port of the
single-device half of orc_tpu/solver/simple.py).

One SIMPLE iteration is face fluxes -> momentum assembly -> one batched
[3,C] momentum solve -> pressure-correction assembly and solve ->
correction -> metrics. `solve_steady` drives it in a Python loop,
`reporting_interval` iterations per chunk, and reads the small metrics
back to the host once per chunk. It runs one of two steps, as orc_tpu's
does:
- `ck_simple_step`, the gather-free (c,k) formulation (ops/ck_ops.py),
  which use_ck="auto" takes for meshes up to CK_AUTO_MAX_CELLS with
  Green-Gauss cell or least-squares gradients;
- `simple_step`, the face-major formulation (ops/interpolation.py,
  ops/gradients.py, ops/assembly.py: per-face fluxes and face pressures,
  then [C,K] gathers and masked reductions), which use_ck=False forces
  and "auto" takes for node-based Green-Gauss and above the ceiling.

SIMPLE_FC (AUTO under Rhie-Chow + implicit relaxation) runs
`solver/fc.py`'s `ck_simple_step_fc` or `simple_step_fc` in the same
loop, with the stored face flux carried in `FlowState.flux`. Every step
takes the implicit-Euler `inertia` of transient runs
(solver/transient.py) and the momentum source of
settings.momentum_source. A run builds orc_tpu's `solver_extras` once:
the greedy colouring of GAUSS_SEIDEL solves (solver/coloring.py), or the
multigrid hierarchy of MULTIGRID ones (solver/gmg.py on a box that
coarsens, the algebraic hierarchy of solver/amg.py on any other mesh,
aggregated on the face-major diffusion system).

On a CUDA mesh the steps run the hand-written kernels where orc_tpu runs
its Pallas kernels: the fused assembly kernels behind the gate
`_kernel_asm_spec` (mirroring orc_tpu's `_pallas_asm_spec`: the (c,k)
step on uniform boxes; every scheme and face model of orc_tpu's kernels,
steady and transient, the parity kernels with the Green-Gauss pressure
gradient computed in the kernel), the Jacobi-sweep kernel in the
momentum smoother and the shift SpMV in every Krylov iteration, on every
multigrid level, on structured meshes; the slice SpMV on irregular
meshes (RCM-reordered, with a slice plan) and the slice neighbour gather
in their (c,k) assembly; the exact slice product in the residuals of
DF32_IR solves. The face-major step assembles in plain ops, as in
orc_tpu, and solves through the same kernels. On CPU they take the plain
versions.

Both steps take every momentum scheme: UD, CD1 and TVD_DC solve the
u/v/w systems over one shared matrix, CD2 and in-matrix TVD over one
matrix per component (diag [3,C]), whose diagonals the next iteration
reads.

Not ported: the sharded runtime (ROADMAP Queue 1, item 14).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import torch

from orc_tpu_torch.mesh.compile import CompiledMesh, trim_for_ck
from orc_tpu_torch.mesh.zones import BoundaryTable, FaceCondition
from orc_tpu_torch.ops.ck_ops import (
    build_ck_geometry,
    ck_apply_correction,
    ck_bc,
    ck_diffusion,
    ck_face_pressure,
    ck_flux,
    ck_lsq_pressure_gradient,
    ck_lsq_velocity_gradient,
    ck_momentum,
    ck_pressure_correction,
    ck_pressure_gradient,
    ck_velocity_gradient,
    mesh_matrix,
    nbr_values,
)
from orc_tpu_torch.ops.assembly import (
    DiffusionSystem,
    apply_pressure_correction,
    diffusion_system,
    momentum_system,
    pressure_correction_system,
)
from orc_tpu_torch.ops.fields import device_bc, face_bc, momentum_source_term
from orc_tpu_torch.ops.gradients import pressure_gradient, velocity_gradient
from orc_tpu_torch.ops.interpolation import face_flux, face_pressure
from orc_tpu_torch.solver.krylov import (
    _no_project,
    constant_deflation,
    iterative_solve,
)
from orc_tpu_torch.utils.settings import (
    GradientReconstruction,
    MomentumScheme,
    NumericalSettings,
    PressureInterpolation,
    PressureVelocityCoupling,
    RelaxationMode,
    SolutionMethod,
    VelocityInterpolation,
)

#: Cell-count ceiling under which use_ck="auto" picks the (c,k) step,
#: read once at import from ORC_TPU_CK_MAX_CELLS as orc_tpu reads it.
CK_AUTO_MAX_CELLS = int(os.environ.get("ORC_TPU_CK_MAX_CELLS", "10000000"))


class SolverDivergedError(RuntimeError):
    def __init__(self, iteration: int):
        super().__init__(f"solution diverged at iteration {iteration}")
        self.iteration = iteration


@dataclasses.dataclass(frozen=True)
class FlowState:
    vel: torch.Tensor  # [C,3]
    p: torch.Tensor  # [C]
    # Momentum-matrix diagonals of the previous iteration, component-
    # major [3,C] as in orc_tpu (1.0 before the first iteration).
    mom_diag: torch.Tensor  # [3,C]
    # Stored face fluxes of SIMPLE_FC; None on the parity loop. On the
    # (c,k) step the outward normal velocity per (cell, ELL slot) [C,K],
    # a view of K contiguous [C] planes; on the face-major step the
    # owner-outward normal velocity per face [F].
    flux: "torch.Tensor | None" = None


@dataclasses.dataclass(frozen=True)
class StepMetrics:
    """Per-iteration metrics (tensors; [n]-leading once stacked)."""

    vel_avg: torch.Tensor  # [3]
    peclet_avg: torch.Tensor
    peclet_min: torch.Tensor
    peclet_max: torch.Tensor
    p_corr_norm: torch.Tensor
    vel_corr_norm: torch.Tensor
    mom_residual: torch.Tensor  # [3] final momentum solve residuals
    pc_residual: torch.Tensor  # pressure-correction solve residual
    diverged: torch.Tensor  # bool
    mom_iters: torch.Tensor  # [3] inner iterations per momentum solve
    pc_iters: torch.Tensor  # inner iterations of the p' solve


def _metric_names():
    return [f.name for f in dataclasses.fields(StepMetrics)]


def stack_history(history):
    """Concatenate per-chunk StepMetrics into one StepMetrics of
    [n_iterations]-leading numpy arrays."""
    import numpy as np

    return StepMetrics(
        **{
            f: np.concatenate([_np(getattr(h, f)) for h in history])
            for f in _metric_names()
        }
    )


def _np(t):
    return t.detach().cpu().numpy()


def save_history(path, history):
    """Write the stacked iteration history as an npz archive, one array
    per StepMetrics field."""
    import numpy as np

    hs = stack_history(history)
    np.savez_compressed(path, **{f: getattr(hs, f) for f in _metric_names()})


def initial_state(mesh: CompiledMesh, vel=None, p=None) -> FlowState:
    C, dt, dev = mesh.n_cells, mesh.dtype, mesh.device
    return FlowState(
        vel=(
            torch.zeros((C, 3), dtype=dt, device=dev)
            if vel is None
            else torch.as_tensor(vel, dtype=dt, device=dev)
        ),
        p=(
            torch.zeros((C,), dtype=dt, device=dev)
            if p is None
            else torch.as_tensor(p, dtype=dt, device=dev)
        ),
        mom_diag=torch.ones((3, C), dtype=dt, device=dev),
    )


def _needs_grad_p(settings: NumericalSettings) -> bool:
    return (
        settings.velocity_interpolation == VelocityInterpolation.RHIE_CHOW
        or settings.pressure_interpolation == PressureInterpolation.SECOND_ORDER
    )


def _needs_grad_vel(settings: NumericalSettings) -> bool:
    return settings.momentum in (
        MomentumScheme.TVD, MomentumScheme.TVD_DC, MomentumScheme.CD2
    )


def gradient_fns(settings: NumericalSettings):
    """(pressure gradient, velocity gradient) of the (c,k) step:
    least squares or Green-Gauss cell, by settings.gradient_reconstruction
    (looked up when called, so a caller may wrap either)."""
    if settings.gradient_reconstruction == GradientReconstruction.LEAST_SQUARES:
        return ck_lsq_pressure_gradient, ck_lsq_velocity_gradient
    return ck_pressure_gradient, ck_velocity_gradient


def table_maybe_singular(table) -> bool:
    """True when no zone can anchor the p' system (every zone interior
    or periodic): the pressure-correction matrix is then singular."""
    exempt = (
        FaceCondition.INTERIOR,
        FaceCondition.PERIODIC,
        FaceCondition.PERIODIC_SHADOW,
    )
    return all(fz.zone_type in exempt for fz in table.zones.values())


def table_has_pressure_bc(table) -> bool:
    """True when any zone is a pressure inlet/outlet."""
    return any(
        fz.zone_type
        in (FaceCondition.PRESSURE_INLET, FaceCondition.PRESSURE_OUTLET)
        for fz in table.zones.values()
    )


def initial_flux(mesh, zone_codes, zone_scalar, zone_vector, settings, state):
    """Seed FlowState.flux [F] for a face-major SIMPLE_FC run: the plain
    interpolated flux of the initial fields (solver/fc.py corrects it
    conservatively from the first iteration on)."""
    fbc = face_bc(mesh, zone_codes, zone_scalar, zone_vector)
    grad_p = (
        pressure_gradient(mesh, fbc, state.p, settings.gradient_reconstruction)
        if _needs_grad_p(settings)
        else None
    )
    return face_flux(
        mesh,
        fbc,
        state.vel,
        settings.velocity_interpolation,
        p=state.p,
        grad_p=grad_p,
        mom_diag=state.mom_diag.T,
    )


def _solve_p_prime(
    Pmat, b_p, p, settings, active, maybe_singular: bool, x0=None,
    solver_extras=None,
):
    """Solve the pressure(-correction) system, with the constant null
    mode deflated when the system is singular (on every multigrid level:
    `null_scale` reaches the coarse ones). The parity loop starts from
    zero; SIMPLE_FC solves the full p warm-started from `x0` = p, zeroed
    outside the active rows."""
    if maybe_singular:
        null_scale = torch.ones((), dtype=p.dtype, device=p.device)
        project = constant_deflation(null_scale, active=active)
    else:
        null_scale, project = None, _no_project
    if x0 is None:
        x0 = torch.zeros_like(p)
    else:
        x0 = torch.where(active, x0, torch.zeros((), dtype=p.dtype, device=p.device))
    p_prime, p_info = iterative_solve(
        Pmat, b_p, x0, settings.matrix_solver, project=project,
        null_scale=null_scale, **(solver_extras or {}),
    )
    return project(p_prime), p_info


def _solve_momentum(A3, b3, vel, active, settings, solver_extras=None):
    """One batched solve of the u/v/w systems, over the shared matrix or
    one matrix per component, warm-started from vel: (new vel [C,3], new
    mom_diag [3,C], info)."""
    zero = torch.zeros((), dtype=vel.dtype, device=vel.device)
    x0 = torch.where(active[None, :], vel.T, zero)  # [3,C]
    sol, info = iterative_solve(
        A3, b3, x0, settings.momentum_matrix_solver(), **(solver_extras or {})
    )
    if A3.diag.ndim == 2:
        return sol.T, A3.diag, info
    return sol.T, A3.diag[None, :].expand(3, -1), info


def _kernel_peclet(settings, mdiag, diff_diag, active, inertia=None):
    """Per-cell Peclet estimate [C,3] from the kernels' relaxed momentum
    diagonal (the kernels do not return the advection diagonal), less
    the inertia term rho V/dt of transient runs."""
    zero = torch.zeros((), dtype=mdiag.dtype, device=mdiag.device)
    one = torch.ones((), dtype=mdiag.dtype, device=mdiag.device)
    rvdt = inertia[0] if inertia is not None else 0.0
    safe_dd = torch.where(active, diff_diag, one)
    return torch.where(
        active[:, None],
        ((settings.momentum_relaxation * mdiag - diff_diag - rvdt) / safe_dd)[:, None]
        * torch.ones((1, 3), dtype=mdiag.dtype, device=mdiag.device),
        zero,
    )


def _add_momentum_source(mesh, settings, b3, active):
    """b3 [3,C] plus settings.momentum_source on the active rows: the
    kernel branch adds the source after the kernel, as orc_tpu does."""
    if settings.momentum_source is None:
        return b3
    src = momentum_source_term(
        settings.momentum_source, mesh.cell_centroid, mesh.cell_volume
    )
    zero = torch.zeros((), dtype=b3.dtype, device=b3.device)
    return b3 + torch.where(active[None, :], src.T, zero)


def _step_metrics(active, vel3, pe, p_corr_sq, vel_corr_sq, info, p_info):
    """StepMetrics of one iteration over the active cells."""
    zero = torch.zeros((), dtype=vel3.dtype, device=vel3.device)
    n_active = torch.sum(active).to(vel3.dtype)
    vel_avg = torch.sum(torch.where(active[:, None], vel3, zero), dim=0) / n_active
    inf = torch.full((), float("inf"), dtype=pe.dtype, device=pe.device)
    return StepMetrics(
        vel_avg=vel_avg,
        peclet_avg=torch.sum(pe) / (3.0 * n_active),
        peclet_min=torch.amin(torch.where(active[:, None], pe, inf)),
        peclet_max=torch.amax(torch.where(active[:, None], pe, -inf)),
        p_corr_norm=torch.sqrt(p_corr_sq),
        vel_corr_norm=torch.sqrt(vel_corr_sq),
        mom_residual=info.residual,
        pc_residual=p_info.residual,
        diverged=(
            torch.any(torch.isnan(vel_avg))
            | torch.any(info.diverged)
            | p_info.diverged
        ),
        mom_iters=info.iterations,
        pc_iters=p_info.iterations,
    )


def simple_step(
    mesh: CompiledMesh,
    zone_codes,
    zone_scalar,
    zone_vector,
    settings: NumericalSettings,
    rho,
    mu,
    diff: DiffusionSystem,
    state: FlowState,
    solver_extras: Optional[dict] = None,
    inertia=None,
    maybe_singular: bool = True,
):
    """One SIMPLE iteration in the face-major formulation (orc_tpu's
    `simple_step`, single device). `solver_extras` is orc_tpu's: the
    colouring of GAUSS_SEIDEL runs, the hierarchy of MULTIGRID ones;
    `inertia` = (rv_dt [C], vel_n [C,3]) of a transient step."""
    fbc = face_bc(mesh, zone_codes, zone_scalar, zone_vector)
    active = mesh.cell_face_mask.any(dim=1)  # non-padded cells
    vel, p = state.vel, state.p
    mom_diag = state.mom_diag.T  # cell-major [C,3] view

    grad_p = (
        pressure_gradient(mesh, fbc, p, settings.gradient_reconstruction)
        if _needs_grad_p(settings)
        else None
    )
    grad_v = (
        velocity_gradient(mesh, fbc, vel, settings.gradient_reconstruction)
        if _needs_grad_vel(settings)
        else None
    )
    flux = face_flux(
        mesh, fbc, vel, settings.velocity_interpolation,
        p=p, grad_p=grad_p, mom_diag=mom_diag,
    )
    p_f = face_pressure(mesh, fbc, p, settings.pressure_interpolation, grad_p=grad_p)
    A3, b3, pe = momentum_system(
        mesh, fbc, settings, rho, vel, flux, p_f, diff, grad_vel=grad_v,
        inertia=inertia,
    )
    new_vel, new_mom_diag, info = _solve_momentum(
        A3, b3, vel, active, settings, solver_extras
    )
    new_md_c = new_mom_diag.T

    # Pressure correction with the post-solve velocities and the new
    # momentum diagonals (reference: solver.rs:137-148).
    flux2 = face_flux(
        mesh, fbc, new_vel, settings.velocity_interpolation,
        p=p, grad_p=grad_p, mom_diag=new_md_c,
    )
    Pmat, b_p = pressure_correction_system(mesh, fbc, rho, flux2, new_md_c)
    p_prime, p_info = _solve_p_prime(
        Pmat, b_p, p, settings, active, maybe_singular,
        solver_extras=solver_extras,
    )
    vel3, p_new, (p_corr_sq, vel_corr_sq) = apply_pressure_correction(
        mesh, fbc, settings, p_prime, new_md_c, new_vel, p
    )
    metrics = _step_metrics(active, vel3, pe, p_corr_sq, vel_corr_sq, info, p_info)
    return FlowState(vel=vel3, p=p_new, mom_diag=new_mom_diag), metrics


def ck_simple_step(
    mesh: CompiledMesh,
    ck,
    zone_codes,
    zone_scalar,
    zone_vector,
    settings: NumericalSettings,
    rho,
    mu,
    ck_diff,
    state: FlowState,
    kernel_asm=None,  # (cols, AsmSpec) -> fused assembly kernels
    maybe_singular: bool = True,
    inertia=None,  # (rv_dt [C], vel_n [C,3]) of a transient step
    solver_extras=None,  # orc_tpu's: colouring or multigrid hierarchy
):
    """One SIMPLE iteration in the gather-free (c,k) formulation."""
    bc = ck_bc(ck, zone_codes, zone_scalar, zone_vector)
    diff_diag, diff_off, diff_b = ck_diff
    vel, p = state.vel, state.p
    active = ck.mask.any(dim=1)

    grad_p = grad_p_nbr = None
    gp_fn, gv_fn = gradient_fns(settings)
    need_gv = _needs_grad_vel(settings)
    if kernel_asm is not None:
        # Fused assembly kernels (ops/fused_assembly.py): one pass over
        # the cell fields yields the shared momentum matrix and RHS. With
        # AsmSpec.gg they compute grad p themselves: no gradient pass.
        from orc_tpu_torch.ops.fused_assembly import (
            bc_value_table,
            momentum_assembly,
            pack_flags,
        )

        cols, aspec = kernel_asm
        flags = pack_flags(ck.interior, ck.mask)
        bcv = bc_value_table(zone_scalar, zone_vector)
        if _needs_grad_p(settings) and not aspec.gg:
            grad_p = gp_fn(mesh, ck, bc, p)
        grad_v = gv_fn(mesh, ck, bc, vel) if need_gv else None
        mdiag, moff, b3 = momentum_assembly(
            vel, p, bcv, flags, cols, rho, mu, settings.momentum_relaxation,
            grad_p=grad_p, mom_diag=state.mom_diag[0], grad_vel=grad_v,
            inertia=inertia, spec=aspec,
        )
        b3 = _add_momentum_source(mesh, settings, b3, active)
        A3 = mesh_matrix(mesh, mdiag, moff)
        pe = _kernel_peclet(settings, mdiag, diff_diag, active, inertia)
    else:
        md_c = state.mom_diag.T  # cell-major [C,3] view
        vel_nbr = nbr_values(mesh, vel, ck.interior)
        if _needs_grad_p(settings):
            grad_p = gp_fn(mesh, ck, bc, p)
            grad_p_nbr = nbr_values(mesh, grad_p, ck.interior)
        grad_v = gv_fn(mesh, ck, bc, vel, vel_nbr=vel_nbr) if need_gv else None
        mom_diag_nbr = nbr_values(mesh, md_c, ck.interior)
        flux = ck_flux(
            mesh, ck, bc, vel, settings.velocity_interpolation,
            p=p, grad_p=grad_p, grad_p_nbr=grad_p_nbr,
            mom_diag=md_c, mom_diag_nbr=mom_diag_nbr, vel_nbr=vel_nbr,
        )
        F = flux * ck.area * rho
        p_f = ck_face_pressure(
            mesh, ck, bc, p, settings.pressure_interpolation,
            grad_p=grad_p, grad_p_nbr=grad_p_nbr,
        )
        A3, b3, pe = ck_momentum(
            mesh, ck, bc, settings, rho, vel, F, p_f,
            diff_diag, diff_off, diff_b, grad_vel=grad_v, vel_nbr=vel_nbr,
            inertia=inertia,
        )

    new_vel, new_mom_diag, info = _solve_momentum(
        A3, b3, vel, active, settings, solver_extras
    )

    if kernel_asm is not None:
        from orc_tpu_torch.ops.fused_assembly import pc_assembly

        pdiag, poff, b_p = pc_assembly(
            new_vel, A3.diag, bcv, flags, cols, rho, p=p, grad_p=grad_p,
            spec=aspec,
        )
        Pmat = mesh_matrix(mesh, pdiag, poff)
    else:
        new_md_c = new_mom_diag.T
        new_md_nbr = nbr_values(mesh, new_md_c, ck.interior)
        new_vel_nbr = nbr_values(mesh, new_vel, ck.interior)
        flux2 = ck_flux(
            mesh, ck, bc, new_vel, settings.velocity_interpolation,
            p=p, grad_p=grad_p, grad_p_nbr=grad_p_nbr,
            mom_diag=new_md_c, mom_diag_nbr=new_md_nbr, vel_nbr=new_vel_nbr,
        )
        F2 = flux2 * ck.area * rho
        Pmat, b_p = ck_pressure_correction(
            mesh, ck, bc, rho, F2, new_md_c, mom_diag_nbr=new_md_nbr
        )
    p_prime, p_info = _solve_p_prime(
        Pmat, b_p, p, settings, active, maybe_singular,
        solver_extras=solver_extras,
    )
    vel3, p_new, (p_corr_sq, vel_corr_sq) = ck_apply_correction(
        mesh, ck, bc, settings, p_prime, new_mom_diag.T, new_vel, p
    )

    metrics = _step_metrics(active, vel3, pe, p_corr_sq, vel_corr_sq, info, p_info)
    return FlowState(vel=vel3, p=p_new, mom_diag=new_mom_diag), metrics


def _run_chunk(step, state, settings, n_steps):
    """n_steps iterations of `step` (state -> (state, metrics)); returns
    (state, StepMetrics of [n_steps]-leading tensors). Float32 runs
    accumulate (vel, p) with Kahan compensation when
    settings.compensated_state is set: without it, increments below f32
    epsilon of the fields round away and the run freezes short of steady
    state. The SIMPLE_FC flux is not compensated: it rides in the step's
    new state."""
    use_comp = settings.compensated_state and state.vel.dtype == torch.float32
    cv = torch.zeros_like(state.vel) if use_comp else None
    cp = torch.zeros_like(state.p) if use_comp else None
    history = []
    for _ in range(n_steps):
        s2, metrics = step(state)
        if use_comp:
            dv = (s2.vel - state.vel) + cv
            vel = state.vel + dv
            cv = dv - (vel - state.vel)
            dp = (s2.p - state.p) + cp
            p = state.p + dp
            cp = dp - (p - state.p)
            s2 = dataclasses.replace(s2, vel=vel, p=p)
        state = s2
        history.append(metrics)
    stacked = StepMetrics(
        **{f: torch.stack([getattr(m, f) for m in history]) for f in _metric_names()}
    )
    return state, stacked


def _on_cuda(mesh) -> bool:
    return mesh.cell_volume.is_cuda


def _kernel_asm_spec(mesh, table, settings, ck, fc=False):
    """Static (cols, AsmSpec) for the fused assembly kernels when the
    configuration is eligible, else None: orc_tpu's `_pallas_asm_spec`
    with "on CPU" read as "mesh not on CUDA" and the float32 condition
    dropped (Hopper has float64). Both couplings take UD / CD1 / TVD_DC
    momentum, Linear[Weighted] or Rhie-Chow face fluxes and
    Linear[Weighted] or SecondOrder face pressures, under implicit
    relaxation, on uniform boxes (`column_specs`), steady or transient
    (the kernels take the inertia term, so orc_tpu's `transient` flag
    selects nothing here).

    - A CUDA kernel takes no Python callable, so the TVD limiter travels
      as a code: only tvd_lud, tvd_quick and tvd_umist are eligible; any
      other callable gives None, as orc_tpu's gate does when tvd_psi is
      None.
    - `gg` (the parity kernels compute the Green-Gauss pressure gradient
      themselves) is set under Rhie-Chow or SecondOrder with Green-Gauss
      cell gradients; the SIMPLE_FC kernels read grad p streamed.
    """
    if (
        ck is None
        or mesh.ck_constants is None
        or not _on_cuda(mesh)
        or settings.relaxation_mode != RelaxationMode.IMPLICIT
    ):
        return None
    from orc_tpu_torch.ops.fused_assembly import (
        LIMITER_CODES,
        AsmSpec,
        column_specs,
    )

    scheme = {
        MomentumScheme.UD: "ud",
        MomentumScheme.CD1: "cd1",
        MomentumScheme.TVD_DC: "tvd_dc",
    }.get(settings.momentum)
    if scheme is None:
        return None
    if scheme == "tvd_dc" and settings.tvd_psi not in LIMITER_CODES:
        return None
    linear_v = (VelocityInterpolation.LINEAR, VelocityInterpolation.LINEAR_WEIGHTED)
    linear_p = (PressureInterpolation.LINEAR, PressureInterpolation.LINEAR_WEIGHTED)
    vi, pi = settings.velocity_interpolation, settings.pressure_interpolation
    rc = vi == VelocityInterpolation.RHIE_CHOW
    p_so = pi == PressureInterpolation.SECOND_ORDER
    if not (rc or vi in linear_v) or not (p_so or pi in linear_p):
        return None
    cols = column_specs(mesh, table)
    if cols is None:
        return None
    gg = (
        (rc or p_so)
        and not fc
        and settings.gradient_reconstruction
        == GradientReconstruction.GREEN_GAUSS_CELL
    )
    return cols, AsmSpec(
        scheme=scheme,
        rc=rc,
        p_so=p_so,
        psi=settings.tvd_psi if scheme == "tvd_dc" else None,
        vol=float(mesh.cell_volume[0]),
        gg=gg,
    )


def _takes_ck_step(mesh, settings: NumericalSettings, use_ck) -> bool:
    """orc_tpu's choice of step in `solve_steady`: use_ck=True forces the
    (c,k) step (which computes Green-Gauss cell or least-squares
    gradients only, so node-based Green-Gauss raises ValueError); "auto"
    takes it for those gradients up to CK_AUTO_MAX_CELLS cells; anything
    else takes the face-major step."""
    ck_grad_ok = settings.gradient_reconstruction in (
        GradientReconstruction.GREEN_GAUSS_CELL,
        GradientReconstruction.LEAST_SQUARES,
    )
    if use_ck is True and not ck_grad_ok:
        raise ValueError(
            "use_ck=True requires green_gauss_cell or least_squares "
            f"gradients (the ck-direct step does not implement "
            f"{settings.gradient_reconstruction})"
        )
    return use_ck is True or (
        use_ck == "auto" and ck_grad_ok and mesh.n_cells <= CK_AUTO_MAX_CELLS
    )


def _solver_extras(mesh, diff, settings):
    """orc_tpu's `solver_extras` of a run, built once: the greedy
    colouring under GAUSS_SEIDEL, the multigrid hierarchy under MULTIGRID
    (geometric on a box that coarsens, else algebraic, aggregated on the
    diffusion system `diff`), else nothing."""
    method = settings.matrix_solver.solver_type
    if method == SolutionMethod.GAUSS_SEIDEL:
        from orc_tpu_torch.solver.coloring import greedy_coloring

        colors, n_colors = greedy_coloring(mesh)
        return dict(colors=colors, n_colors=n_colors)
    if method == SolutionMethod.MULTIGRID:
        from orc_tpu_torch.solver.gmg import build_mg_hierarchy

        return dict(mg_hierarchy=build_mg_hierarchy(mesh, diff, settings))
    return {}


def solve_steady(
    mesh: CompiledMesh,
    table: BoundaryTable,
    settings: NumericalSettings,
    rho: float,
    mu: float,
    state: Optional[FlowState] = None,
    iterations: int = 10,
    reporting_interval: int = 1,
    verbose: bool = True,
    check_divergence: bool = True,
    use_ck: str | bool = "auto",
):
    """Host loop of the steady SIMPLE solve on the mesh's device: the
    parity loop, or SIMPLE_FC when settings.resolved_coupling() says so.

    `use_ck`: "auto" takes the gather-free (c,k) step for Green-Gauss
    cell or least-squares gradients on meshes up to CK_AUTO_MAX_CELLS,
    the face-major step otherwise; True forces the (c,k) step, False the
    face-major one. Returns (FlowState, list of per-chunk StepMetrics
    with [n]-leading tensors)."""
    from orc_tpu_torch.solver.fc import (
        ck_initial_flux,
        ck_simple_step_fc,
        simple_step_fc,
    )

    table.validate_supported()
    use_ck_step = _takes_ck_step(mesh, settings, use_ck)
    reporting_interval = max(1, min(reporting_interval, iterations))
    zc, zs, zv = device_bc(table, dtype=mesh.dtype, device=mesh.device)
    if state is None:
        state = initial_state(mesh)

    use_fc = settings.resolved_coupling() == PressureVelocityCoupling.SIMPLE_FC
    mu_t = torch.tensor(mu, dtype=mesh.dtype, device=mesh.device)
    ck = ck_diff = diff = None
    if use_ck_step:
        ck = build_ck_geometry(mesh, len(table.zone_ids))
        bc0 = ck_bc(ck, zc, zs, zv)
        ck_diff = ck_diffusion(mesh, ck, bc0, mu_t)
    if ck is None or settings.matrix_solver.solver_type == SolutionMethod.MULTIGRID:
        # The face-major diffusion system: the face-major step's, or the
        # coupling values the algebraic hierarchy aggregates on.
        diff = diffusion_system(mesh, face_bc(mesh, zc, zs, zv), mu_t)
    extras = _solver_extras(mesh, diff, settings)
    if ck is not None:
        diff = None  # the (c,k) step does not read it
    if use_fc and state.flux is None:
        # The stored flux exists before the loop: [C,K] on the (c,k)
        # step, [F] on the face-major one.
        if ck is not None:
            flux0 = ck_initial_flux(mesh, ck, bc0, settings, state)
        else:
            flux0 = initial_flux(mesh, zc, zs, zv, settings, state)
        state = dataclasses.replace(state, flux=flux0)
    kernel_asm = _kernel_asm_spec(mesh, table, settings, ck, fc=use_fc)
    # Under SIMPLE_FC walls anchor nothing: only pressure zones do.
    maybe_singular = (
        not table_has_pressure_bc(table) if use_fc else table_maybe_singular(table)
    )
    if ck is not None and mesh.neighbor_offsets is not None:
        # The irregular step still reads cell_neighbors and the plan.
        mesh = trim_for_ck(mesh)
    if ck is None:
        fm_step = simple_step_fc if use_fc else simple_step

        def step(s):
            return fm_step(
                mesh, zc, zs, zv, settings, rho, mu, diff, s, extras,
                maybe_singular=maybe_singular,
            )
    else:
        ck_step = ck_simple_step_fc if use_fc else ck_simple_step

        def step(s):
            return ck_step(
                mesh, ck, zc, zs, zv, settings, rho, mu, ck_diff, s,
                kernel_asm=kernel_asm, maybe_singular=maybe_singular,
                solver_extras=extras,
            )

    history = []
    done = 0
    t0 = time.perf_counter()
    while done < iterations:
        n = min(reporting_interval, iterations - done)
        state, metrics = _run_chunk(step, state, settings, n)
        done += n
        history.append(metrics)
        if verbose:
            if state.vel.is_cuda:
                torch.cuda.synchronize(state.vel.device)
            dt_ms = (time.perf_counter() - t0) * 1e3 / n
            t0 = time.perf_counter()
            va = _np(metrics.vel_avg[-1])
            print(
                f"Iteration {done}: avg velocity = "
                f"({va[0]:.2e}, {va[1]:.2e}, {va[2]:.2e})\t"
                f"avg peclet = {float(metrics.peclet_avg[-1]):.1e}\t"
                f"vel corr = {float(metrics.vel_corr_norm[-1]):.2e}\t"
                f"p corr = {float(metrics.p_corr_norm[-1]):.2e}\t"
                f"ms/iter = {dt_ms:.3g}"
            )
        if check_divergence and bool(torch.any(metrics.diverged)):
            raise SolverDivergedError(done)
    return state, history
