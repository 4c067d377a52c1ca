"""Numerical settings for the solver stack (port of orc_tpu/utils/settings.py).

The enums, their values and every default are those of orc_tpu, so a
settings object built in either package means the same run. The
dataclasses stay frozen and hashable: the solver selects code paths from
them on the host, exactly as orc_tpu selects traces. The rationale for
each default is documented beside the orc_tpu original.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

import torch


class PressureVelocityCoupling(enum.Enum):
    """SIMPLE: the reference-parity stateless p'-increment loop.
    SIMPLE_FC: flux-corrected SIMPLE (solver/fc.py).
    AUTO: SIMPLE_FC under Rhie-Chow + implicit relaxation, SIMPLE
    otherwise (NumericalSettings.resolved_coupling)."""

    SIMPLE = "simple"
    SIMPLE_FC = "simple_fc"
    AUTO = "auto"


class RelaxationMode(enum.Enum):
    """EXPLICIT: scale the velocity correction by alpha_u (reference).
    IMPLICIT: Patankar under-relaxation of the momentum diagonal."""

    EXPLICIT = "explicit"
    IMPLICIT = "implicit"


class MomentumScheme(enum.Enum):
    UD = "ud"
    CD1 = "cd1"
    CD2 = "cd2"
    TVD = "tvd"
    TVD_DC = "tvd_dc"


class DiffusionScheme(enum.Enum):
    CD = "cd"


class PressureInterpolation(enum.Enum):
    LINEAR = "linear"
    LINEAR_WEIGHTED = "linear_weighted"
    STANDARD = "standard"
    SECOND_ORDER = "second_order"
    NONE = "none"


class VelocityInterpolation(enum.Enum):
    LINEAR = "linear"
    LINEAR_WEIGHTED = "linear_weighted"
    RHIE_CHOW = "rhie_chow"
    NONE = "none"


class PressureCorrectionForm(enum.Enum):
    """CELL_DIFFERENCE: reference-parity velocity correction (default).
    FACE_VALUE: the consistent textbook correction."""

    CELL_DIFFERENCE = "cell_difference"
    FACE_VALUE = "face_value"


class GradientReconstruction(enum.Enum):
    GREEN_GAUSS_CELL = "green_gauss_cell"
    GREEN_GAUSS_NODE = "green_gauss_node"
    LEAST_SQUARES = "least_squares"
    NONE = "none"


class TurbulenceModel(enum.Enum):
    NONE = "none"
    STANDARD_K_EPSILON = "k_epsilon"


class SolutionMethod(enum.Enum):
    JACOBI = "jacobi"
    GAUSS_SEIDEL = "gauss_seidel"
    BICGSTAB = "bicgstab"
    MULTIGRID = "multigrid"
    # Fixed-count damped Jacobi, the warm-started transport smoother.
    JACOBI_SMOOTH = "jacobi_smooth"


class PreconditionMethod(enum.Enum):
    NONE = "none"
    JACOBI = "jacobi"


class SolverPrecision(enum.Enum):
    """NATIVE: solve in the system's dtype. DF32_IR: float64 systems by
    df32 iterative refinement over float32 inner solves
    (solver/refine.py)."""

    NATIVE = "native"
    DF32_IR = "df32_ir"


class RestrictionMethod(enum.Enum):
    INJECTION = "injection"
    STRONGEST = "strongest"


# --- TVD limiter functions psi(r) on torch tensors. ---


def tvd_lud(r):
    return r


def tvd_quick(r):
    return (3.0 + r) / 4.0


def tvd_umist(r):
    m = torch.minimum(
        torch.minimum(2.0 * r, (1.0 + 3.0 * r) / 4.0),
        torch.minimum((3.0 + r) / 4.0, torch.full_like(r, 2.0)),
    )
    return torch.clamp(m, min=0.0)


@dataclasses.dataclass(frozen=True)
class MatrixSolverSettings:
    solver_type: SolutionMethod = SolutionMethod.MULTIGRID
    iterations: int = 50
    relaxation: float = 0.5
    relative_convergence_threshold: float = 1e-3
    # Sweeps of the fixed-count damped-Jacobi smoother used for the
    # warm-started momentum solves under implicit relaxation; None =
    # solve momentum with the full configured solver.
    momentum_iterations: Optional[int] = 6
    # Relative exit of the momentum solves when the smoother does not
    # apply (explicit relaxation); None = relative_convergence_threshold.
    momentum_relative_threshold: Optional[float] = 0.1
    preconditioner: PreconditionMethod = PreconditionMethod.JACOBI
    multigrid_smoother: SolutionMethod = SolutionMethod.BICGSTAB
    multigrid_levels: int = 3
    multigrid_restriction: RestrictionMethod = RestrictionMethod.STRONGEST
    multigrid_coarsest_size: int = 16
    multigrid_smoother_iterations: Optional[int] = None
    # Accumulate f32 dot products and norms in f64.
    compensated_f32: bool = False
    precision: SolverPrecision = SolverPrecision.NATIVE
    refine_steps: int = 3

    def replace_precision(self, p: SolverPrecision) -> "MatrixSolverSettings":
        return dataclasses.replace(self, precision=p)

    def momentum_solver(self) -> "MatrixSolverSettings":
        """Settings of the warm-started transport solves: fixed-count
        damped Jacobi at relaxation 0.8."""
        if self.momentum_iterations is None:
            return self
        return dataclasses.replace(
            self,
            solver_type=SolutionMethod.JACOBI_SMOOTH,
            iterations=self.momentum_iterations,
            relaxation=0.8,
        )


@dataclasses.dataclass(frozen=True)
class NumericalSettings:
    pressure_velocity_coupling: PressureVelocityCoupling = (
        PressureVelocityCoupling.AUTO
    )
    momentum: MomentumScheme = MomentumScheme.CD1
    tvd_psi: Optional[Callable] = None
    diffusion: DiffusionScheme = DiffusionScheme.CD
    pressure_interpolation: PressureInterpolation = PressureInterpolation.SECOND_ORDER
    velocity_interpolation: VelocityInterpolation = VelocityInterpolation.RHIE_CHOW
    pressure_correction_form: PressureCorrectionForm = (
        PressureCorrectionForm.CELL_DIFFERENCE
    )
    gradient_reconstruction: GradientReconstruction = (
        GradientReconstruction.GREEN_GAUSS_CELL
    )
    momentum_relaxation: float = 0.5
    relaxation_mode: "RelaxationMode" = None  # EXPLICIT, set in __post_init__
    pressure_relaxation: float = 0.01
    momentum_source: Optional[Callable] = None
    matrix_solver: MatrixSolverSettings = dataclasses.field(
        default_factory=MatrixSolverSettings
    )
    turbulence: TurbulenceModel = TurbulenceModel.NONE
    # Kahan-compensated accumulation of (vel, p) in float32 runs.
    compensated_state: bool = True
    fc_flux_relaxation: Optional[float] = None

    def resolved_fc_flux_relaxation(self) -> float:
        if self.fc_flux_relaxation is not None:
            return self.fc_flux_relaxation
        if self.relaxation_mode is RelaxationMode.IMPLICIT:
            return 1.0
        return self.momentum_relaxation

    def __post_init__(self):
        if self.relaxation_mode is None:
            object.__setattr__(
                self, "relaxation_mode", RelaxationMode.EXPLICIT
            )

    def resolved_coupling(self) -> PressureVelocityCoupling:
        """AUTO -> SIMPLE_FC iff Rhie-Chow face fluxes AND implicit
        relaxation; the parity SIMPLE loop otherwise."""
        if self.pressure_velocity_coupling is not PressureVelocityCoupling.AUTO:
            return self.pressure_velocity_coupling
        if (
            self.velocity_interpolation is VelocityInterpolation.RHIE_CHOW
            and self.relaxation_mode is RelaxationMode.IMPLICIT
        ):
            return PressureVelocityCoupling.SIMPLE_FC
        return PressureVelocityCoupling.SIMPLE

    def momentum_matrix_solver(self) -> MatrixSolverSettings:
        """Settings of the momentum solves: the fixed-count smoother
        under implicit relaxation; under explicit relaxation the
        configured Krylov solver (multigrid replaced by its smoother)
        loosened to momentum_relative_threshold."""
        ms = self.matrix_solver
        if self.relaxation_mode != RelaxationMode.IMPLICIT:
            if ms.solver_type == SolutionMethod.MULTIGRID:
                ms = dataclasses.replace(
                    ms, solver_type=ms.multigrid_smoother
                )
            if ms.momentum_relative_threshold is None:
                return ms
            return dataclasses.replace(
                ms,
                relative_convergence_threshold=(
                    ms.momentum_relative_threshold
                ),
            )
        return ms.momentum_solver()

    def replace(self, **kw) -> "NumericalSettings":
        return dataclasses.replace(self, **kw)


TVD_LUD = NumericalSettings(momentum=MomentumScheme.TVD, tvd_psi=tvd_lud)
TVD_QUICK = NumericalSettings(momentum=MomentumScheme.TVD, tvd_psi=tvd_quick)
TVD_UMIST = NumericalSettings(momentum=MomentumScheme.TVD, tvd_psi=tvd_umist)
