"""orc_tpu_torch: the PyTorch / CUDA port of orc_tpu for NVIDIA Hopper.

A second package beside the JAX reference `orc_tpu`, with the same
layout and names: `orc_tpu/ops/ck_ops.py` is `orc_tpu_torch/ops/ck_ops.py`
and so on, while each Pallas kernel module becomes a module whose
wrapper launches a CUDA kernel written for `sm_90a` (sources under
`csrc/`, built at first use by `ops/_cuda.py`) and whose plain torch
version serves CPU tensors.

Idiom:
- Plain functions on tensors and frozen dataclasses (CompiledMesh,
  SlicePlan, CKGeometry, UniformCKGeometry, FlowState, EllMatrix,
  StepMetrics). The solver has
  no learned weights and takes no gradients, so there is no nn.Module
  and no autograd.Function.
- The device is explicit: mesh constructors and cases take `device=`
  and default to the CUDA device (raising without a GPU; pass
  device="cpu" to run on the CPU), every tensor follows the mesh's
  device, and a wrapper launches its CUDA kernel exactly when its input
  lies on a CUDA device.
- The dtype is explicit: mesh constructors default to float64, as in orc_tpu,
  and every constructor names its dtype and device; the default dtype
  is never changed.
- `lax.scan` / `lax.while_loop` become Python loops; `vmap` over u/v/w
  becomes a leading batch dimension.

The package never imports JAX.
"""

from orc_tpu_torch.mesh import (
    BoundaryTable,
    CompiledMesh,
    FaceCondition,
    compile_mesh,
    read_mesh,
    structured_box_mesh,
)
from orc_tpu_torch.solver.turbulence import (
    TurbState,
    initial_turbulence,
    solve_steady_turbulent,
)
from orc_tpu_torch.utils.settings import (
    DiffusionScheme,
    GradientReconstruction,
    MatrixSolverSettings,
    MomentumScheme,
    NumericalSettings,
    PreconditionMethod,
    PressureInterpolation,
    PressureVelocityCoupling,
    RelaxationMode,
    TVD_LUD,
    TVD_QUICK,
    TVD_UMIST,
    SolutionMethod,
    VelocityInterpolation,
)

from orc_tpu_torch.utils.device import warm_cpu_vector_math

warm_cpu_vector_math()

__version__ = "0.1.0"

__all__ = [
    "BoundaryTable",
    "CompiledMesh",
    "DiffusionScheme",
    "FaceCondition",
    "GradientReconstruction",
    "MatrixSolverSettings",
    "MomentumScheme",
    "NumericalSettings",
    "PreconditionMethod",
    "PressureInterpolation",
    "PressureVelocityCoupling",
    "RelaxationMode",
    "SolutionMethod",
    "TVD_LUD",
    "TVD_QUICK",
    "TVD_UMIST",
    "TurbState",
    "VelocityInterpolation",
    "compile_mesh",
    "initial_turbulence",
    "read_mesh",
    "solve_steady_turbulent",
    "structured_box_mesh",
    "__version__",
]
