"""Linear solvers and the SIMPLE outer loop."""

from orc_tpu_torch.solver.krylov import SolveInfo, iterative_solve  # noqa: F401
