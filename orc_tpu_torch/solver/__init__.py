"""Linear solvers and the SIMPLE outer loop."""
