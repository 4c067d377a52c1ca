"""What the capped pressure solve achieves: the median over the
window's outer iterations of the residual norm the program reports at
the end of each pressure solve (StepMetrics.pc_residual: BiCGSTAB's
after its iterations, or the V-cycle's). Its iteration count is no
measure here: ghia's BiCGSTAB(50) always reaches its cap and the
cube's count is its configured pre-smoother's. A solve that reaches
its relative threshold exits early and so raises iters_per_s; the
median, not the mean, since a capped BiCGSTAB now and then ends far
above its usual residual."""

import statistics

KERNELS = ()


def read(ctx):
    if not ctx.pc_residuals:
        return None
    return statistics.median(ctx.pc_residuals)
