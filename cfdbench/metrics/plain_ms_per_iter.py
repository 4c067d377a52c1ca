"""Device milliseconds per outer iteration of everything that is not one
of the port's hand-written kernels (named orc::): torch eager kernels,
copies and sets, i.e. the Krylov vector algebra, the face-major assembly
and the SIMPLE_FC corrections."""

KERNELS = ("orc::",)


def read(ctx):
    s = sum(v[1] for k, v in ctx.trace.kernels.items() if not any(n in k for n in KERNELS))
    return 1e3 * s / ctx.k if s > 0 else None
