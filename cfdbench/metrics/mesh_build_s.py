"""Host seconds of the mesh build (models/cavity.cavity_case: the box
generated and compiled on the host, moved to the card), timed by the
harness around the call."""

KERNELS = ()


def read(ctx):
    return ctx.mesh_build_s
