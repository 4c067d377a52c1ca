"""Host seconds of the mesh build, timed by the harness around the call:
on a box cell models/cavity.cavity_case (the box generated and compiled
on the host, moved to the card); on a mesh case what a user pays to
read a TGRID file (utils/config.build_problem: the parse, reverse
Cuthill-McKee, the slice plan, the move to the card)."""

KERNELS = ()


def read(ctx):
    return ctx.mesh_build_s
