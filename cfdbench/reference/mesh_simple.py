"""One iteration of the SIMPLE (parity) coupling on any face list, in
plain torch (reference/mesh.py): the configured face velocities, the
momentum system, the fixed-count smoother, the p' system, and the
cell-difference correction (orc_tpu_torch/solver/simple.py
`simple_step`, face-major)."""

from __future__ import annotations

import torch

from cfdbench.reference import box as fv
from cfdbench.reference import mesh as fm

HAS_FLUX = False


def _flux(m, prm, vel, p, grad_p, md):
    return fm.face_flux(m, vel, prm["velocity_interpolation"], p, grad_p, md)


def predict(m, prm, state):
    """Everything of the iteration up to the pressure solve: the
    momentum system, the smoothed velocities u*, the p' system."""
    vel, p = state["vel"], state["p"]
    grad_p = fm.grad_scalar(m, p) if prm["velocity_interpolation"] == "rhie_chow" else None
    grad_v = fm.grad_velocity(m, vel) if prm["momentum"] != "ud" else None
    mom = fm.momentum_system(m, prm, vel, p, _flux(m, prm, vel, p, grad_p, state["md"]), grad_v)
    ustar = fm.jacobi_smooth(mom, vel, prm["sweeps"], prm["omega"])
    md = mom.diag.expand(3, -1)
    psys = fm.simple_pressure_system(m, _flux(m, prm, ustar, p, grad_p, md), md, prm["rho"])
    return dict(mom=mom, ustar=ustar, psys=psys)


def solution_from_output(prm, state, p_out):
    """The p' that the output pressure p + alpha_p p' implies."""
    return (p_out - state["p"]) / prm["alpha_p"]


def correction(m, prm, state, pred, sol):
    return fm.velocity_correction(m, sol, pred["mom"].diag, face_value=False)


def solve(m, prm, state, pred):
    """The reference's own p' solve (BiCGSTAB from zero; every boundary
    face anchors the p' system)."""
    return fv.bicgstab(
        pred["psys"], torch.zeros_like(state["p"]), prm["solver_iterations"],
        prm["solver_threshold"], lambda x: x,
    )


def finish(m, prm, state, pred, sol):
    """The iteration's output state from the p' solution."""
    return dict(
        vel=pred["ustar"] + correction(m, prm, state, pred, sol),
        p=state["p"] + prm["alpha_p"] * sol,
        md=pred["mom"].diag,
        flux=None,
    )
