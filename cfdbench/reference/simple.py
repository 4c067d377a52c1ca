"""One iteration of the SIMPLE (parity) coupling on a uniform box, in
plain torch: linear face velocities, the momentum system, the
fixed-count smoother, the p' system, and the cell-difference correction
(orc_tpu_torch/solver/simple.py `simple_step`, face-major)."""

from __future__ import annotations

import torch

from cfdbench.reference import box as fv

HAS_FLUX = False


def predict(box, prm, state):
    """Everything of the iteration up to the pressure solve: the
    momentum system, the smoothed velocities u*, the p' system."""
    vel, p = state["vel"], state["p"]
    mom = fv.momentum_system(box, prm, vel, p, fv.linear_flux(vel))
    ustar = fv.jacobi_smooth(mom, vel, prm["sweeps"], prm["omega"])
    psys = fv.simple_pressure_system(box, fv.linear_flux(ustar), mom.diag, prm["rho"])
    return dict(mom=mom, ustar=ustar, psys=psys)


def solution_from_output(prm, state, p_out):
    """The p' that the output pressure p + alpha_p p' implies."""
    return (p_out - state["p"]) / prm["alpha_p"]


def correction(box, prm, state, pred, sol):
    return fv.velocity_correction(box, sol, pred["mom"].diag, face_value=False)


def solve(box, prm, state, pred):
    """The reference's own p' solve (BiCGSTAB from zero)."""
    return fv.bicgstab(
        pred["psys"], torch.zeros_like(state["p"]), prm["solver_iterations"],
        prm["solver_threshold"], lambda x: x,
    )


def finish(box, prm, state, pred, sol):
    """The iteration's output state from the p' solution."""
    return dict(
        vel=pred["ustar"] + correction(box, prm, state, pred, sol),
        p=state["p"] + prm["alpha_p"] * sol,
        md=pred["mom"].diag,
        flux=None,
    )
