"""One iteration of flux-corrected SIMPLE (SIMPLE_FC) on a uniform box,
in plain torch: momentum advected by the stored conservative face
velocities, the fixed-count smoother, the full-p system from the
Rhie-Chow predictor, the conservative flux update and the face-value
velocity correction of the relaxed increment (orc_tpu_torch/solver/fc.py
`simple_step_fc`, face-major)."""

from __future__ import annotations

from cfdbench.reference import box as fv

HAS_FLUX = True


def initial_flux(box, prm, state):
    """The seeded stored flux of a run that starts without one: the
    Rhie-Chow face velocities of the starting fields."""
    grad_p = fv.grad_scalar(box, state["p"])
    return fv.rhie_chow_flux(box, state["vel"], state["p"], grad_p, state["md"][0], True)


def predict(box, prm, state):
    """Everything up to the pressure solve: the momentum system, u*,
    the predictor flux_h, the coefficients d and the full-p system."""
    vel, p = state["vel"], state["p"]
    flux = state["flux"] if state["flux"] is not None else initial_flux(box, prm, state)
    grad_p = fv.grad_scalar(box, p)
    grad_v = fv.grad_velocity(box, vel)
    mom = fv.momentum_system(box, prm, vel, p, flux, grad_v)
    ustar = fv.jacobi_smooth(mom, vel, prm["sweeps"], prm["omega"])
    flux_h = fv.rhie_chow_flux(box, ustar, p, grad_p, mom.diag, False)
    d = fv.fc_coupling(box, mom.diag, prm["rho"])
    psys = fv.fc_pressure_system(box, flux_h, d, prm["rho"])
    return dict(mom=mom, ustar=ustar, flux_h=flux_h, d=d, psys=psys)


def solution_from_output(prm, state, p_out):
    """The unrelaxed new p that the output p + alpha_p (p_new - p)
    implies."""
    return state["p"] + (p_out - state["p"]) / prm["alpha_p"]


def correction(box, prm, state, pred, sol):
    dp = (sol - state["p"]) * prm["alpha_p"]
    return fv.velocity_correction(box, dp, pred["mom"].diag, face_value=True)


def new_flux(box, prm, pred, sol):
    return fv.correct_flux(box, pred["flux_h"], pred["d"], prm["rho"], sol)


def solve(box, prm, state, pred):
    """The reference's own full-p solve: BiCGSTAB warm-started from p,
    the constant mode deflated (no boundary anchors the pressure)."""
    return fv.bicgstab(
        pred["psys"], fv.deflate(state["p"]), prm["solver_iterations"],
        prm["solver_threshold"], fv.deflate,
    )


def finish(box, prm, state, pred, sol):
    """The iteration's output state from the new p."""
    return dict(
        vel=pred["ustar"] + correction(box, prm, state, pred, sol),
        p=state["p"] + (sol - state["p"]) * prm["alpha_p"],
        md=pred["mom"].diag,
        flux=new_flux(box, prm, pred, sol),
    )
