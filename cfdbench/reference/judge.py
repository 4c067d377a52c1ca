"""The comparison that decides `correct`.

The reference follows the program one iteration at a time from the
program's own state: given the state an iteration of the timed path
started from and the state it produced, it recomputes that iteration in
float64 and reads the program's output layer by layer:

- `mom_diag`: the momentum matrix's relaxed diagonal, which the program
  hands on as FlowState.mom_diag, against the reference's (largest gap
  over the largest diagonal);
- `u_star`: the smoother's result. The program's output velocity minus
  the velocity correction of the pressure increment it applied is its
  u*; the gap to the reference's u* (over the largest |u*|) covers the
  momentum right-hand sides, the off-diagonals, the six sweeps and the
  correction;
- `p_residual`: the pressure solve. The output pressure implies the
  solve's solution (p' under SIMPLE, the new p under SIMPLE_FC); its
  residual in the reference's own pressure system, over |b|, covers the
  pressure system and the solve together;
- `flux` (SIMPLE_FC): the stored face velocities against the
  conservative update of the reference's predictor with the implied new
  p (over the largest face velocity).

A Krylov solve amplifies roundoff (two orders of the same sums end
1.1% apart after 50 iterations), so the solve is judged by what its
answer says, never by a reference solve of its own.

A run judges two blocks of BLOCK iterations: the first from the seeded
start, and BLOCK more after the window. Each number is its largest
reading over both, but the pressure solve's. A BiCGSTAB capped at 50
iterations returns its last iterate, and on one to three solves in a
hundred that iterate is a spike of its irregular convergence: the
residual falls to 0.008 of its start and the 50th step throws it to 0.2
or to 4 (the flagship cavity at ten million cells). So the solve is read
by the median over each block, which a spike moves only where most of
the block spikes: `p_residual_first` is the first block's median, where
a sound solve reads steadily from seed to seed; `p_residual` the larger
of the two blocks' medians. After the window a capped solve can end near
its warm start, so only the first block tells a solve that returns its
initial guess from a sound one.
"""

from __future__ import annotations

import importlib
import statistics

import torch

NUMBERS = ("mom_diag", "u_star", "p_residual_first", "p_residual", "flux")

#: The iterations judged in each block of a run.
BLOCK = 7


def coupling(name: str):
    """The reference module of a configuration (`reference` key)."""
    return importlib.import_module(f"cfdbench.reference.{name}")


def params(config: dict) -> dict:
    """The reference's parameters from a configuration file: the fluid
    and the numerics as the case file states them, and the smoother and
    solver settings the configuration lists under `reference`."""
    num, ref = config["numerics"], config["reference"]
    return dict(
        rho=float(config["fluid"]["rho"]),
        mu=float(config["fluid"]["mu"]),
        alpha_u=float(num["momentum_relaxation"]),
        alpha_p=float(num["pressure_relaxation"]),
        momentum=num["momentum"],
        sweeps=int(ref["momentum_sweeps"]),
        omega=float(ref["momentum_omega"]),
        solver_iterations=int(num["solver"]["iterations"]),
        solver_threshold=float(ref["solver_threshold"]),
        pressure_interpolation=num.get("pressure_interpolation", "second_order"),
        velocity_interpolation=num.get("velocity_interpolation", "rhie_chow"),
        relaxation_mode=num.get("relaxation_mode", "explicit"),
    )


def _max_abs(x):
    return float(torch.max(torch.abs(x)))


def _gap(a, b):
    return _max_abs(a - b) / max(_max_abs(b), 1e-300)


def judge(box, prm, mod, state, out) -> dict:
    """The numbers of one iteration: `state` the input, `out` the
    program's output, both in the reference layout and box.dtype."""
    pred = mod.predict(box, prm, state)
    diag = pred["mom"].diag
    nums = {"mom_diag": max(_gap(row, diag) for row in out["md"])}
    sol = mod.solution_from_output(prm, state, out["p"])
    ustar = out["vel"] - mod.correction(box, prm, state, pred, sol)
    nums["u_star"] = _gap(ustar, pred["ustar"])
    psys = pred["psys"]
    r = psys.b - psys.apply(sol)
    nums["p_residual"] = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(psys.b))
    if mod.HAS_FLUX and out["flux"] is None:
        nums["flux"] = float("inf")  # no stored flux where one is due
    elif mod.HAS_FLUX:
        ref = mod.new_flux(box, prm, pred, sol)
        scale = max(_max_abs(f) for f in ref)
        nums["flux"] = max(_max_abs(o - f) for o, f in zip(out["flux"], ref)) / scale
    return nums


def worst(first, last) -> dict:
    """The numbers of a run from the readings of its two blocks of
    iterations (lists of `judge` dicts): the largest reading of each over
    every iteration, but the pressure solve's by the median of each
    block, `p_residual_first` the first block's and `p_residual` the
    larger of the two."""
    readings = list(first) + list(last)
    top = {k: max(r[k] for r in readings) for k in readings[0]}
    med = [statistics.median(r["p_residual"] for r in b) for b in (first, last)]
    top["p_residual_first"], top["p_residual"] = med[0], max(med)
    return {k: top[k] for k in NUMBERS if k in top}


def control(box, prm, mod, state, dtype=torch.bfloat16) -> dict:
    """The reference put in the program's place at a lower precision:
    the iteration computed in `dtype` from `state`, its output in
    box.dtype. `box` is the reference's geometry, a Box or a Mesh."""
    low = box.to_dtype(dtype)

    def cast(v):
        if v is None:
            return None
        if isinstance(v, list):
            return [cast(x) for x in v]
        return v.to(dtype)

    s = {k: cast(v) for k, v in state.items()}
    pred = mod.predict(low, prm, s)
    out = mod.finish(low, prm, s, pred, mod.solve(low, prm, s, pred))
    back = {}
    for k, v in out.items():
        if v is None:
            back[k] = None
        elif isinstance(v, list):
            back[k] = [x.to(box.dtype) for x in v]
        else:
            back[k] = v.to(box.dtype)
    back["md"] = back["md"][None].expand(3, *back["md"].shape)
    return back
