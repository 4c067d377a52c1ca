"""Divergence recovery (port of orc_tpu/solver/recovery.py).

Divergence is a structured signal (`SolverDivergedError`): keep the last
healthy state and, on divergence, restart from it with the relaxation
factors backed off.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from orc_tpu_torch.solver.simple import (
    FlowState,
    SolverDivergedError,
    initial_state,
    solve_steady,
)
from orc_tpu_torch.utils.settings import NumericalSettings


def solve_steady_with_recovery(
    mesh,
    table,
    settings: NumericalSettings,
    rho: float,
    mu: float,
    state: Optional[FlowState] = None,
    iterations: int = 100,
    reporting_interval: int = 10,
    max_retries: int = 3,
    relaxation_backoff: float = 0.5,
    verbose: bool = True,
):
    """solve_steady with automatic divergence recovery.

    Returns (state, history, recovery_log). Each retry restarts from the
    last state that completed a reporting chunk without divergence, with
    the momentum, pressure and inner-solver relaxation scaled by
    `relaxation_backoff`."""
    if state is None:
        state = initial_state(mesh)
    recovery_log = []
    history = []
    remaining = iterations
    good_state = state
    attempt = 0
    while remaining > 0:
        try:
            chunk = min(remaining, max(reporting_interval, 1))
            new_state, h = solve_steady(
                mesh,
                table,
                settings,
                rho,
                mu,
                state=good_state,
                iterations=chunk,
                reporting_interval=reporting_interval,
                verbose=verbose,
            )
            good_state = new_state
            history.extend(h)
            remaining -= chunk
        except SolverDivergedError as e:
            attempt += 1
            if attempt > max_retries:
                raise
            settings = dataclasses.replace(
                settings,
                momentum_relaxation=settings.momentum_relaxation
                * relaxation_backoff,
                pressure_relaxation=settings.pressure_relaxation
                * relaxation_backoff,
                # The inner solver's relaxation can itself be the source
                # of the divergence (e.g. over-relaxed Jacobi).
                matrix_solver=dataclasses.replace(
                    settings.matrix_solver,
                    relaxation=settings.matrix_solver.relaxation
                    * relaxation_backoff,
                ),
            )
            recovery_log.append(
                dict(
                    at_iteration=iterations - remaining,
                    error=str(e),
                    momentum_relaxation=settings.momentum_relaxation,
                    pressure_relaxation=settings.pressure_relaxation,
                )
            )
            if verbose:
                print(
                    f"[recovery] diverged; retry {attempt}/{max_retries} "
                    f"from last good state with relaxation "
                    f"({settings.momentum_relaxation:.3g}, "
                    f"{settings.pressure_relaxation:.3g})"
                )
    return good_state, history, recovery_log
