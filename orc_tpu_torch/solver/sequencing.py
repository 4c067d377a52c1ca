"""Mesh sequencing (grid continuation) for steady solves (port of
orc_tpu/solver/sequencing.py).

A cold-started steady SIMPLE run on a fine grid spends O(1e5) outer
iterations spinning up the large-scale flow, because the effective
pseudo-timestep shrinks with the cell size. Converging on a coarse grid
first and prolonging the state up a cascade of refinements reaches the
same state in far fewer fine-grid iterations; it is how users reach
256^2-1024^2 cavities.

Host orchestration over `solve_steady`: each level's mesh comes from the
user's `case_builder`, and the state is prolonged with piecewise-
constant upsampling on the state's device. The SIMPLE_FC stored flux is
dropped at each prolongation, so every level seeds its own.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from orc_tpu_torch.solver.simple import FlowState, initial_state, solve_steady


def upsample_field(
    arr: torch.Tensor,
    dims_from: Tuple[int, int, int],
    dims_to: Tuple[int, int, int],
) -> torch.Tensor:
    """Piecewise-constant prolongation of a [C(,d)] cell field between
    structured boxes (cell id = i + nx*(j + ny*k)); each target dim must
    be an integer multiple of its source dim."""
    feat = tuple(arr.shape[1:])
    nxf, nyf, nzf = dims_from
    nxt, nyt, nzt = dims_to
    if arr.shape[0] != nxf * nyf * nzf:
        raise ValueError(
            f"field has {arr.shape[0]} cells, dims_from gives {nxf * nyf * nzf}"
        )
    for t, f in zip(dims_to, dims_from):
        if t % f:
            raise ValueError(
                f"target dims {dims_to} must be multiples of source dims "
                f"{dims_from}"
            )
    a = arr.reshape(nzf, nyf, nxf, *feat)
    a = torch.repeat_interleave(a, nzt // nzf, dim=0)
    a = torch.repeat_interleave(a, nyt // nyf, dim=1)
    a = torch.repeat_interleave(a, nxt // nxf, dim=2)
    return a.reshape((nxt * nyt * nzt,) + feat)


def prolong_state(state: FlowState, dims_from, dims_to) -> FlowState:
    """The state on the finer box; the SIMPLE_FC flux is not carried."""
    return FlowState(
        vel=upsample_field(state.vel, dims_from, dims_to),
        p=upsample_field(state.p, dims_from, dims_to),
        # mom_diag is component-major [3,C]: upsample the cell axis.
        mom_diag=upsample_field(state.mom_diag.T, dims_from, dims_to).T.contiguous(),
    )


def solve_steady_sequenced(
    case_builder: Callable,
    dims_schedule: Sequence[Tuple[int, int, int]],
    settings,
    rho: float,
    mu: float,
    iterations_per_level: int = 4000,
    final_iterations: Optional[int] = None,
    reporting_interval: int = 1000,
    verbose: bool = True,
    **solve_kwargs,
):
    """Run the steady solve up a grid cascade.

    `case_builder(nx, ny, nz) -> (mesh, table)` builds each level;
    `dims_schedule` runs coarse -> fine, each dim an integer multiple of
    the previous. Returns (FlowState on the finest grid, per-level
    history list)."""
    if final_iterations is None:
        final_iterations = iterations_per_level
    state = None
    histories = []
    prev_dims = None
    for li, dims in enumerate(dims_schedule):
        mesh, table = case_builder(*dims)
        if state is None:
            state = initial_state(mesh)
        else:
            state = prolong_state(state, prev_dims, dims)
        iters = (
            final_iterations
            if li + 1 == len(dims_schedule)
            else iterations_per_level
        )
        if verbose:
            print(f"[sequenced] level {dims}: {iters} iterations")
        state, h = solve_steady(
            mesh, table, settings, rho, mu,
            state=state, iterations=iters,
            reporting_interval=min(reporting_interval, iters),
            verbose=verbose, **solve_kwargs,
        )
        histories.append(h)
        prev_dims = dims
    return state, histories
