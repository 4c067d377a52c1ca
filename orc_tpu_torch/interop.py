"""Carry meshes, slice plans, flow and turbulence states across from numpy
arrays.

Tests use these to feed a mesh or a state produced by the JAX package
into the port: convert the JAX arrays with ``numpy.asarray`` and pass
them here, with the device named. Integer, boolean and float arrays keep
their numpy dtypes (orc_tpu's int32 indices and bool masks map onto the
port's).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orc_tpu_torch.mesh.compile import CompiledMesh
from orc_tpu_torch.mesh.nodes import NodeInterp
from orc_tpu_torch.mesh.reorder import SlicePlan
from orc_tpu_torch.solver.simple import FlowState
from orc_tpu_torch.solver.turbulence import TurbState

#: The tensor fields every CompiledMesh has.
MESH_FIELDS = tuple(
    f.name
    for f in dataclasses.fields(CompiledMesh)
    if f.name
    not in (
        "dim", "neighbor_offsets", "ck_constants", "nodes", "cell_order",
        "slice_plan",
    )
)
#: The tables of a NodeInterp (mesh/nodes.py).
NODE_TABLES = ("node_cells", "node_w", "face_nodes", "face_node_w")
#: The index tables of a SlicePlan and its sizes.
PLAN_TABLES = ("starts", "col_of", "tile_nj", "col_tile")
PLAN_SIZES = ("tile", "n_max", "pad_lo", "pad_hi", "n_cells", "j0", "n_heavy")


def _tensor(a, device):
    """A copy of `a` on `device` (numpy views of JAX arrays are
    read-only, so the tensor must not share their memory)."""
    return torch.tensor(np.asarray(a), device=device)


def slice_plan_from_numpy(fields: dict, *, device) -> SlicePlan:
    """SlicePlan on `device` from a dict holding its index tables as
    numpy arrays (PLAN_TABLES, all required; orc_tpu builds col_tile
    with `build_col_tile=True`) and its sizes (PLAN_SIZES; j0 and
    n_heavy default to 0)."""
    missing = [name for name in PLAN_TABLES if fields.get(name) is None]
    if missing:
        raise KeyError(f"slice plan tables missing: {missing}")
    return SlicePlan(
        **{name: _tensor(fields[name], device) for name in PLAN_TABLES},
        **{name: int(fields.get(name, 0)) for name in PLAN_SIZES},
    )


def node_interp_from_numpy(fields: dict, *, device) -> NodeInterp:
    """NodeInterp on `device` from a dict holding its four tables
    (NODE_TABLES) as numpy arrays."""
    missing = [name for name in NODE_TABLES if fields.get(name) is None]
    if missing:
        raise KeyError(f"node tables missing: {missing}")
    return NodeInterp(**{name: _tensor(fields[name], device) for name in NODE_TABLES})


def compiled_mesh_from_numpy(
    fields: dict,
    neighbor_offsets: tuple | None,
    ck_constants: tuple | None,
    dim: int = 3,
    *,
    device,
    cell_order=None,
    slice_plan: SlicePlan | None = None,
    nodes: NodeInterp | None = None,
) -> CompiledMesh:
    """CompiledMesh on `device` from a dict holding every tensor field
    as a numpy array, plus the static `neighbor_offsets` and
    `ck_constants`, for irregular meshes the numpy `cell_order` and a
    `slice_plan` (see slice_plan_from_numpy), and for node-based
    Green-Gauss the vertex tables `nodes` (see node_interp_from_numpy)."""
    missing = set(MESH_FIELDS) - set(fields)
    if missing:
        raise KeyError(f"mesh fields missing: {sorted(missing)}")
    return CompiledMesh(
        **{name: _tensor(fields[name], device) for name in MESH_FIELDS},
        dim=dim,
        neighbor_offsets=None if neighbor_offsets is None else tuple(
            int(d) for d in neighbor_offsets
        ),
        ck_constants=ck_constants,
        nodes=None if nodes is None else nodes.to(device),
        cell_order=None if cell_order is None else _tensor(cell_order, device),
        slice_plan=None if slice_plan is None else slice_plan.to(device),
    )


def flow_state_from_numpy(vel, p, mom_diag, flux=None, *, device) -> FlowState:
    """FlowState on `device` from numpy vel [C,3], p [C], mom_diag [3,C]
    and, when given, the SIMPLE_FC flux in either shape: [F] per face
    (the face-major step) or [C,K] per (cell, slot) (the (c,k) step)."""
    return FlowState(
        vel=_tensor(vel, device),
        p=_tensor(p, device),
        mom_diag=_tensor(mom_diag, device),
        flux=None if flux is None else _tensor(flux, device),
    )


def flow_states_from_numpy(vel, p, mom_diag, *, devices) -> list:
    """One FlowState per partition from orc_tpu's stacked local layout:
    numpy vel [P,L,3], p [P,L] and mom_diag [P,3,L], partition q on
    devices[q] (parallel/sharded.py scatter_state)."""
    if not len(vel) == len(p) == len(mom_diag) == len(devices):
        raise ValueError("one vel, p, mom_diag and device per partition")
    return [
        flow_state_from_numpy(vel[q], p[q], mom_diag[q], device=dev)
        for q, dev in enumerate(devices)
    ]


def flow_states_to_numpy(states) -> tuple:
    """orc_tpu's stacked local layout of per-partition FlowStates:
    (vel [P,L,3], p [P,L], mom_diag [P,3,L]) as numpy."""

    def stack(name):
        return np.stack(
            [getattr(s, name).detach().cpu().numpy() for s in states]
        )

    return stack("vel"), stack("p"), stack("mom_diag")


def turb_state_from_numpy(k, eps, mu_t, *, device) -> TurbState:
    """TurbState on `device` from numpy k [C], eps [C] and mu_t [C]."""
    return TurbState(
        k=_tensor(k, device), eps=_tensor(eps, device), mu_t=_tensor(mu_t, device)
    )
