"""Carry meshes and flow states across from numpy arrays.

Tests use these to feed a state produced by the JAX package into the
port mid-trajectory: convert the JAX arrays with ``numpy.asarray`` and
pass them here. Integer, boolean and float arrays keep their numpy
dtypes (orc_tpu's int32 indices and bool masks map onto the port's).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orc_tpu_torch.mesh.compile import CompiledMesh
from orc_tpu_torch.solver.simple import FlowState

#: The tensor fields of CompiledMesh.
MESH_FIELDS = tuple(
    f.name
    for f in dataclasses.fields(CompiledMesh)
    if f.name not in ("dim", "neighbor_offsets", "ck_constants")
)


def _tensor(a, device):
    """A copy of `a` on `device` (numpy views of JAX arrays are
    read-only, so the tensor must not share their memory)."""
    return torch.tensor(np.asarray(a), device=device)


def compiled_mesh_from_numpy(
    fields: dict,
    neighbor_offsets: tuple | None,
    ck_constants: tuple | None,
    dim: int = 3,
    device: torch.device | str = "cpu",
) -> CompiledMesh:
    """CompiledMesh from a dict holding every tensor field as a numpy
    array, plus the static `neighbor_offsets` and `ck_constants`."""
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
    )


def flow_state_from_numpy(
    vel, p, mom_diag, flux=None, device: torch.device | str = "cpu"
) -> FlowState:
    """FlowState from numpy vel [C,3], p [C], mom_diag [3,C] (and the
    SIMPLE_FC flux, when given)."""
    return FlowState(
        vel=_tensor(vel, device),
        p=_tensor(p, device),
        mom_diag=_tensor(mom_diag, device),
        flux=None if flux is None else _tensor(flux, device),
    )
