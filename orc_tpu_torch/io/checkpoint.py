"""Checkpoint / warm-start (port of orc_tpu/io/checkpoint.py).

The reference warm-starts from its text data file when one exists,
falling back to fresh initialization (tests.rs:84-86,195-197), with
cell order as the implicit schema and no mesh-consistency check. Here,
as in orc_tpu, checkpoints are compressed npz archives carrying a mesh
fingerprint, so a checkpoint is never silently applied to a different
mesh, plus the same text-format warm-start path.

The archives hold exactly orc_tpu's keys (vel, p, mom_diag, iteration,
mesh_fingerprint; flux and turb_k / turb_eps / turb_mu_t when present)
and the fingerprint hashes the same bytes, so each package reads the
other's checkpoints.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np
import torch

from orc_tpu_torch.interop import flow_state_from_numpy, turb_state_from_numpy
from orc_tpu_torch.mesh.compile import CompiledMesh
from orc_tpu_torch.solver.simple import FlowState

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _host(a) -> np.ndarray:
    """numpy copy of a tensor at its own dtype."""
    return a.detach().cpu().numpy()


def _as_component_major(md: np.ndarray, n_cells: int) -> np.ndarray:
    """FlowState.mom_diag is component-major [3,C]; checkpoints written
    before that layout change stored [C,3]. Detect and transpose (the
    C==3 case is ambiguous but a 3-cell mesh is not a real workload)."""
    if md.ndim == 2 and md.shape[0] == n_cells and md.shape[1] == 3:
        return np.moveaxis(md, 0, -1)
    return md


def mesh_fingerprint(mesh: CompiledMesh) -> str:
    """16 hex digits of the SHA-256 of the cell and face counts and the
    cell centroids as float64 (widened on the host from a float32
    mesh), the bytes orc_tpu hashes."""
    h = hashlib.sha256()
    h.update(np.int64(mesh.n_cells).tobytes())
    h.update(np.int64(mesh.n_faces).tobytes())
    h.update(np.asarray(_host(mesh.cell_centroid), dtype=np.float64).tobytes())
    return h.hexdigest()[:16]


def save_checkpoint(
    path, mesh: CompiledMesh, state: FlowState, iteration=0, turb=None
):
    """`turb` (solver.turbulence.TurbState) is included when given so
    RANS runs resume their k/eps/mu_t fields too."""
    extra = {}
    if turb is not None:
        extra = dict(
            turb_k=_host(turb.k),
            turb_eps=_host(turb.eps),
            turb_mu_t=_host(turb.mu_t),
        )
    if state.flux is not None:
        # SIMPLE_FC conservative stored flux ([C,K] on the (c,k) step,
        # [F] face-major): resuming WITHOUT it would re-seed from an
        # interpolation and lose exact conservation. The layout must
        # match the resuming run's step type; a mismatch fails loudly
        # on shape.
        extra["flux"] = _host(state.flux)
    np.savez_compressed(
        path,
        vel=_host(state.vel),
        p=_host(state.p),
        mom_diag=_host(state.mom_diag),
        iteration=np.int64(iteration),
        mesh_fingerprint=np.bytes_(mesh_fingerprint(mesh).encode()),
        **extra,
    )


def load_checkpoint(path, mesh: CompiledMesh, with_turbulence=False):
    """Returns (FlowState, iteration), or (FlowState, TurbState|None,
    iteration) with `with_turbulence=True`, on the mesh's device in its
    dtype. Raises ValueError on a mesh mismatch."""
    dt, dev = _NP_DTYPE[mesh.dtype], mesh.device
    with np.load(path) as z:
        fp = bytes(z["mesh_fingerprint"]).decode()
        if fp != mesh_fingerprint(mesh):
            raise ValueError(
                f"checkpoint {path} was written for a different mesh "
                f"(fingerprint {fp})"
            )
        state = flow_state_from_numpy(
            z["vel"].astype(dt),
            z["p"].astype(dt),
            # Back-compat: checkpoints written before the component-
            # major FlowState layout store mom_diag as [C,3].
            _as_component_major(z["mom_diag"].astype(dt), mesh.n_cells),
            z["flux"].astype(dt) if "flux" in z else None,
            device=dev,
        )
        if not with_turbulence:
            return state, int(z["iteration"])
        turb = None
        if "turb_k" in z:
            turb = turb_state_from_numpy(
                z["turb_k"].astype(dt),
                z["turb_eps"].astype(dt),
                z["turb_mu_t"].astype(dt),
                device=dev,
            )
        return state, turb, int(z["iteration"])


def load_or_initialize(
    path: Optional[str],
    mesh: CompiledMesh,
    table,
    mu: float,
    rho: float,
) -> FlowState:
    """Warm-start semantics of the reference harness (tests.rs:84-86):
    resume from `path` if it exists (npz checkpoint or reference-format
    text data), else run field initialization."""
    from orc_tpu_torch.solver.init_fields import initialize_flow

    if path and os.path.exists(path):
        if path.endswith(".npz"):
            state, _ = load_checkpoint(path, mesh)
            return state
        from orc_tpu_torch.io.data import read_data

        vel, p = read_data(path)
        if vel.shape[0] != mesh.n_cells:
            raise ValueError(
                f"data file {path} has {vel.shape[0]} cells, mesh has "
                f"{mesh.n_cells}"
            )
        if mesh.cell_order is not None:
            # Text files are in raw-mesh cell order (the format's
            # implicit schema, io.rs:519-571); map into the compiled
            # (RCM) order: compiled[i] = raw[cell_order[i]].
            order = _host(mesh.cell_order)
            vel, p = vel[order], p[order]
        dt = _NP_DTYPE[mesh.dtype]
        return flow_state_from_numpy(
            vel.astype(dt),
            p.astype(dt),
            np.ones((3, mesh.n_cells), dt),
            device=mesh.device,
        )
    return initialize_flow(mesh, table, mu, rho)
