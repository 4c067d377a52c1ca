"""Algebraic multigrid with a host-built, device-run hierarchy (port of
orc_tpu/solver/amg.py, single device).

The irregular part (greedy pairwise aggregation and the coarse sparsity)
runs once per mesh on the host in numpy, from the diffusion matrix as
the coupling-strength representative, and yields static index tables.
Per solve the device only:

- restricts residuals (a sum over each aggregate's fine cells),
- computes the coarse matrix values R A R^T (`galerkin_values`: every
  fine ELL entry lands in one flat coarse slot),
- smooths every level with Jacobi-preconditioned BiCGSTAB (`_smooth`;
  on the card the slice SpMV, kernel row 7, over each coarse level's
  slice plan, and on the fine level the shift SpMV on a box or the slice
  SpMV on an RCM-ordered mesh),
- prolongs corrections (a gather).

orc_tpu sums with `jax.ops.segment_sum`. A scatter-add on the card adds
in an order that changes from run to run, so here both sums are gathers
through host-built tables of source indices, in ascending source order,
added column by column: the card and the CPU give the same bits.
Aggregation strategies are the reference's RestrictionMethods: Injection
pairs consecutive cells; Strongest pairs each cell with its most
negatively coupled unmerged neighbour.

The sharded V-cycle (`multigrid_solve_sharded`) waits for the port's
sharded runtime (ROADMAP Queue 1, item 14).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from orc_tpu_torch.mesh.reorder import build_slice_plan
from orc_tpu_torch.ops.spmv import EllMatrix
from orc_tpu_torch.solver.krylov import (
    SolveInfo,
    _max_abs,
    _no_project,
    _norm,
    bicgstab_solve,
    constant_deflation,
)
from orc_tpu_torch.utils.device import resolve_device
from orc_tpu_torch.utils.settings import MatrixSolverSettings, RestrictionMethod


@dataclasses.dataclass(frozen=True)
class MgLevel:
    """One fine -> coarse transfer. orc_tpu's fields, then the two
    gather tables that replace its segment sums."""

    agg: torch.Tensor  # [n_fine] i32 fine -> coarse cell
    diag_target: torch.Tensor  # [n_fine] i32 flat coarse slot of fine diag
    off_target: torch.Tensor  # [n_fine*K_f] i32 flat coarse slot of fine offs
    coarse_neighbors: torch.Tensor  # [n_coarse, K_c] i32
    n_coarse: int
    k_coarse: int
    # Slice plan of the coarse matrix (mesh/reorder.py), without the
    # neighbour gather's table: nothing gathers neighbour values on a
    # coarse level. None when degenerate: that level's SpMV gathers.
    plan: "object | None" = None
    # [n_coarse, m_r] i64 fine cells of each aggregate, ascending, padded
    # with n_fine (a zero slot appended to the residual).
    restrict_src: "torch.Tensor | None" = dataclasses.field(default=None, repr=False)
    # [n_coarse*(K_c+1), m_g] i64 entries of [diag, off.flat] summed into
    # each flat coarse slot, ascending, padded with n_fine*(K_f+1).
    galerkin_src: "torch.Tensor | None" = dataclasses.field(default=None, repr=False)


def _aggregate(
    diag: np.ndarray,
    off: np.ndarray,
    neighbors: np.ndarray,
    method: RestrictionMethod,
) -> np.ndarray:
    """Greedy pairwise aggregation -> agg[n] coarse ids (0..n_c-1), in
    orc_tpu's loop order."""
    n, K = off.shape
    if method == RestrictionMethod.INJECTION:
        return np.arange(n, dtype=np.int64) // 2  # pairs (2i, 2i + 1)
    # Strongest: pair with the most negative off-diagonal neighbour.
    agg = [-1] * n
    nc = 0
    for i, (row, vals) in enumerate(zip(neighbors.tolist(), off.tolist())):
        if agg[i] >= 0:
            continue
        best = -1
        best_val = 0.0
        for j, v in zip(row, vals):
            if j == i or agg[j] >= 0:
                continue
            if v < best_val:
                best_val = v
                best = j
        agg[i] = nc
        if best >= 0:
            agg[best] = nc
        nc += 1
    return np.asarray(agg, dtype=np.int64)


def _coarse_structure(
    agg: np.ndarray, neighbors: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """The coarse ELL sparsity and flat slot targets, vectorised; equal as
    integers to orc_tpu's loops.

    Returns (coarse_neighbors [n_c,K_c], diag_target [n_f],
    off_target [n_f*K_f], K_c). Flat coarse layout: row I occupies
    slots [I*(K_c+1), (I+1)*(K_c+1)): slot 0 = diag, 1+k = off k, the
    off columns of a row in ascending coarse neighbour order."""
    n_f, K_f = neighbors.shape
    n_c = int(agg.max()) + 1
    I = np.broadcast_to(agg[:, None], (n_f, K_f))
    J = agg[neighbors]
    cross = J != I
    key = I * n_c + J
    pairs = np.unique(key[cross])  # sorted by I, then J
    pI, pJ = pairs // n_c, pairs % n_c
    first = np.searchsorted(pI, np.arange(n_c))
    slot = np.arange(len(pairs)) - first[pI]
    K_c = max(1, int(np.bincount(pI, minlength=n_c).max()) if len(pairs) else 0)
    coarse_neighbors = np.tile(np.arange(n_c)[:, None], (1, K_c))
    coarse_neighbors[pI, slot] = pJ

    stride = K_c + 1
    diag_target = agg * stride
    off_target = I * stride  # intra-aggregate entries fold into the diagonal
    off_target[cross] += 1 + slot[np.searchsorted(pairs, key[cross])]
    return coarse_neighbors, diag_target, off_target.reshape(-1), K_c


def _gather_table(target: np.ndarray, n_slots: int) -> np.ndarray:
    """[n_slots, m] sources of each slot (the positions i with
    target[i] == slot), ascending, padded with len(target)."""
    order = np.argsort(target, kind="stable")
    t = target[order]
    counts = np.bincount(target, minlength=n_slots)
    first = np.searchsorted(t, np.arange(n_slots))
    rank = np.arange(len(t)) - first[t]
    table = np.full((n_slots, max(1, int(counts.max()))), len(target), np.int64)
    table[t, rank] = order
    return table


def _gather_sum(v, table):
    """sum_j v[..., table[:, j]], added column by column (v's last entry
    is the zero of the padding): the same bits on the card and the CPU,
    at any thread count."""
    g = v[..., table]
    out = g[..., 0]
    for j in range(1, table.shape[1]):
        out = out + g[..., j]
    return out


def build_hierarchy(
    mesh,
    diff,
    solver: MatrixSolverSettings,
) -> List[MgLevel]:
    """The static AMG hierarchy from the (fixed) diffusion-matrix values
    as the coupling-strength representative, on the mesh's device."""
    return build_hierarchy_from_matrix(
        diff.diag.cpu().numpy(),
        diff.off.cpu().numpy(),
        mesh.cell_neighbors.cpu().numpy(),
        solver,
        device=mesh.device,
    )


def build_hierarchy_from_matrix(
    diag: np.ndarray,
    off: np.ndarray,
    neighbors: np.ndarray,
    solver: MatrixSolverSettings,
    device: torch.device | str = "cuda",
) -> List[MgLevel]:
    """Levels until `multigrid_levels` or `multigrid_coarsest_size`; each
    coarse level's representative matrix is the host Galerkin product of
    the one before."""
    device = resolve_device(device)
    diag = np.asarray(diag, dtype=np.float64)
    off = np.asarray(off, dtype=np.float64)
    neighbors = np.asarray(neighbors, dtype=np.int64)

    def i32(a):
        return torch.tensor(a, dtype=torch.int32, device=device)

    levels: List[MgLevel] = []
    for _ in range(solver.multigrid_levels):
        n = diag.shape[0]
        if n <= solver.multigrid_coarsest_size:
            break
        agg = _aggregate(diag, off, neighbors, solver.multigrid_restriction)
        coarse_neighbors, diag_t, off_t, K_c = _coarse_structure(agg, neighbors)
        n_c = int(agg.max()) + 1
        stride = K_c + 1
        plan = build_slice_plan(
            coarse_neighbors,
            coarse_neighbors != np.arange(n_c)[:, None],
            build_col_tile=False,
            device=device,
        )
        levels.append(
            MgLevel(
                agg=i32(agg),
                diag_target=i32(diag_t),
                off_target=i32(off_t),
                coarse_neighbors=i32(coarse_neighbors),
                n_coarse=n_c,
                k_coarse=K_c,
                plan=plan,
                restrict_src=torch.from_numpy(_gather_table(agg, n_c)).to(device),
                galerkin_src=torch.from_numpy(
                    _gather_table(np.concatenate([diag_t, off_t]), n_c * stride)
                ).to(device),
            )
        )
        # Host Galerkin product of the representative matrix for the next
        # level's aggregation decisions.
        flat = np.zeros(n_c * stride)
        np.add.at(flat, diag_t, diag)
        np.add.at(flat, off_t, off.reshape(-1))
        flat = flat.reshape(n_c, stride)
        diag, off, neighbors = flat[:, 0], flat[:, 1:], coarse_neighbors
    return levels


def _zero_pad(v):
    """v [..., n] with one zero appended, the padding slot of a table."""
    return torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)


def restrict(r, level: MgLevel):
    """r_c[I] = sum of r over aggregate I's fine cells. r: [..., n_fine]."""
    return _gather_sum(_zero_pad(r), level.restrict_src)


def galerkin_values(A: EllMatrix, level: MgLevel):
    """Coarse matrix values A_c = R A R^T: every fine entry summed into
    its flat coarse slot. A.diag [..., C], A.off [..., C, K] (one matrix
    or one per batch row)."""
    stride = level.k_coarse + 1
    batch = A.diag.shape[:-1]
    vals = torch.cat([A.diag, A.off.reshape(*batch, -1)], dim=-1)
    flat = _gather_sum(_zero_pad(vals), level.galerkin_src)
    flat = flat.reshape(*batch, level.n_coarse, stride)
    return EllMatrix(
        diag=flat[..., 0], off=flat[..., 1:], neighbors=level.coarse_neighbors,
        plan=level.plan,
    )


def _smooth(A, b, x0, settings: MatrixSolverSettings, iterations=None,
            project=None):
    """Per-level smoother: Jacobi-preconditioned BiCGSTAB (the
    reference's MULTIGRID_SMOOTHER, linear_algebra.rs:9), for
    `iterations` or else multigrid_smoother_iterations (falling back to
    settings.iterations). `project` is the constant-nullspace deflation
    hook of singular (unanchored) pressure systems."""
    if A.plan is not None:
        A = A.prepare()  # the slice SpMV for the whole smooth
    if A.offsets is not None:
        # The cycle keeps `off` as one array for the Galerkin products;
        # the columns are split once per smooth, outside the loop.
        A = A.split_columns()
    Ap, inv_d = A.jacobi_preconditioned()
    return bicgstab_solve(
        Ap,
        b * inv_d,
        x0,
        iterations
        if iterations is not None
        else (settings.multigrid_smoother_iterations or settings.iterations),
        convergence_threshold=settings.relative_convergence_threshold,
        compensated=settings.compensated_f32,
        project=project if project is not None else _no_project,
    )


def _coarse_project(null_scale):
    """Plain-mean constant deflation for the (all-active) coarse levels
    of a V-cycle; None when no deflation was requested. The coarse null
    vector is the constant: the Galerkin product with summing
    restriction and piecewise-constant prolongation gives
    A_c 1_c = R A P 1_c = R A 1_f = 0."""
    if null_scale is None:
        return None
    return constant_deflation(null_scale)


def multigrid_solve(
    A: EllMatrix,
    b,
    x0,
    settings: MatrixSolverSettings,
    hierarchy: List[MgLevel],
    project=None,
    null_scale=None,
):
    """orc_tpu's cycle (the reference's, linear_algebra.rs:65-141,
    270-296): smooth on the fine grid, then add the recursively computed
    coarse-grid correction, post-smoothing on the way up the coarse
    levels. b, x0: [..., C]."""
    x, info0 = _smooth(A, b, x0, settings, project=project)
    if hierarchy:
        r = b - A.matvec(x)
        x = x + _mg_correction(
            A, r, 0, settings, hierarchy, project=_coarse_project(null_scale)
        )
    rn = _norm(b - A.matvec(x))
    diverged = torch.isnan(rn) | (_max_abs(x) > 1e10)
    return x, SolveInfo(
        iterations=info0.iterations, residual=rn, diverged=diverged
    )


def multigrid_solve_sharded(*args, **kwargs):
    raise NotImplementedError(
        "the sharded AMG V-cycle waits for the port's sharded runtime "
        "(ROADMAP Queue 1, item 14)"
    )


def _mg_correction(A_f, r, level_idx, settings, hierarchy, project=None):
    level = hierarchy[level_idx]
    r_c = restrict(r, level)
    A_c = galerkin_values(A_f, level)
    # Coarsest level: solve accurately (it is tiny); intermediate levels
    # take smoother sweeps only.
    coarsest = level_idx + 1 == len(hierarchy)
    e_c, _ = _smooth(
        A_c, r_c, torch.zeros_like(r_c), settings,
        iterations=settings.iterations if coarsest else None,
        project=project,
    )
    if not coarsest:
        e_c = e_c + _mg_correction(
            A_c, r_c, level_idx + 1, settings, hierarchy, project=project
        )
        e_c, _ = _smooth(A_c, r_c, e_c, settings, project=project)
    return e_c[..., level.agg.long()]
