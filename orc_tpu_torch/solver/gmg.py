"""Structured geometric multigrid (port of the single-device half of
orc_tpu/solver/gmg.py).

On a structured box mesh coarsening is 2x per axis (block aggregation),
so every level is itself a structured box and every smoother SpMV stays
on the shift path: on the card each smoother iteration on each level is
kernel 1 (`shift_spmv`). Restriction and prolongation are reshapes,
block sums and broadcasts; the Galerkin coarse matrix R A P is computed
per solve from the fine ELL coefficients with parity masks (in-block
entries fold into the coarse diagonal, cross-block entries into the
matching coarse offset column), with no scatter. Periodic wrap offsets,
odd extents (zero-padded blocks) and non-coarsenable axes (block size 1)
are supported.

The hierarchy is a tuple of frozen `GmgLevel`s, host-side descriptions
without tensors. Smoothing is the reference's Jacobi-preconditioned
BiCGSTAB per level (solver/amg.py `_smooth`). Vectors may carry leading
batch dimensions ([..., C]), so the three momentum systems can share one
cycle, as orc_tpu's vmapped cycle does. Meshes whose offsets do not
describe a coarsenable box take the algebraic hierarchy of
solver/amg.py (`build_mg_hierarchy`). The sharded V-cycle waits for the
port's sharded runtime (ROADMAP Queue 1, item 14).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from orc_tpu_torch.ops.spmv import EllMatrix
from orc_tpu_torch.solver.amg import _coarse_project, _smooth
from orc_tpu_torch.solver.krylov import SolveInfo, _max_abs, _norm
from orc_tpu_torch.utils.settings import MatrixSolverSettings


def infer_box_dims(
    offsets: Tuple[int, ...], n_cells: int
) -> Optional[Tuple[int, int, int]]:
    """Recover (nx, ny, nz) of a structured box from its neighbor
    offsets (cell id = ix + nx*(iy + ny*iz)).

    Interior steps contribute +/-{1, nx, nx*ny}; periodic wraps
    contribute -/+{nx-1, nx*(ny-1), nx*ny*(nz-1)}. Returns None when no
    consistent box exists (irregular mesh)."""
    pos = sorted({abs(int(d)) for d in offsets if d != 0})
    if not pos:
        return None
    # Candidate nx values: every offset magnitude o could be nx (step)
    # or o+1 could be nx (wrap nx-1); nx=1 covers 1-cell-wide axes.
    cands_x = {1}
    for o in pos:
        cands_x.add(o)
        cands_x.add(o + 1)
    for nx in sorted(cands_x):
        if nx < 1 or n_cells % nx:
            continue
        rest = n_cells // nx
        cands_y = {1}
        for o in pos:
            if o % nx == 0:
                cands_y.add(o // nx)
                cands_y.add(o // nx + 1)
        for ny in sorted(cands_y):
            if ny < 1 or rest % ny:
                continue
            nz = rest // ny
            allowed = {1, nx, nx * ny} | {
                nx - 1,
                nx * (ny - 1),
                nx * ny * (nz - 1),
            }
            allowed.discard(0)
            if set(pos) <= allowed:
                return (nx, ny, nz)
    return None


def _classify_columns(offsets, dims):
    """Per ELL column: None (padding) or (axis, direction, wrap); None
    for the whole tuple when an offset fits no box step or wrap."""
    nx, ny, nz = dims
    table = {}
    for axis, (step, n_ax) in enumerate(((1, nx), (nx, ny), (nx * ny, nz))):
        if n_ax <= 1:
            continue
        table[step] = (axis, +1, False)
        table[-step] = (axis, -1, False)
        wrap = step * (n_ax - 1)
        # +direction wrap: last cell -> first = NEGATIVE flat delta.
        table.setdefault(-wrap, (axis, +1, True))
        table.setdefault(wrap, (axis, -1, True))
    out = []
    for d in offsets:
        out.append(table.get(int(d)))
        if int(d) != 0 and table.get(int(d)) is None:
            return None  # unclassifiable offset: not a plain box
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class GmgLevel:
    """Static description of one fine->coarse transfer (no tensors)."""

    dims: Tuple[int, int, int]  # fine (nx, ny, nz)
    cdims: Tuple[int, int, int]  # coarse
    block: Tuple[int, int, int]  # 1 or 2 per axis
    pdims: Tuple[int, int, int]  # fine padded to block*cdims
    fine_offsets: Tuple[int, ...]  # fine ELL column offsets
    col_info: Tuple  # per fine column: None | (axis, dir, wrap)
    coarse_offsets: Tuple[int, ...]  # coarse ELL column offsets
    # per fine column: index into coarse_offsets, -1 = coarse diagonal,
    # -2 = padding column (zero coefficients, skipped)
    coarse_col_of: Tuple[int, ...]

    @property
    def n_coarse(self) -> int:
        cx, cy, cz = self.cdims
        return cx * cy * cz


def _coarse_delta(axis, direction, wrap, cdims):
    nx, ny, _ = cdims
    stride = (1, nx, nx * ny)[axis]
    n_ax = cdims[axis]
    if n_ax == 1:
        return 0  # folds into the coarse diagonal
    if wrap:
        return -direction * stride * (n_ax - 1)
    return direction * stride


def build_level(dims, offsets) -> Optional[GmgLevel]:
    col_info = _classify_columns(offsets, dims)
    if col_info is None:
        return None
    wraps = [False, False, False]
    for info in col_info:
        if info is not None and info[2]:
            wraps[info[0]] = True
    block = []
    for axis, n_ax in enumerate(dims):
        if n_ax < 2:
            block.append(1)
        elif wraps[axis] and n_ax % 2:
            # Odd periodic axis: zero-padding would break the wrap
            # adjacency; leave the axis uncoarsened.
            block.append(1)
        else:
            block.append(2)
    if all(b == 1 for b in block):
        return None
    cdims = tuple(-(-n // b) for n, b in zip(dims, block))
    pdims = tuple(c * b for c, b in zip(cdims, block))

    coarse_offsets: List[int] = []
    coarse_col_of: List[int] = []
    for info in col_info:
        if info is None:
            coarse_col_of.append(-2)
            continue
        delta = _coarse_delta(*info, cdims)
        if delta == 0:
            coarse_col_of.append(-1)
            continue
        if delta not in coarse_offsets:
            coarse_offsets.append(delta)
        coarse_col_of.append(coarse_offsets.index(delta))
    return GmgLevel(
        dims=tuple(dims),
        cdims=cdims,
        block=tuple(block),
        pdims=pdims,
        fine_offsets=tuple(int(d) for d in offsets),
        col_info=col_info,
        coarse_offsets=tuple(coarse_offsets),
        coarse_col_of=tuple(coarse_col_of),
    )


def build_gmg_hierarchy(
    dims: Tuple[int, int, int],
    offsets: Tuple[int, ...],
    solver: MatrixSolverSettings,
) -> Optional[Tuple[GmgLevel, ...]]:
    """Level stack down to `multigrid_coarsest_size` cells (or
    `multigrid_levels`, whichever limit hits first); None when the box
    cannot be coarsened."""
    levels: List[GmgLevel] = []
    cur_dims, cur_offsets = tuple(dims), tuple(offsets)
    for _ in range(solver.multigrid_levels):
        n = cur_dims[0] * cur_dims[1] * cur_dims[2]
        if n <= solver.multigrid_coarsest_size:
            break
        lvl = build_level(cur_dims, cur_offsets)
        if lvl is None:
            break
        levels.append(lvl)
        cur_dims = lvl.cdims
        cur_offsets = lvl.coarse_offsets
    return tuple(levels) if levels else None


def build_mg_hierarchy(mesh, diff, settings):
    """The hierarchy of `SolutionMethod.MULTIGRID`: geometric when the
    mesh's neighbor offsets describe a box that coarsens, algebraic
    (solver/amg.py, aggregated on the diffusion system `diff`)
    otherwise, as orc_tpu chooses."""
    if mesh.neighbor_offsets is not None:
        dims = infer_box_dims(mesh.neighbor_offsets, mesh.n_cells)
        if dims is not None:
            h = build_gmg_hierarchy(
                dims, mesh.neighbor_offsets, settings.matrix_solver
            )
            if h:
                return h
    from orc_tpu_torch.solver.amg import build_hierarchy

    return build_hierarchy(mesh, diff, settings.matrix_solver)


# --- per-level transfer ops (reshapes of [..., C] vectors) -------------


def _grid(x, dims):
    nx, ny, nz = dims
    return x.reshape(*x.shape[:-1], nz, ny, nx)


def _pad(a, dims, pdims):
    if dims == pdims:
        return a
    return F.pad(
        a,
        (0, pdims[0] - dims[0], 0, pdims[1] - dims[1], 0, pdims[2] - dims[2]),
    )


def restrict(r, level: GmgLevel):
    """Aggregate fine cells into their 2x2x2 (or smaller) blocks."""
    bx, by, bz = level.block
    cx, cy, cz = level.cdims
    batch = r.shape[:-1]
    a = _pad(_grid(r, level.dims), level.dims, level.pdims)
    a = a.reshape(*batch, cz, bz, cy, by, cx, bx).sum(dim=(-5, -3, -1))
    return a.reshape(*batch, -1)


def prolong(e, level: GmgLevel):
    """Piecewise-constant interpolation back to the fine grid."""
    bx, by, bz = level.block
    cx, cy, cz = level.cdims
    nx, ny, nz = level.dims
    batch = e.shape[:-1]
    a = e.reshape(*batch, cz, 1, cy, 1, cx, 1).expand(
        *batch, cz, bz, cy, by, cx, bx
    ).reshape(*batch, cz * bz, cy * by, cx * bx)
    return a[..., :nz, :ny, :nx].reshape(*batch, -1)


def _cross_mask(level: GmgLevel, axis: int, direction: int, dtype, device):
    """[C] 1.0 where a (non-wrap) step along `axis` leaves the cell's
    block: the high cell of each 2-block for +steps, the low cell for
    -steps."""
    nx, ny, nz = level.dims
    shape = [1, 1, 1]  # [nz, ny, nx] layout
    shape[2 - axis] = level.dims[axis]
    idx = torch.arange(level.dims[axis], device=device).reshape(shape)
    cross = (idx % 2) == (1 if direction > 0 else 0)
    return cross.expand(nz, ny, nx).reshape(-1).to(dtype)


def galerkin(A: EllMatrix, level: GmgLevel) -> EllMatrix:
    """Coarse matrix A_c = R A P for R = block sum, P = block copy:
    per-column masked block sums, no scatter. `A.off` is one [C,K]
    array (or view); the coarse `off` is a [C_c, K_c] view of K_c
    contiguous planes, which split_columns hands to the SpMV kernel
    without a copy."""
    cdiag = restrict(A.diag, level)
    coff = [None] * len(level.coarse_offsets)

    def acc(slot, v):
        coff[slot] = v if coff[slot] is None else coff[slot] + v

    for k, info in enumerate(level.col_info):
        tgt = level.coarse_col_of[k]
        if tgt == -2:
            continue  # structurally-zero padding column
        coeff = A.off[..., k]
        axis, direction, wrap = info
        if tgt == -1:
            cdiag = cdiag + restrict(coeff, level)
            continue
        if wrap or level.block[axis] == 1:
            acc(tgt, restrict(coeff, level))
            continue
        cross = _cross_mask(level, axis, direction, coeff.dtype, coeff.device)
        acc(tgt, restrict(coeff * cross, level))
        cdiag = cdiag + restrict(coeff * (1.0 - cross), level)

    n_c = level.n_coarse
    zero = torch.zeros((), dtype=cdiag.dtype, device=cdiag.device)
    cols = [c if c is not None else zero.expand(n_c) for c in coff]
    # Blocks that are entirely padding get identity rows (their
    # restricted residual is 0, so the correction stays 0).
    cdiag = torch.where(cdiag == 0.0, torch.ones_like(cdiag), cdiag)
    off = (
        torch.stack(cols, dim=0).T
        if cols
        else torch.zeros((n_c, 0), dtype=cdiag.dtype, device=cdiag.device)
    )
    return EllMatrix(
        diag=cdiag, off=off, neighbors=None, offsets=level.coarse_offsets
    )


def gmg_solve(
    A: EllMatrix,
    b,
    x0,
    settings: MatrixSolverSettings,
    hierarchy: Tuple[GmgLevel, ...],
    project=None,
    null_scale=None,
):
    """One V-cycle with BiCGSTAB smoothing, the reference's multigrid
    iteration (linear_algebra.rs:65-141): smooth, coarse-grid
    correction (recursive), post-smooth on the way up. Coarse matrices
    are re-Galerkined per call (the coefficients change every outer
    iteration; the transfer structure does not).

    `project` / `null_scale`: constant-nullspace deflation of singular
    (unanchored) pressure systems, `project` on the fine level and a
    plain-mean projection built from `null_scale` on the coarse ones."""
    x, info0 = _smooth(A, b, x0, settings, project=project)
    if hierarchy:
        r = b - A.matvec(x)
        x = x + _gmg_correction(
            A, r, 0, settings, hierarchy, project=_coarse_project(null_scale)
        )
        x, _ = _smooth(A, b, x, settings, project=project)
    rn = _norm(b - A.matvec(x))
    diverged = torch.isnan(rn) | (_max_abs(x) > 1e10)
    return x, SolveInfo(
        iterations=info0.iterations, residual=rn, diverged=diverged
    )


def _gmg_correction(A_f, r, idx, settings, hierarchy, project=None):
    level = hierarchy[idx]
    r_c = restrict(r, level)
    A_c = galerkin(A_f, level)
    coarsest = idx + 1 == len(hierarchy)
    e_c, _ = _smooth(
        A_c,
        r_c,
        torch.zeros_like(r_c),
        settings,
        iterations=settings.iterations if coarsest else None,
        project=project,
    )
    if not coarsest:
        rr = r_c - A_c.matvec(e_c)
        e_c = e_c + _gmg_correction(
            A_c, rr, idx + 1, settings, hierarchy, project=project
        )
        e_c, _ = _smooth(A_c, r_c, e_c, settings, project=project)
    return prolong(e_c, level)
