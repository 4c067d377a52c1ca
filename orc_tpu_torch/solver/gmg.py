"""Structured geometric multigrid (port of orc_tpu/solver/gmg.py).

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
solver/amg.py (`build_mg_hierarchy`).

The sharded V-cycle (`gmg_solve_sharded`) smooths the fine level
distributed and computes the coarse correction replicated: each
partition sums its owned rows' share of the first coarse matrix and
residual through host-built gather tables (amg.ShardedTables, in place
of orc_tpu's scatter-adds), and `axis_sum` adds the shares in partition
order.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

import numpy as np

from orc_tpu_torch.ops.spmv import EllMatrix
from orc_tpu_torch.solver.amg import (
    ShardedTables,
    _coarse_project,
    _smooth,
    cached_on,
)
from orc_tpu_torch.solver.krylov import (
    SolveInfo,
    _identity_sum,
    _max_abs,
    _mv,
    _norm,
)
from orc_tpu_torch.utils.profiling import span
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
    axis_sum=_identity_sum,
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
    x, info0 = _smooth(A, b, x0, settings, axis_sum, project=project)
    if hierarchy:
        r = b - A.matvec(x)
        x = x + _gmg_correction(
            A, r, 0, settings, hierarchy, axis_sum,
            project=_coarse_project(null_scale),
        )
        x, _ = _smooth(A, b, x, settings, axis_sum, project=project)
    rn = _norm(b - A.matvec(x), axis_sum)
    diverged = torch.isnan(rn) | (_max_abs(x) > 1e10)
    return x, SolveInfo(
        iterations=info0.iterations, residual=rn, diverged=diverged
    )


def _gmg_correction(A_f, r, idx, settings, hierarchy, axis_sum=_identity_sum,
                    project=None):
    """Coarse level idx + 1's correction (the span `orc.mg.level<idx+1>`,
    the levels below nested in it)."""
    level = hierarchy[idx]
    with span(f"orc.mg.level{idx + 1}"):
        r_c = restrict(r, level)
        with span("orc.mg.galerkin"):
            A_c = galerkin(A_f, level)
        coarsest = idx + 1 == len(hierarchy)
        e_c, _ = _smooth(
            A_c,
            r_c,
            torch.zeros_like(r_c),
            settings,
            axis_sum,
            iterations=settings.iterations if coarsest else None,
            project=project,
        )
        if not coarsest:
            rr = r_c - A_c.matvec(e_c)
            e_c = e_c + _gmg_correction(
                A_c, rr, idx + 1, settings, hierarchy, axis_sum, project=project
            )
            e_c, _ = _smooth(A_c, r_c, e_c, settings, axis_sum, project=project)
        return prolong(e_c, level)


# --- distributed V-cycle ----------------------------------------------


def _coarse_index_of(level: GmgLevel, g):
    """Coarse cell of global fine cell id g (flat block arithmetic)."""
    nx, ny, _ = level.dims
    bx, by, bz = level.block
    cx, cy, _ = level.cdims
    ix = g % nx
    iy = (g // nx) % ny
    iz = g // (nx * ny)
    return (ix // bx) + cx * ((iy // by) + cy * (iz // bz))


def _local_coarse_contrib(A, r, owned_mask, owned_global, level: GmgLevel):
    """(flat coarse-matrix values [..., n_c*(K_c+1)], coarse residual
    [..., n_c]) from this partition's owned fine rows; `axis_sum` across
    partitions completes R A P and R r. The slot of every entry comes
    from host tables built once per partition (orc_tpu's scatter-adds,
    as gathers)."""
    K = A.off.shape[-1]
    gal, res = cached_on(
        owned_global, ("gmg", id(level), K),
        lambda: _coarse_tables(level, owned_mask, owned_global, K),
    )
    batch = A.diag.shape[:-1]
    vals = torch.cat([A.diag, A.off.reshape(*batch, -1)], dim=-1)
    return gal.partial(vals), res.partial(r)


def _coarse_tables(level: GmgLevel, owned_mask, owned_global, K: int):
    """Host-built (Galerkin, restriction) ShardedTables of a partition:
    the flat coarse slot of each local diagonal and off-diagonal entry
    of its owned rows (-1 elsewhere), by orc_tpu's rules: in-block
    entries fold into the coarse diagonal, cross-block ones into their
    coarse column."""
    dev = owned_global.device
    g = owned_global.cpu().numpy().astype(np.int64)
    own = owned_mask.cpu().numpy().astype(bool)
    nx, ny, _ = level.dims
    I = _coarse_index_of(level, g)
    stride = len(level.coarse_offsets) + 1
    diag_t = np.where(own, I * stride, -1)
    off_t = np.full((g.shape[0], K), -1, dtype=np.int64)
    for k, info in enumerate(level.col_info):
        tgt = level.coarse_col_of[k]
        if tgt == -2:
            continue
        if tgt == -1:
            t = I * stride
        else:
            axis, direction, wrap = info
            if wrap or level.block[axis] == 1:
                t = I * stride + 1 + tgt
            else:
                idx_ax = (g % nx, (g // nx) % ny, g // (nx * ny))[axis]
                cross = (idx_ax % 2) == (1 if direction > 0 else 0)
                t = np.where(cross, I * stride + 1 + tgt, I * stride)
        off_t[:, k] = np.where(own, t, -1)
    n_c = level.n_coarse
    return (
        ShardedTables(
            np.concatenate([diag_t, off_t.reshape(-1)]), n_c * stride, dev
        ),
        ShardedTables(np.where(own, I, -1), n_c, dev),
    )


def gmg_solve_sharded(
    A,
    b,
    x0,
    settings: MatrixSolverSettings,
    hierarchy: Tuple[GmgLevel, ...],
    axis_sum,
    refresh,
    owned_mask,
    owned_global,
    project=None,
    null_scale=None,
):
    """Distributed V-cycle: smooth the partition's rows with halo
    refreshes and completed reductions, then add the coarse correction,
    computed the same on every partition from the summed coarse system,
    prolonged to the global box and read at the owned rows' global
    ids."""
    x, info0 = _smooth(
        A, b, x0, settings, axis_sum, refresh=refresh, project=project
    )
    cproject = _coarse_project(null_scale)
    if hierarchy:
        level = hierarchy[0]
        r = b - _mv(A, x, refresh)
        flat, r_c = _local_coarse_contrib(A, r, owned_mask, owned_global, level)
        flat = axis_sum(flat)
        r_c = axis_sum(r_c)
        stride = len(level.coarse_offsets) + 1
        flat = flat.reshape(*flat.shape[:-1], level.n_coarse, stride)
        cdiag = flat[..., 0]
        A_c = EllMatrix(
            diag=torch.where(cdiag == 0.0, torch.ones_like(cdiag), cdiag),
            off=flat[..., 1:],
            neighbors=None,
            offsets=level.coarse_offsets,
        )
        # Replicated coarse correction (the same on every partition; no
        # collective below this point).
        e_c, _ = _smooth(
            A_c, r_c, torch.zeros_like(r_c), settings,
            iterations=settings.iterations if len(hierarchy) == 1 else None,
            project=cproject,
        )
        if len(hierarchy) > 1:
            rr = r_c - A_c.matvec(e_c)
            e_c = e_c + _gmg_correction(
                A_c, rr, 1, settings, hierarchy, project=cproject
            )
            e_c, _ = _smooth(A_c, r_c, e_c, settings, project=cproject)
        e_f = prolong(e_c, level)  # [..., C] global, replicated
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        x = x + torch.where(owned_mask, e_f[..., owned_global.long()], zero)
        x, _ = _smooth(
            A, b, x, settings, axis_sum, refresh=refresh, project=project
        )
    rn = _norm(b - _mv(A, x, refresh), axis_sum)
    diverged = torch.isnan(rn) | (_max_abs(x) > 1e10)
    return x, SolveInfo(
        iterations=info0.iterations, residual=rn, diverged=diverged
    )
