"""Cell reordering and slice plans for irregular meshes (port of
orc_tpu/mesh/reorder.py).

A mesh without constant neighbour offsets gets, at compile time:

1. a reverse Cuthill-McKee ordering of its cells, which bounds the
   adjacency bandwidth (every neighbour of cell c lies within a small
   index window of c);
2. a slice plan: cells are grouped into tiles of T consecutive rows, and
   within one tile the (neighbour - cell) deltas take a few dozen
   distinct values. Slice column j of tile t is one such delta d, and the
   SpMV becomes, per tile, a sum over its columns of

       y[tile] += coef_j[tile] * x[tile_start + d : tile_start + d + T]

   with the coefficients in the dense [ntiles, n_max, T] layout that
   `EllMatrix.prepare()` builds (ops/spmv.py, ops/slice_spmv.py).

Host work is numpy, as in orc_tpu; the plan's index tables move to the
device in one transfer each. The tile choice is orc_tpu's, TPU cost model
included, so both packages run the same plan.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orc_tpu_torch.utils.device import resolve_device

#: Lane width of orc_tpu's slice kernels: the base tile of a plan, and
#: the unit of the window rows that gate the heavy-tail split.
LANES = 128
#: Tiles per group of orc_tpu's 128-row kernel (one window per group).
GROUP = 8


@dataclasses.dataclass(frozen=True)
class SlicePlan:
    """Per-tile slice schedule of an ELL matrix.

    starts:  [ntiles, n_max] i32, start of each slice in the padded x
             (pad_lo zeros prepended); unused columns repeat the tile's
             first used start and carry zero coefficients.
    col_of:  [C, K] i32, slice column of each ELL entry (tile-local);
             boundary and padded entries map to column 0.
    tile_nj: [ntiles] i32, used slice columns per tile: columns are
             ranked within each tile, so the used ones are the first
             tile_nj[t].
    col_tile: [ntiles, K, tile] i32, col_of in the tile layout of the
             neighbour-value gather (rows past C hold column 0); None in
             a plan built without it (build_col_tile=False: the SpMV
             alone, as on the algebraic multigrid's coarse levels).
    j0, n_heavy: orc_tpu's heavy-tail split of 128-row plans (its TPU
             kernel runs the first j0 columns of every tile and the rest
             of the n_heavy tiles that have more in a second kernel).
             They feed the tile choice; the port's kernel bounds its
             loop by tile_nj instead.
    """

    starts: torch.Tensor = dataclasses.field(repr=False)
    col_of: torch.Tensor = dataclasses.field(repr=False)
    tile_nj: torch.Tensor = dataclasses.field(repr=False)
    col_tile: "torch.Tensor | None" = dataclasses.field(repr=False)
    tile: int
    n_max: int
    pad_lo: int
    pad_hi: int
    n_cells: int
    j0: int = 0
    n_heavy: int = 0

    @property
    def ntiles(self) -> int:
        return self.starts.shape[0]

    def to(self, device) -> "SlicePlan":
        return dataclasses.replace(
            self,
            starts=self.starts.to(device),
            col_of=self.col_of.to(device),
            tile_nj=self.tile_nj.to(device),
            col_tile=None if self.col_tile is None else self.col_tile.to(device),
        )


def rcm_permutation(
    cell_neighbors: np.ndarray, entry_interior: np.ndarray
) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the cell adjacency graph:
    order[new_id] = old_id. scipy's implementation when present; the
    numpy BFS below is the behavioural spec (each component starts from
    a minimum-degree vertex)."""
    C, K = cell_neighbors.shape
    # np.nonzero is row-major, so `adj` is already the CSR data array.
    rows, cols = np.nonzero(entry_interior)
    adj = cell_neighbors[rows, cols]
    deg = np.zeros(C, dtype=np.int64)
    np.add.at(deg, rows, 1)
    starts = np.zeros(C + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])

    try:
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        a = csr_matrix(
            (np.ones(len(adj), np.int8), adj, starts), shape=(C, C)
        )
        return np.asarray(
            reverse_cuthill_mckee(a, symmetric_mode=True), dtype=np.int64
        )
    except ImportError:  # pragma: no cover
        pass

    visited = np.zeros(C, dtype=bool)
    order = np.empty(C, dtype=np.int64)
    pos = 0
    for start in np.argsort(deg, kind="stable"):
        if visited[start]:
            continue
        visited[start] = True
        head = pos
        order[pos] = start
        pos += 1
        while head < pos:
            u = order[head]
            head += 1
            cand = adj[starts[u] : starts[u + 1]]
            cand = cand[~visited[cand]]
            if len(cand):
                cand = np.unique(cand)
                cand = cand[np.argsort(deg[cand], kind="stable")]
                n = len(cand)
                order[pos : pos + n] = cand
                visited[cand] = True
                pos += n
    assert pos == C
    return order[::-1].copy()


def _host_plan(cell_neighbors, entry_interior, tile, build_col_tile=False):
    """The plan with CPU tensors (no copy of the numpy tables), or None
    when it would be degenerate (n_max > tile)."""
    C, K = cell_neighbors.shape
    ntiles = -(-C // tile)
    delta = cell_neighbors.astype(np.int64) - np.arange(C)[:, None]
    rows, cols = np.nonzero(entry_interior)
    if len(rows) == 0:
        return None
    t = rows // tile
    d = delta[rows, cols]
    # Unique (tile, delta) pairs; the tile-local column is the rank of
    # the delta within its tile's sorted distinct set.
    pair = np.stack([t, d], axis=1)
    uniq, inverse = np.unique(pair, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    ut, ud = uniq[:, 0], uniq[:, 1]
    tile_first = np.searchsorted(ut, np.arange(ntiles))
    j_of_pair = np.arange(len(uniq)) - tile_first[ut]
    counts = np.bincount(ut, minlength=ntiles)
    n_max = int(counts.max())
    if n_max > tile:
        return None

    col_of = np.zeros((C, K), dtype=np.int64)
    col_of[rows, cols] = j_of_pair[inverse]

    # Slice (t, j) covers padded indices [pad_lo + t*tile + d, + tile);
    # the pads keep every slice in range.
    raw_start = ut * tile + ud
    pad_lo = int(max(0, -raw_start.min()))
    pad_hi = int(max(0, raw_start.max() + tile - C))
    # Unused columns repeat the tile's first used start; a tile without
    # interior entries points inside its own row span.
    first_start = pad_lo + np.minimum(
        np.arange(ntiles, dtype=np.int64) * tile, max(0, C - tile)
    )
    has = counts > 0
    first_start[has] = raw_start[tile_first[has]] + pad_lo
    starts = np.broadcast_to(first_start[:, None], (ntiles, n_max)).copy()
    starts[ut, j_of_pair] = raw_start + pad_lo

    col_tile = None
    if build_col_tile:
        col_pad = np.zeros((ntiles * tile, K), dtype=np.int64)
        col_pad[:C] = col_of
        col_tile = np.ascontiguousarray(
            np.swapaxes(col_pad.reshape(ntiles, tile, K), 1, 2)
        )

    # orc_tpu's heavy-tail split (128-row plans): the smallest multiple
    # of 8 that fully covers >= 3/4 of the tiles, gated on the group
    # window of its TPU kernel (at most 1024 rows of 128 lanes).
    j0 = n_heavy = 0
    if tile == LANES and n_max > 12:
        q = starts // LANES
        ngroups = -(-ntiles // GROUP)
        qpad = np.concatenate(
            [q] + [q[-1:]] * (ngroups * GROUP - ntiles), axis=0
        ).reshape(ngroups, GROUP * n_max)
        win_rows = int((qpad.max(axis=1) - qpad.min(axis=1)).max()) + 2
        if win_rows <= 1024:
            for cand in (8, 16, 24):
                if cand >= n_max:
                    break
                if (counts > cand).sum() <= ntiles // 4:
                    j0 = cand
                    break
            if j0:
                n_heavy = int((counts > j0).sum())

    i32 = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    return SlicePlan(
        starts=i32(starts),
        col_of=i32(col_of),
        tile_nj=i32(counts),
        tile=tile,
        n_max=n_max,
        pad_lo=pad_lo,
        pad_hi=pad_hi,
        n_cells=C,
        col_tile=None if col_tile is None else i32(col_tile),
        j0=j0,
        n_heavy=n_heavy,
    )


def build_slice_plan(
    cell_neighbors: np.ndarray,
    entry_interior: np.ndarray,
    tile: int = 128,
    build_col_tile: bool = False,
    device: torch.device | str = "cuda",
) -> SlicePlan | None:
    """The per-tile slice schedule on `device`, or None when the plan
    would be degenerate (more distinct deltas in a tile than its rows).
    `build_col_tile` builds the neighbour gather's table
    (`SlicePlan.col_tile`, [ntiles, K, tile]); only the mesh compile
    asks for it, SpMV-only callers (AMG coarse levels) do not."""
    device = resolve_device(device)
    plan = _host_plan(cell_neighbors, entry_interior, tile, build_col_tile)
    return None if plan is None else plan.to(device)


def _tile_cost(plan: SlicePlan) -> float:
    """orc_tpu's modelled cost per cell of its TPU slice kernel: n_eff
    slices of rolls, selects and FMAs on (T+1)-row blocks plus the
    coefficient traffic, with the heavy-tail split capping n_eff."""
    T = plan.tile // 128
    if plan.j0:
        n_eff = plan.j0 + (plan.n_heavy * (plan.n_max - plan.j0)) / max(
            1, plan.ntiles
        )
    else:
        n_eff = plan.n_max
    instr = n_eff * (2 + -(-(T + 1) // 8) + -(-T // 8))
    instr += n_eff * T * 16 // 8
    return instr / plan.tile


def build_best_slice_plan(
    cell_neighbors: np.ndarray,
    entry_interior: np.ndarray,
    tiles=(128, 1024),
    build_col_tile: bool = False,
    device: torch.device | str = "cuda",
) -> SlicePlan | None:
    """Plans at the candidate tile widths; keeps the one of lowest
    modelled cost (orc_tpu's choice, so both packages run one plan).
    Wide tiles are tried only when C >= 4 * tile. `build_col_tile` as
    in `build_slice_plan`."""
    device = resolve_device(device)
    C = cell_neighbors.shape[0]
    best, best_cost = None, None
    for tile in tiles:
        if tile != 128 and C < 4 * tile:
            continue
        plan = _host_plan(cell_neighbors, entry_interior, tile, build_col_tile)
        if plan is None:
            continue
        cost = _tile_cost(plan)
        if best_cost is None or cost < best_cost:
            best, best_cost = plan, cost
    return None if best is None else best.to(device)
