"""Kernel 4: damped-Jacobi sweeps over a batch sharing one matrix, or
one matrix per batch row.

Replaces orc_tpu/ops/pallas_smooth.py `_kernel` (via
`fused_jacobi_sweeps` -> `_fused_batched`), the momentum smoother of
`krylov.jacobi_smooth_solve`. On CPU tensors `fused_jacobi_sweeps` runs
`sweeps_plain`, the torch counterpart of orc_tpu's `sweeps_xla`; on the
card it launches a kernel of ``csrc/jacobi_sweeps.cu``, the instance
picked by `sweep_plan` from the offsets and the shape alone:

- on a 2-D box whose every column steps one cell along an axis (or is a
  padding column of offset 0), `jacobi_tile_kernel` runs every sweep in
  one launch over box tiles with a halo as deep as the sweeps (temporal
  blocking; up to MAX_DEPTH_2D sweeps a launch), for a shared matrix
  (three batch rows a CTA) and for one matrix per batch row (a CTA per
  tile and batch row: the CD2 and in-matrix TVD momentum systems);
- on a 3-D box of steps with a shared matrix, `jacobi_march_kernel`
  marches along z, up to MARCH_DEPTH sweeps a launch (full 3-D windows
  hold 3.2 times their tile's cells, and every tiled depth measured
  slower than a launch per sweep: PERF.md);
- otherwise (periodic boxes, column counts other than 2, 4 and 6, 3-D
  boxes with one matrix per batch row) `jacobi_sweep_kernel` takes a
  launch per sweep.

Every instance gives the same bits.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from orc_tpu_torch.ops import _cuda

#: Window cells a tile CTA stages: 512 threads x 4 (float32) or 2
#: (float64) cells (csrc/jacobi_sweeps.cu `tile_cells`).
TILE_WINDOW = {torch.float32: 2048, torch.float64: 1024}
#: Column counts the tile kernel is instantiated for
#: (csrc/jacobi_sweeps.cu `launch_tile`).
TILE_K = (2, 4, 6)
#: The tile kernel indexes rows in 32 bits: boxes below 2^30 cells.
TILE_ROWS = 1 << 30
#: Sweeps one tiled launch fuses at most on a 2-D (or 1-D) box.
MAX_DEPTH_2D = 8
#: Cells of a marching CTA's xy window: 512 threads x 2 slots
#: (csrc/jacobi_sweeps.cu `kMarchThreads`, `kMarchQ`), and its deepest
#: march (`kMaxMarchDepth`).
MARCH_WINDOW = 1024
MAX_DEPTH_MARCH = 3
#: Sweeps a march takes at most on a 3-D box of steps: three ran
#: faster than one or two (kernel_ab.py, PERF.md).
MARCH_DEPTH = 3
#: Streaming multiprocessors of an H100 SXM, each running one marching
#: CTA at a time (512 threads of up to 128 registers), and the shared
#: memory a CTA may take (227 KB).
SMS = 132
SMEM_PER_CTA = 232448


class SweepPlan(NamedTuple):
    """How `fused_jacobi_sweeps` runs on the card: `depth` sweeps a
    launch over `tile` cells of the `dims` box (tiled, or marching along
    z when `march`), or a launch per sweep when `depth` is 0; `per_row`:
    one matrix per batch row."""

    depth: int = 0
    dims: tuple = (0, 0, 0)
    tile: tuple = (0, 0, 0)
    per_row: bool = False
    march: bool = False

    def passes(self, sweeps: int) -> int:
        """Launches over the whole batch: ping-pong passes."""
        return sweeps if self.depth == 0 else -(-sweeps // self.depth)

    def launches(self, sweeps: int, batch: int) -> int:
        """Kernel launches of one call (a shared matrix takes three batch
        rows a launch, the per-row tiles every row in one)."""
        if self.depth == 0:
            return sweeps
        return self.passes(sweeps) * (1 if self.per_row else -(-batch // 3))

    def label(self) -> str:
        if self.depth == 0:
            return "per-sweep per-row" if self.per_row else "per-sweep"
        kind = (
            f"march S={self.depth}" if self.march
            else f"tiled S={self.depth}{' per-row' if self.per_row else ''}"
        )
        return (
            f"{kind} box {'x'.join(map(str, self.dims))} "
            f"tile {'x'.join(map(str, self.tile))}"
        )


@functools.lru_cache(maxsize=64)
def _box_steps(offsets, n_cells):
    """(nx, ny, nz) of the box (axes of extent 1 last) on which every
    offset is 0 or one step along an axis of extent > 1; None when there
    is none (periodic or irregular boxes)."""
    from orc_tpu_torch.solver.gmg import infer_box_dims

    dims = infer_box_dims(offsets, n_cells)
    if dims is None:
        return None
    dims = [d for d in dims if d > 1]
    nx, ny, nz = dims + [1] * (3 - len(dims))
    for d in offsets:
        a = abs(d)
        if not (
            d == 0 or (a == 1 and nx > 1) or (a == nx and ny > 1)
            or (a == nx * ny and nz > 1)
        ):
            return None
    return nx, ny, nz


@functools.lru_cache(maxsize=64)
def tile_shape(dims, depth, capacity):
    """The tile (bx, by, bz) whose windows, a halo of `depth` cells on
    each axis of extent > 1, hold at most `capacity` cells and cover the
    box with the fewest window cells in all (the staged and recomputed
    work); ties go to the wider tile along x (coalesced rows). None when
    no window fits."""
    nx, ny, nz = dims
    hx, hy, hz = (depth if n > 1 else 0 for n in dims)
    best = None
    for bx in range(1, min(nx, capacity) + 1):
        wx = bx + 2 * hx
        for by in range(1, ny + 1) if nz > 1 else (None,):
            if by is None:  # 2-D: the tallest tile that fits
                by = min(ny, capacity // wx - 2 * hy)
                if by < 1:
                    break
            wy = by + 2 * hy
            bz = min(nz, capacity // (wx * wy) - 2 * hz)
            if bz < 1:
                break
            cells = wx * wy * (bz + 2 * hz)
            tiles = -(-nx // bx) * -(-ny // by) * -(-nz // bz)
            key = (tiles * cells, -bx)
            if best is None or key < best[0]:
                best = (key, (bx, by, bz))
    return None if best is None else best[1]


def march_smem(depth, window, wx, itemsize, nb=3):
    """Shared-memory bytes of a marching CTA (csrc/jacobi_sweeps.cu
    `march_smem`): a ring of three planes of nb components of x for each
    of `depth` levels, each plane padded by wx slots a side."""
    return 3 * depth * nb * (window + 2 * wx) * itemsize


@functools.lru_cache(maxsize=64)
def march_shape(dims, depth, dtype):
    """The xy tile (bx, by) and z-chunk bz of a march `depth` sweeps
    deep: windows of at most MARCH_WINDOW cells whose shared memory (three
    batch rows) fits a CTA, and the least time as waves of CTAs over
    the SMS SMs times a CTA's work (window cells times planes walked,
    the chunk and 2 depth); ties go to the fewest window cells in all,
    then the wider tile. None when no window fits."""
    nx, ny, nz = dims
    h = depth
    best = None
    bzs = sorted({-(-nz // t) for t in range(1, nz + 1)})
    for bx in range(1, nx + 1):
        wx = bx + 2 * h
        by = min(ny, MARCH_WINDOW // wx - 2 * h)
        while by >= 1 and march_smem(h, wx * (by + 2 * h), wx, dtype.itemsize) > SMEM_PER_CTA:
            by -= 1
        if by < 1:
            break
        W = wx * (by + 2 * h)
        xy = -(-nx // bx) * -(-ny // by)
        for bz in bzs:
            ctas = xy * -(-nz // bz)
            work = W * (bz + 2 * h)
            key = (-(-ctas // SMS) * work, ctas * work, -bx)
            if best is None or key < best[0]:
                best = (key, (bx, by, bz))
    return None if best is None else best[1]


def sweep_plan(
    offsets, n_cells: int, sweeps: int, dtype, depth=None, per_row=False,
    march=False,
) -> SweepPlan:
    """The kernel instance for (offsets, n_cells, sweeps, dtype): on a
    2-D (or 1-D) box of steps in 2, 4 or 6 columns (TILE_K) the tiles,
    all sweeps in one launch up to MAX_DEPTH_2D, with a shared matrix or
    one per batch row (`per_row`); on a 3-D box of steps with a shared
    matrix the march, up to MARCH_DEPTH sweeps a launch (evenly split
    passes); else (periodic boxes, other column counts, per-row 3-D
    systems) a launch per sweep. `depth` forces the sweeps a tiled
    launch fuses (0: the per-sweep kernel), 3-D boxes included; `march`
    forces a march, at `depth` sweeps a launch (MARCH_DEPTH by default).
    A box that is not one of steps then raises."""
    offsets = tuple(int(d) for d in offsets)
    tileable = len(offsets) in TILE_K and n_cells < TILE_ROWS
    dims = _box_steps(offsets, n_cells) if tileable else None
    if not march and depth is None:
        if dims is None or sweeps < 1:
            return SweepPlan(per_row=per_row)
        most = MAX_DEPTH_2D
        if dims[2] > 1:
            if per_row:
                return SweepPlan(per_row=True)
            march, most = True, MARCH_DEPTH
        passes = -(-sweeps // most)
        depth = -(-sweeps // passes)  # even passes of at most `most`
    if march:
        depth = depth or MARCH_DEPTH
        if per_row or not 1 <= depth <= MAX_DEPTH_MARCH:
            raise ValueError(
                f"a march takes a shared matrix and 1 to {MAX_DEPTH_MARCH} sweeps a "
                f"launch; got depth {depth}, per_row {per_row}"
            )
        if dims is None or dims[2] == 1 or len(offsets) != 6:
            raise ValueError(
                f"the offsets {offsets} of {n_cells} rows are not the six steps "
                f"of a 3-D box: the march cannot run them"
            )
        tile = march_shape(dims, depth, dtype)
        if tile is None:
            raise ValueError(f"no march window of the {dims} box fits a CTA")
        return SweepPlan(depth, dims, tile, march=True)
    if depth == 0:
        return SweepPlan(per_row=per_row)
    if dims is None:
        raise ValueError(
            f"the offsets {offsets} of {n_cells} rows are not the steps of a box "
            f"in {TILE_K} columns: the tiled sweeps cannot run them"
        )
    tile = tile_shape(dims, depth, TILE_WINDOW[dtype])
    if tile is None:
        raise ValueError(
            f"no tile of the {dims} box with a halo {depth} cells deep fits "
            f"{TILE_WINDOW[dtype]} window cells"
        )
    return SweepPlan(depth, dims, tile, per_row)


def sweeps_plain(diag, off, offsets, b, x0, sweeps: int, relaxation):
    """`sweeps` damped-Jacobi sweeps in plain torch, broadcasting over
    any leading batch dims (krylov.jacobi_smooth_solve's loop body)."""
    split = isinstance(off, tuple)
    inv_diag = 1.0 / diag
    b_prime = b * inv_diag

    def mv_off(x):
        y = diag * x
        for k, d in enumerate(offsets):
            xk = torch.roll(x, -int(d), dims=-1) if d != 0 else x
            col = off[k] if split else off[..., k]
            y = y + col * xk
        return y - diag * x

    x = x0
    for _ in range(sweeps):
        x = relaxation * (b_prime - mv_off(x) * inv_diag) + (
            1.0 - relaxation
        ) * x
    return x


def fused_jacobi_sweeps(diag, off, offsets, b, x0, sweeps: int, relaxation):
    """`sweeps` damped-Jacobi sweeps of (diag, off, offsets) on b from
    x0. diag: [C] shared, or [B,C] one matrix per batch row; off: [C,K]
    / [B,C,K] or a K-tuple of [C] / [B,C] columns (the form of diag); b,
    x0: [C] or [B,C]. CPU tensors take the plain version; CUDA tensors
    launch the kernel instance `sweep_plan` picks (on a 2-D box one
    launch for all sweeps and up to three batch rows; a launch per sweep
    per row) or raise."""
    if not x0.is_cuda:
        return sweeps_plain(diag, off, offsets, b, x0, sweeps, relaxation)
    dev = x0.device
    C = x0.shape[-1]
    per_row = diag.ndim == 2
    if x0.ndim not in (1, 2) or b.shape != x0.shape:
        raise ValueError(
            f"b and x0 must both be [C] or [B,C]; got {tuple(b.shape)} "
            f"and {tuple(x0.shape)}"
        )
    row = tuple(x0.shape) if per_row else (C,)
    if diag.ndim not in (1, 2) or tuple(diag.shape) != row:
        raise ValueError(
            f"fused_jacobi_sweeps kernel takes diag [C] shared by the batch "
            f"or [B,C] one per batch row; got diag {tuple(diag.shape)} for "
            f"x0 {tuple(x0.shape)}"
        )
    if not isinstance(relaxation, (int, float)):
        raise TypeError("relaxation must be a Python number")
    if sweeps < 1:
        return x0
    cols = off if isinstance(off, tuple) else tuple(
        off[..., k] for k in range(off.shape[-1])
    )
    if len(cols) != len(offsets) or any(
        tuple(c.shape) != row or c.dtype != x0.dtype for c in cols
    ):
        raise ValueError(
            f"off must hold one {list(row)} column per offset, x0's dtype"
        )
    if diag.dtype != x0.dtype or b.dtype != x0.dtype:
        raise TypeError("diag, b and x0 must share one dtype")
    _cuda.check_cuda(
        dev, diag=diag, b=b, **{f"off{k}": c for k, c in enumerate(cols)}
    )
    plan = sweep_plan(offsets, C, sweeps, x0.dtype, per_row=per_row)
    y = _launch_sweeps(
        diag.contiguous(), cols, offsets, b.contiguous(), x0.contiguous(),
        int(sweeps), relaxation, plan,
    )
    B = 1 if x0.ndim == 1 else x0.shape[0]
    launches = plan.launches(sweeps, B)
    fused_jacobi_sweeps.launches += launches
    if per_row:
        fused_jacobi_sweeps.per_row_launches += launches
    if plan.march:
        fused_jacobi_sweeps.march_launches += launches
    label = plan.label()
    fused_jacobi_sweeps.instances[label] = (
        fused_jacobi_sweeps.instances.get(label, 0) + 1
    )
    return y


def _launch_sweeps(diag, cols, offsets, b, x0, sweeps, relaxation, plan):
    """The kernel launches of `fused_jacobi_sweeps` on checked,
    contiguous tensors (a per-row diag and columns with unit row
    stride), as `plan` says."""
    buf0 = torch.empty_like(x0)
    passes = plan.passes(sweeps)
    buf1 = torch.empty_like(x0) if passes > 1 else buf0
    ptrs, strides, offs = _cuda.column_args(cols, offsets)
    B = 1 if x0.ndim == 1 else x0.shape[0]
    if plan.per_row:
        _cuda.call(
            "orc_jacobi_sweeps_rows", x0.device, _cuda.dtype_code(x0),
            diag.data_ptr(), diag.stride(0), ptrs, strides,
            _cuda.batch_strides(cols), offs, len(cols), b.data_ptr(),
            x0.data_ptr(), buf0.data_ptr(), buf1.data_ptr(), x0.shape[-1], B,
            sweeps, float(relaxation), *plan.dims, plan.depth, *plan.tile,
        )
    elif plan.march:
        _cuda.call(
            "orc_jacobi_march", x0.device, _cuda.dtype_code(x0),
            diag.data_ptr(), ptrs, strides, offs, len(cols), b.data_ptr(),
            x0.data_ptr(), buf0.data_ptr(), buf1.data_ptr(), x0.shape[-1], B,
            sweeps, float(relaxation), *plan.dims, plan.depth, *plan.tile,
        )
    else:
        _cuda.call(
            "orc_jacobi_sweeps", x0.device, _cuda.dtype_code(x0),
            diag.data_ptr(), ptrs, strides, offs, len(cols), b.data_ptr(),
            x0.data_ptr(), buf0.data_ptr(), buf1.data_ptr(), x0.shape[-1], B,
            sweeps, float(relaxation), *plan.dims, plan.depth, *plan.tile,
        )
    return (buf0, buf1)[(passes - 1) % 2]


#: Kernel launches since the last reset (set to 0 to reset).
fused_jacobi_sweeps.launches = 0
#: Launches of the per-row instances, counted in `launches` too.
fused_jacobi_sweeps.per_row_launches = 0
#: Launches of the z-march (3-D boxes), counted in `launches` too.
fused_jacobi_sweeps.march_launches = 0
#: Calls per instance (SweepPlan.label) since the last reset (set to {}).
fused_jacobi_sweeps.instances = {}
