// Damped-Jacobi sweeps over a batch sharing one structured matrix, on
// Hopper (sm_90a).
//
// Replaces: orc_tpu/ops/pallas_smooth.py `_kernel` (reached from
// `fused_jacobi_sweeps` via `_fused_batched`), the TPU kernel that runs
// all sweeps in one pass over sweep-deep halo windows in VMEM.
//
//   x <- w * (b / diag - offdiag(x) / diag) + (1 - w) * x,
//   offdiag(x) = (diag * x + sum_k off_k * x[i + d_k]) - diag * x
//
// in the same arithmetic order as the plain version (orc_tpu's
// sweeps_xla), for B right-hand sides (u/v/w) sharing diag and off.
// Reads outside [0, C) are 0 (the TPU kernel's zero padding).
//
// Bound on the H100: device memory. The function reads diag, the K
// columns, b and x0 once and writes x once: (1 + K + 2B) + B values a
// row, whatever the number of sweeps.
//
// Three kernels, picked by the wrapper from the offsets and the shape
// alone (orc_tpu_torch/ops/fused_smooth.py `sweep_plan`):
//
// jacobi_tile_kernel (temporal blocking on box tiles) takes 2-D (and
// 1-D) boxes. On a box whose every column steps one cell along an axis
// (or is a padding column of offset 0), cell (x, y, z) is row
// x + nx (y + ny z). A CTA takes a tile of bx x by x bz cells and stages
// a window of x around it, H cells deeper on every axis of extent > 1,
// in shared memory as ping-pong buffers; diag, the columns and b of the
// window stay in the registers of the thread that owns each window cell
// (Q cells a thread), so the window holds at most 2048 float32 (1024
// float64) cells: 38 x 28 tiles in 50 x 40 windows on the 1024^2 cavity
// at six sweeps. Sweep s updates the window cells at least s cells from
// its edge, a barrier apart, and after `sweeps` <= H sweeps the tile's
// cells are written out: the matrix and b are read once (and the halo
// again from L2), x once, the result written once, for all sweeps in
// one launch. A window slot holds row x + nx (y + ny z) of its box
// coordinates whenever that row lies in [0, C) and 0 otherwise, so its
// step neighbours are the rows i + d_k whichever face they cross: the
// tile computes exactly what the per-sweep kernel does, coefficient for
// coefficient. The TPU kernel blocks the flat row index instead; on the
// 1024^2 cavity that needs halos of sweeps * 1024 rows, which no Hopper
// CTA can stage. A shared matrix takes up to three batch rows a CTA; one
// matrix per batch row (template flag PR, the CD2 and in-matrix TVD
// momentum systems) takes a CTA per (tile, batch row), the batch row
// blockIdx.y, with the registers and shared memory of one batch row:
// three matrices do not fit one CTA's registers.
//
// jacobi_march_kernel (temporal blocking that marches along z) takes
// 3-D boxes with a shared matrix, where a window as deep as two sweeps
// in every axis holds three times its tile's cells. A CTA owns an xy
// tile with a halo of S cells and a z-chunk of planes, and walks the
// chunk's planes in order: sweep level s computes plane p once level
// s - 1 holds planes p - 1, p and p + 1, each level keeping a ring of
// three planes of the window in shared memory, so the z halo costs
// 2 S planes a chunk instead of 2 S cells a tile. The same flat-row
// embedding carries over: a slot of plane p holds the row of its box
// coordinates, 0 outside [0, C).
//
// jacobi_sweep_kernel (a launch per sweep, the first design) takes the
// other matrices: periodic boxes, whose wrap columns step across the
// box, column counts other than 2, 4 and 6, and 3-D boxes with one
// matrix per batch row. One thread per row reads diag and its K
// coefficients once and updates all B components of a shared matrix;
// with one matrix per batch row (PR, entry point
// `orc_jacobi_sweeps_rows` at depth 0) a thread takes one (row, batch
// row), the batch row blockIdx.y. Per row the function moves
// (1 + K + 3) B values a row (diag, the K columns, b and x0 read, x
// written): 24 float32 planes, 100.7 MB, 30.0 us at 3.35 TB/s on the
// 1024^2 TVD cavity (B = 3, K = 4); the launch per sweep reads the
// matrix and x again every sweep.
//
// The arithmetic of a row is the first design's as nvcc contracted it
// (its SASS on sm_90a): diag * x rounded, one fused multiply-add per
// column in order, ax_off = fma(-diag, x, mv), the product ax_off *
// inv_d rounded, fma(b, inv_d, -that) (b / diag is never rounded on its
// own), times w rounded, then fma(x, 1 - w, that). Every kernel spells
// it out with mul_rn / fma_rn, so every instance agrees bit for bit.
#include "common.cuh"

namespace orc {

// Batch-row strides (elements) of a per-row matrix: diag and each
// column of batch row b start at b * stride.
struct SweepRowStrides {
  long long diag;
  long long col[MAX_K];
};

// PR: one matrix per batch row, batch row blockIdx.y (a thread per row
// and batch row): its diag and columns a batch-row stride further on.
template <typename T, bool PR>
__global__ void jacobi_sweep_kernel(const T* __restrict__ diag,
                                    Columns<T> cols, SweepRowStrides rs,
                                    const T* __restrict__ b,
                                    const T* __restrict__ x,
                                    T* __restrict__ x_new, long long C,
                                    int B, T relax, T one_minus_relax) {
  if constexpr (PR) {
    const long long bb = blockIdx.y;
    diag += bb * rs.diag;
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) {
      if (k < cols.K) cols.col[k] += bb * rs.col[k];
    }
    b += bb * C;
    x += bb * C;
    x_new += bb * C;
    B = 1;
  }
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < C; i += step) {
    const T d = diag[i];
    const T inv_d = T(1) / d;
    T o[MAX_K];
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) {
      o[k] = (k < cols.K) ? cols.col[k][i * cols.stride[k]] : T(0);
    }
    for (int bb = 0; bb < B; ++bb) {
      const T* xb = x + bb * C;
      const T xc = xb[i];
      T mv = mul_rn(d, xc);
#pragma unroll
      for (int k = 0; k < MAX_K; ++k) {
        if (k < cols.K) {
          const long long j = i + cols.offset[k];
          const T xv = (j >= 0 && j < C) ? xb[j] : T(0);
          mv = fma_rn(o[k], xv, mv);
        }
      }
      const T ax_off = fma_rn(-d, xc, mv);
      const T r = fma_rn(b[bb * C + i], inv_d, -mul_rn(ax_off, inv_d));
      x_new[bb * C + i] = fma_rn(xc, one_minus_relax, mul_rn(r, relax));
    }
  }
}

// Threads of a tile CTA, and the window cells each owns: the window
// holds at most kTileThreads * tile_cells<T>() cells.
constexpr int kTileThreads = 512;
template <typename T>
__host__ __device__ constexpr int tile_cells() {
  return sizeof(T) == 4 ? 4 : 2;
}
// Columns a tile kernel takes (a 3-D box has six).
constexpr int kTileK = 6;

// The window of a tile CTA and the step of each column in it.
struct SweepTile {
  long long C;
  int nx, ny, nz;      // the box (C = nx ny nz < 2^30)
  int bx, by, bz;      // the tile's cells
  int hx, hy, hz;      // halo depth on each axis (0 on an axis of extent 1)
  int wx, wy, wz, W;   // window extents and cells
  int tx, ty;          // tiles along x and y
  int dq[kTileK];      // window step of column k
};

// The tile of (bx, by, bz) cells with a halo of `halo` cells, or false
// when a column is neither a step along an axis of extent > 1 nor 0
// (the wrapper routes such matrices to the per-sweep kernel, so false
// is an error).
inline bool make_sweep_tile(const long long* offsets, int K, long long nx,
                            long long ny, long long nz, long long C, int bx,
                            int by, int bz, int halo, int capacity,
                            SweepTile* t) {
  if (K > kTileK || nx < 1 || ny < 1 || nz < 1 || nx * ny * nz != C ||
      C >= (1LL << 30) || bx < 1 || by < 1 || bz < 1 || halo < 1) {
    return false;
  }
  SweepTile s{};
  s.nx = static_cast<int>(nx);
  s.ny = static_cast<int>(ny);
  s.nz = static_cast<int>(nz);
  s.C = C;
  s.bx = bx;
  s.by = by;
  s.bz = bz;
  s.hx = nx > 1 ? halo : 0;
  s.hy = ny > 1 ? halo : 0;
  s.hz = nz > 1 ? halo : 0;
  s.wx = bx + 2 * s.hx;
  s.wy = by + 2 * s.hy;
  s.wz = bz + 2 * s.hz;
  const long long W = static_cast<long long>(s.wx) * s.wy * s.wz;
  if (W > capacity) return false;
  s.W = static_cast<int>(W);
  s.tx = static_cast<int>((nx + bx - 1) / bx);
  s.ty = static_cast<int>((ny + by - 1) / by);
  for (int k = 0; k < K; ++k) {
    const long long d = offsets[k];
    const long long a = d < 0 ? -d : d;
    const int sign = d < 0 ? -1 : 1;
    if (d == 0) {
      s.dq[k] = 0;
    } else if (a == 1 && nx > 1) {
      s.dq[k] = sign;
    } else if (a == nx && ny > 1) {
      s.dq[k] = sign * s.wx;
    } else if (a == nx * ny && nz > 1) {
      s.dq[k] = sign * s.wx * s.wy;
    } else {
      return false;
    }
  }
  *t = s;
  return true;
}

// One CTA per tile of the box. Thread t owns window slots q = t + j *
// kTileThreads, j < Q: it keeps their diag, 1 / diag, K columns and b
// in registers, and lev[j], the slot's distance from the window's edge
// (the least over the axes with a halo; -1 for a slot outside [0, C) or
// past the window). Sweep s (1-based) writes the slots with lev >= s
// from buffer (s - 1) & 1 into buffer s & 1; slots outside [0, C) hold
// 0 in both buffers. The tile's cells (lev >= halo) inside the box are
// written out after `sweeps` sweeps.
//
// The loads and the sweeps are branch-free over the Q slots, so the
// scheduler overlaps them: every slot is loaded (a slot outside [0, C)
// from row 0, then discarded) before the first use, and every slot is
// computed each sweep, only the store predicated on lev (a slot that is
// not stored reads padding or stale values, which nothing uses), and
// the slot coordinates step from slot to slot instead of dividing. One
// CTA of 512 threads an SM (90-104 registers a thread in float32).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (kernel_ab.py, 1024^2
// f32 B=3, six sweeps, ms): a branch per slot 0.1492; branch-free with
// 256 threads x 8 slots 0.0808, spilling; 512 x 4 0.0785; constant plane
// offsets and stepped coordinates 0.0663; 256 x 4 slots with two CTAs
// an SM (1024-cell windows) 0.0733; a skip of warps outside a sweep's
// rows no faster (PERF.md). The launch per sweep takes 0.1911.
template <typename T, int NB, int K, bool PR>
__global__ void __launch_bounds__(kTileThreads, 1)
    jacobi_tile_kernel(const T* __restrict__ diag, Columns<T> cols,
                       SweepRowStrides rs, const T* __restrict__ b,
                       const T* __restrict__ x, T* __restrict__ y,
                       SweepTile tl, int sweeps, T relax,
                       T one_minus_relax) {
  constexpr int Q = tile_cells<T>();
  // The per-row instance (PR, NB = 1) takes batch row blockIdx.y: its
  // matrix, b, x and y a batch-row stride further on.
  const long long bb = PR ? blockIdx.y : 0;
  if constexpr (PR) {
    diag += bb * rs.diag;
    b += bb * tl.C;
    x += bb * tl.C;
    y += bb * tl.C;
  }
  constexpr int kCap = kTileThreads * Q;
  // Buffer h, plane c: kCap slots of padding, the kCap window slots,
  // kCap slots of padding (a step is shorter than the window), so every
  // offset into a plane is a constant.
  constexpr int plane = 3 * kCap;
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem) + kCap;
  const long long C = tl.C;
  const int W = tl.W;
  const int tile = static_cast<int>(blockIdx.x);
  const int tz = tile / (tl.tx * tl.ty);
  const int rem = tile - tz * tl.tx * tl.ty;
  const int ty = rem / tl.tx;
  const int tx = rem - ty * tl.tx;
  // Box coordinates of window slot (0, 0, 0).
  const int ox = tx * tl.bx - tl.hx;
  const int oy = ty * tl.by - tl.hy;
  const int oz = tz * tl.bz - tl.hz;
  const int halo = tl.hx > 0 ? tl.hx : (tl.hy > 0 ? tl.hy : tl.hz);
  const int wxy = tl.wx * tl.wy;
  // Window coordinates of this thread's first slot, and the step from a
  // slot to the thread's next (kTileThreads slots on).
  const int t = static_cast<int>(threadIdx.x);
  const int sz0 = t / wxy, sy0 = (t - sz0 * wxy) / tl.wx;
  const int sx0 = t - sz0 * wxy - sy0 * tl.wx;
  const int dz = kTileThreads / wxy, dy = (kTileThreads - dz * wxy) / tl.wx;
  const int dx = kTileThreads - dz * wxy - dy * tl.wx;

  T d[Q], inv_d[Q], o[Q][K], bv[Q][NB];
  int lev[Q];
  {
    int sx = sx0, sy = sy0, sz = sz0;
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int q = t + j * kTileThreads;
      const int r = (ox + sx) + tl.nx * ((oy + sy) + tl.ny * (oz + sz));
      const bool ok = q < W && r >= 0 && r < C;
      const int rr = ok ? r : 0;
      int m = 1 << 30;
      if (tl.hx > 0) m = min(m, min(sx, tl.wx - 1 - sx));
      if (tl.hy > 0) m = min(m, min(sy, tl.wy - 1 - sy));
      if (tl.hz > 0) m = min(m, min(sz, tl.wz - 1 - sz));
      lev[j] = ok ? m : -1;
      const T dj = diag[rr];
      d[j] = ok ? dj : T(1);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const long long at = PR ? bb * rs.col[k] + rr * cols.stride[k]
                                : rr * cols.stride[k];
        o[j][k] = cols.col[k][at];
      }
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        bv[j][c] = b[c * C + rr];
        const T xv = x[c * C + rr];
        buf[c * plane + q] = ok ? xv : T(0);
        buf[(NB + c) * plane + q] = T(0);
      }
      sx += dx;
      sy += dy;
      sz += dz;
      if (sx >= tl.wx) sx -= tl.wx, ++sy;
      if (sy >= tl.wy) sy -= tl.wy, ++sz;
    }
  }
#pragma unroll
  for (int j = 0; j < Q; ++j) inv_d[j] = T(1) / d[j];
  __syncthreads();

  for (int s = 1; s <= sweeps; ++s) {
    const T* src = buf + ((s - 1) & 1) * NB * plane;
    T* dst = buf + (s & 1) * NB * plane;
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int q = t + j * kTileThreads;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        const T* xs = src + c * plane + q;
        const T xc = xs[0];
        T mv = mul_rn(d[j], xc);
#pragma unroll
        for (int k = 0; k < K; ++k) mv = fma_rn(o[j][k], xs[tl.dq[k]], mv);
        const T ax_off = fma_rn(-d[j], xc, mv);
        const T r = fma_rn(bv[j][c], inv_d[j], -mul_rn(ax_off, inv_d[j]));
        const T xn = fma_rn(xc, one_minus_relax, mul_rn(r, relax));
        if (lev[j] >= s) dst[c * plane + q] = xn;
      }
    }
    __syncthreads();
  }

  // The tile's cells inside the box (a ragged tile reaches past it).
  const T* fin = buf + (sweeps & 1) * NB * plane;
  int sx = sx0, sy = sy0, sz = sz0;
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int q = t + j * kTileThreads;
    const int gx = ox + sx, gy = oy + sy, gz = oz + sz;
    if (lev[j] >= halo && gx < tl.nx && gy < tl.ny && gz < tl.nz) {
      const int r = gx + tl.nx * (gy + tl.ny * gz);
#pragma unroll
      for (int c = 0; c < NB; ++c) y[c * C + r] = fin[c * plane + q];
    }
    sx += dx;
    sy += dy;
    sz += dz;
    if (sx >= tl.wx) sx -= tl.wx, ++sy;
    if (sy >= tl.wy) sy -= tl.wy, ++sz;
  }
}

// One launch of `sweeps` sweeps over every tile: `rows` CTA rows (the
// batch rows of the per-row instance, PR), NB batch rows a CTA.
template <typename T, int NB, int K, bool PR>
int launch_tile_nb(const T* diag, const Columns<T>& cols,
                   const SweepRowStrides& rs, const T* b, const T* x, T* y,
                   const SweepTile& tl, int rows, int sweeps, T relax, T omr,
                   cudaStream_t stream) {
  const size_t smem =
      2 * NB * 3 * kTileThreads * tile_cells<T>() * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        jacobi_tile_kernel<T, NB, K, PR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long tiles = static_cast<long long>(tl.tx) * tl.ty *
                          ((tl.nz + tl.bz - 1) / tl.bz);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(rows));
  jacobi_tile_kernel<T, NB, K, PR><<<grid, kTileThreads, smem, stream>>>(
      diag, cols, rs, b, x, y, tl, sweeps, relax, omr);
  return static_cast<int>(cudaGetLastError());
}

// nb: batch rows a CTA (shared matrix), or 0 for the per-row instance
// over `rows` batch rows.
template <typename T, int K>
int launch_tile_k(const T* diag, const Columns<T>& cols,
                  const SweepRowStrides& rs, const T* b, const T* x, T* y,
                  const SweepTile& tl, int nb, int rows, int sweeps, T relax,
                  T omr, cudaStream_t stream) {
  switch (nb) {
    case 0:
      return launch_tile_nb<T, 1, K, true>(diag, cols, rs, b, x, y, tl, rows,
                                           sweeps, relax, omr, stream);
    case 1:
      return launch_tile_nb<T, 1, K, false>(diag, cols, rs, b, x, y, tl, 1,
                                            sweeps, relax, omr, stream);
    case 2:
      return launch_tile_nb<T, 2, K, false>(diag, cols, rs, b, x, y, tl, 1,
                                            sweeps, relax, omr, stream);
    default:
      return launch_tile_nb<T, 3, K, false>(diag, cols, rs, b, x, y, tl, 1,
                                            sweeps, relax, omr, stream);
  }
}

template <typename T>
int launch_tile(const T* diag, const Columns<T>& cols,
                const SweepRowStrides& rs, const T* b, const T* x, T* y,
                const SweepTile& tl, int nb, int rows, int sweeps, T relax,
                T omr, cudaStream_t stream) {
  switch (cols.K) {
    case 2:
      return launch_tile_k<T, 2>(diag, cols, rs, b, x, y, tl, nb, rows,
                                 sweeps, relax, omr, stream);
    case 4:
      return launch_tile_k<T, 4>(diag, cols, rs, b, x, y, tl, nb, rows,
                                 sweeps, relax, omr, stream);
    case 6:
      return launch_tile_k<T, 6>(diag, cols, rs, b, x, y, tl, nb, rows,
                                 sweeps, relax, omr, stream);
    default:  // the wrapper sends other column counts to the per-sweep kernel
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Sweep s reads x0 (s = 0) or buf[(s - 1) % 2] and writes buf[s % 2];
// the result is in buf[(sweeps - 1) % 2]. batch_strides == nullptr: the
// batch shares the matrix; otherwise diag_bs and batch_strides[k] step
// diag and column k by batch row (the per-row instance).
template <typename T>
int launch_jacobi_sweeps(const void* diag, long long diag_bs,
                         const void* const* cols, const long long* strides,
                         const long long* batch_strides,
                         const long long* offsets, int K, const void* b,
                         const void* x0, void* buf0, void* buf1, long long C,
                         int B, int sweeps, double relaxation,
                         cudaStream_t stream) {
  if (batch_strides != nullptr && B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Columns<T> c = make_columns<T>(cols, strides, offsets, K);
  T* bufs[2] = {static_cast<T*>(buf0), static_cast<T*>(buf1)};
  const T relax = static_cast<T>(relaxation);
  const T omr = static_cast<T>(1.0 - relaxation);
  const T* src = static_cast<const T*>(x0);
  SweepRowStrides rs{};
  if (batch_strides != nullptr) {
    rs.diag = diag_bs;
    for (int k = 0; k < K; ++k) rs.col[k] = batch_strides[k];
  }
  for (int s = 0; s < sweeps; ++s) {
    T* dst = bufs[s % 2];
    if (batch_strides != nullptr) {
      const dim3 grid(grid_blocks(C), static_cast<unsigned>(B));
      jacobi_sweep_kernel<T, true><<<grid, kThreads, 0, stream>>>(
          static_cast<const T*>(diag), c, rs, static_cast<const T*>(b), src,
          dst, C, B, relax, omr);
    } else {
      jacobi_sweep_kernel<T, false><<<grid_blocks(C), kThreads, 0, stream>>>(
          static_cast<const T*>(diag), c, rs, static_cast<const T*>(b), src,
          dst, C, B, relax, omr);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}

// `sweeps` sweeps in launches of at most `depth` sweeps over tiles of
// (bx, by, bz) cells with a halo of `depth`; a shared matrix takes the
// batch in groups of up to three rows, a launch per group, one matrix
// per batch row (batch_strides != nullptr) every row in one launch. Pass
// p reads x0 (p = 0) or buf[(p - 1) % 2] and writes buf[p % 2]; the
// result is in buf[(passes - 1) % 2], passes = ceil(sweeps / depth).
template <typename T>
int launch_jacobi_tiles(const void* diag, long long diag_bs,
                        const void* const* cols, const long long* strides,
                        const long long* batch_strides,
                        const long long* offsets, int K, const void* b,
                        const void* x0, void* buf0, void* buf1, long long C,
                        int B, int sweeps, double relaxation, long long nx,
                        long long ny, long long nz, int depth, int bx, int by,
                        int bz, cudaStream_t stream) {
  SweepTile tl;
  if (!make_sweep_tile(offsets, K, nx, ny, nz, C, bx, by, bz, depth,
                       kTileThreads * tile_cells<T>(), &tl)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles =
      static_cast<long long>(tl.tx) * tl.ty * ((nz + bz - 1) / bz);
  if (tiles > 2147483647LL || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Columns<T> c = make_columns<T>(cols, strides, offsets, K);
  SweepRowStrides rs{};
  if (batch_strides != nullptr) {
    rs.diag = diag_bs;
    for (int k = 0; k < K; ++k) rs.col[k] = batch_strides[k];
  }
  T* bufs[2] = {static_cast<T*>(buf0), static_cast<T*>(buf1)};
  const T relax = static_cast<T>(relaxation);
  const T omr = static_cast<T>(1.0 - relaxation);
  const T* src = static_cast<const T*>(x0);
  const T* dg = static_cast<const T*>(diag);
  const T* bb = static_cast<const T*>(b);
  int pass = 0;
  for (int done = 0; done < sweeps; done += depth, ++pass) {
    const int n = sweeps - done < depth ? sweeps - done : depth;
    T* dst = bufs[pass % 2];
    if (batch_strides != nullptr) {
      const int err = launch_tile<T>(dg, c, rs, bb, src, dst, tl, 0, B, n,
                                     relax, omr, stream);
      if (err != 0) return err;
    } else {
      for (int g = 0; g < B; g += 3) {
        const int nb = B - g < 3 ? B - g : 3;
        const int err = launch_tile<T>(dg, c, rs, bb + g * C, src + g * C,
                                       dst + g * C, tl, nb, 1, n, relax, omr,
                                       stream);
        if (err != 0) return err;
      }
    }
    src = dst;
  }
  return 0;
}

// --- jacobi_march_kernel: temporal blocking that marches along z ------

// Threads of a marching CTA, the window slots each owns (the xy window
// holds at most kMarchThreads * kMarchQ cells) and the deepest march.
constexpr int kMarchThreads = 512;
constexpr int kMarchQ = 2;
constexpr int kMaxMarchDepth = 3;
// The xy window and z-chunk of a marching CTA on an nx x ny x nz box
// (every extent > 1).
struct MarchTile {
  long long C;
  int nx, ny, nz;
  int bx, by, bz;      // tile cells along x and y; planes of a z-chunk
  int wx, wy, W;       // the window: the tile and S cells on each side
  int ps;              // slots of a ring plane: the window and wx a side
  int tx, ty;          // tiles along x and y
  int dq[kTileK];      // in-plane window step of column k
  int dz[kTileK];      // plane step of column k (-1, 0 or 1)
};

// Shared memory of a marching CTA: a ring of three planes of NB
// components for each of levels 0..S-1.
template <typename T>
size_t march_smem(int S, int nb, int ps) {
  return static_cast<size_t>(3) * S * nb * ps * sizeof(T);
}

// The march over tiles of (bx, by) cells and z-chunks of bz planes with
// a halo of S cells in x, y and z, or false when a column is not a step
// along an axis (or 0), the box is not 3-D or the window does not fit.
inline bool make_march_tile(const long long* offsets, int K, long long nx,
                            long long ny, long long nz, long long C, int bx,
                            int by, int bz, int S, MarchTile* t) {
  if (K != kTileK || nx < 2 || ny < 2 || nz < 2 || nx * ny * nz != C ||
      C >= (1LL << 30) || bx < 1 || by < 1 || bz < 1 || S < 1 ||
      S > kMaxMarchDepth) {
    return false;
  }
  MarchTile m{};
  m.C = C;
  m.nx = static_cast<int>(nx);
  m.ny = static_cast<int>(ny);
  m.nz = static_cast<int>(nz);
  m.bx = bx;
  m.by = by;
  m.bz = bz;
  m.wx = bx + 2 * S;
  m.wy = by + 2 * S;
  const long long W = static_cast<long long>(m.wx) * m.wy;
  if (W > kMarchThreads * kMarchQ) return false;
  m.W = static_cast<int>(W);
  m.ps = m.W + 2 * m.wx;
  m.tx = static_cast<int>((nx + bx - 1) / bx);
  m.ty = static_cast<int>((ny + by - 1) / by);
  for (int k = 0; k < K; ++k) {
    const long long d = offsets[k];
    const long long a = d < 0 ? -d : d;
    const int sign = d < 0 ? -1 : 1;
    m.dq[k] = 0;
    m.dz[k] = 0;
    if (d == 0) {
    } else if (a == 1) {
      m.dq[k] = sign;
    } else if (a == nx) {
      m.dq[k] = sign * m.wx;
    } else if (a == nx * ny) {
      m.dz[k] = sign;
    } else {
      return false;
    }
  }
  *t = m;
  return true;
}

// floor(a / b) for b > 0.
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ int mod3(int v) {
  const int r = v % 3;
  return r < 0 ? r + 3 : r;
}

// A plane's coefficients at one window slot.
template <typename T, int NB>
struct SlotCoef {
  T d, inv_d, o[kTileK], b[NB];
};

// One CTA per (xy tile, z-chunk). The CTA walks the chunk's planes from
// z0 - S to z0 + bz + S - 1, one a step: level 0 stages plane p0 of x0;
// level s (1..S) then computes plane p0 - s from level s - 1's planes
// p0 - s - 1, p0 - s and p0 - s + 1, once that level holds them (step
// t >= 2 s), and level S writes the tile's cells of its plane, once in
// [z0, z0 + bz), to y. Levels 0..S-1 keep a ring of three planes of the
// window in shared memory, a slot's NB components side by side and each
// plane padded by wx slots a side, so that every in-plane step stays
// inside it and one address serves every component; a barrier separates
// the levels. Thread t owns window slots q = t + j kMarchThreads (j <
// kMarchQ) in every plane and computes them at every level: a slot less
// than s cells from the window's x or y edge reads stale or padding
// values at level s, which only such slots use; a slot whose row lies
// outside [0, C) holds 0 at every level. Each step first starts its
// global loads, x0's plane p0 and the coefficients (diag, 1 / diag, the
// columns, b) of plane p0 - 1, which level 1 uses; level s + 1 uses the
// same plane's coefficients a step later, so each thread carries them
// in registers from level to level and reads each plane's once.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (kernel_ab.py, 128^3 f32
// K=6 B=3, six sweeps, ms; the per-sweep kernel 0.388): S = 3 in 26 x 26
// x 26 tiles (125 CTAs, one an SM) 0.263, S = 2 0.303, S = 1 0.440;
// 32 x 32 windows over 16-plane chunks (two waves) 0.321. Before the
// components sat side by side (S = 3, 0.281): each level reading its
// plane's coefficients again through L1 / L2 0.364, level 1 staging them
// in shared memory 0.342, cp.async of the next step's plane and
// coefficients 0.294, 1024 threads x 1 slot no faster. A barrier phase
// (S + 1 a plane) took 1.0-1.2 us at every depth and mode: the phases'
// work, not memory traffic, bounds the march (PERF.md).
template <typename T, int NB, int S>
__global__ void __launch_bounds__(kMarchThreads, 1)
    jacobi_march_kernel(const T* __restrict__ diag, Columns<T> cols,
                        const T* __restrict__ b, const T* __restrict__ x,
                        T* __restrict__ y, MarchTile mt, T relax,
                        T one_minus_relax) {
  constexpr int Q = kMarchQ;
  constexpr int K = kTileK;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ps = mt.ps;
  // Level l's ring plane r, slot q, component n:
  // xr + (3 l + r) * NB * ps + q * NB + n.
  T* xr = reinterpret_cast<T*>(smem) + mt.wx * NB;
  const long long C = mt.C;
  const long long nxy = static_cast<long long>(mt.nx) * mt.ny;
  const int tile = static_cast<int>(blockIdx.x);
  const int ty = tile / mt.tx;
  const int tx = tile - ty * mt.tx;
  const int ox = tx * mt.bx - S;
  const int oy = ty * mt.by - S;
  const int z0 = static_cast<int>(blockIdx.y) * mt.bz;
  const int planes = min(mt.bz, mt.nz - z0);
  const int t = static_cast<int>(threadIdx.x);

  long long rxy[Q];    // row of the slot's cell in plane 0
  int plo[Q], phi[Q];  // the planes whose row of the slot lies in [0, C)
  bool in[Q];          // the slot lies in the window
  bool own[Q];         // the slot is one of the tile's cells inside the box
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int q = t + j * kMarchThreads;
    const int sy = q / mt.wx;
    const int sx = q - sy * mt.wx;
    const int gx = ox + sx, gy = oy + sy;
    in[j] = q < mt.W;
    rxy[j] = gx + static_cast<long long>(mt.nx) * gy;
    // rxy + nxy p >= 0 and < C: p from ceil(-rxy / nxy) to
    // floor((C - 1 - rxy) / nxy).
    plo[j] = static_cast<int>(-floor_div(rxy[j], nxy));
    phi[j] = static_cast<int>(floor_div(C - 1 - rxy[j], nxy));
    own[j] = in[j] && sx >= S && sx < mt.wx - S && sy >= S &&
             sy < mt.wy - S && gx < mt.nx && gy < mt.ny;
  }

  SlotCoef<T, NB> co[S][Q];  // co[s - 1]: the coefficients level s uses
  for (int step = 0; step < planes + 2 * S; ++step) {
    const int p0 = z0 - S + step;
#pragma unroll
    for (int l = S - 1; l > 0; --l) {
#pragma unroll
      for (int j = 0; j < Q; ++j) co[l][j] = co[l - 1][j];
    }
    // The step's global loads: x0's plane p0 and plane p0 - 1's
    // coefficients, branch-free (row 0 read, and discarded, for a slot
    // outside [0, C); diag taken as 1 there).
    T xin[Q][NB];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const bool ok = in[j] && p0 >= plo[j] && p0 <= phi[j];
      const long long rr = ok ? rxy[j] + nxy * p0 : 0;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const T v = x[n * C + rr];
        xin[j][n] = ok ? v : T(0);
      }
      const bool okc = in[j] && p0 - 1 >= plo[j] && p0 - 1 <= phi[j];
      const long long rc = okc ? rxy[j] + nxy * (p0 - 1) : 0;
      const T dv = diag[rc];
      co[0][j].d = okc ? dv : T(1);
#pragma unroll
      for (int k = 0; k < K; ++k) co[0][j].o[k] = cols.col[k][rc * cols.stride[k]];
#pragma unroll
      for (int n = 0; n < NB; ++n) co[0][j].b[n] = b[n * C + rc];
      co[0][j].inv_d = T(1) / co[0][j].d;
    }
    T* x0p = xr + mod3(p0) * NB * ps;
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int q = t + j * kMarchThreads;
      if (in[j]) {
#pragma unroll
        for (int n = 0; n < NB; ++n) x0p[q * NB + n] = xin[j][n];
      }
    }
    __syncthreads();

#pragma unroll
    for (int s = 1; s <= S; ++s) {
      if (step >= 2 * s) {
        const int p = p0 - s;
        // Level s - 1's ring; the offsets into it of plane p (the cell)
        // and of column k's neighbour; level s's plane p.
        const T* src = xr + 3 * (s - 1) * NB * ps;
        const int rc = mod3(p) * NB * ps;
        int rk[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          rk[k] = mod3(p + mt.dz[k]) * NB * ps + mt.dq[k] * NB;
        }
        T* out = xr + (3 * s + mod3(p)) * NB * ps;
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          const int q = t + j * kMarchThreads;
          if (!in[j]) continue;
          const bool ok = p >= plo[j] && p <= phi[j];
          const SlotCoef<T, NB>& c = co[s - 1][j];
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            const T* xs = src + q * NB + n;
            const T xc = xs[rc];
            T mv = mul_rn(c.d, xc);
#pragma unroll
            for (int k = 0; k < K; ++k) mv = fma_rn(c.o[k], xs[rk[k]], mv);
            const T ax_off = fma_rn(-c.d, xc, mv);
            const T rv = fma_rn(c.b[n], c.inv_d, -mul_rn(ax_off, c.inv_d));
            const T xn = fma_rn(xc, one_minus_relax, mul_rn(rv, relax));
            if (s < S) {
              out[q * NB + n] = ok ? xn : T(0);
            } else if (own[j]) {
              y[n * C + rxy[j] + nxy * p] = xn;
            }
          }
        }
      }
      __syncthreads();
    }
  }
}

template <typename T, int NB, int S>
int launch_march_s(const T* diag, const Columns<T>& cols, const T* b,
                   const T* x, T* y, const MarchTile& mt, T relax, T omr,
                   cudaStream_t stream) {
  const size_t smem = march_smem<T>(S, NB, mt.ps);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        jacobi_march_kernel<T, NB, S>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(mt.tx * mt.ty),
                  static_cast<unsigned>((mt.nz + mt.bz - 1) / mt.bz));
  jacobi_march_kernel<T, NB, S><<<grid, kMarchThreads, smem, stream>>>(
      diag, cols, b, x, y, mt, relax, omr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NB>
int launch_march_nb(const T* diag, const Columns<T>& cols, const T* b,
                    const T* x, T* y, const MarchTile& mt, int S, T relax,
                    T omr, cudaStream_t stream) {
  switch (S) {
    case 1:
      return launch_march_s<T, NB, 1>(diag, cols, b, x, y, mt, relax, omr,
                                      stream);
    case 2:
      return launch_march_s<T, NB, 2>(diag, cols, b, x, y, mt, relax, omr,
                                      stream);
    default:
      return launch_march_s<T, NB, 3>(diag, cols, b, x, y, mt, relax, omr,
                                      stream);
  }
}

// `sweeps` sweeps in marches of at most `depth` sweeps (a shallower
// last pass keeps the tile and narrows the halo); the batch in groups of
// up to three rows, a launch per group. Pass p reads x0 (p = 0) or
// buf[(p - 1) % 2] and writes buf[p % 2]; the result is in
// buf[(passes - 1) % 2], passes = ceil(sweeps / depth).
template <typename T>
int launch_jacobi_march(const void* diag, const void* const* cols,
                        const long long* strides, const long long* offsets,
                        int K, const void* b, const void* x0, void* buf0,
                        void* buf1, long long C, int B, int sweeps,
                        double relaxation, long long nx, long long ny,
                        long long nz, int depth, int bx, int by, int bz,
                        cudaStream_t stream) {
  MarchTile mt;
  if (!make_march_tile(offsets, K, nx, ny, nz, C, bx, by, bz, depth, &mt) ||
      (nz + bz - 1) / bz > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Columns<T> c = make_columns<T>(cols, strides, offsets, K);
  T* bufs[2] = {static_cast<T*>(buf0), static_cast<T*>(buf1)};
  const T relax = static_cast<T>(relaxation);
  const T omr = static_cast<T>(1.0 - relaxation);
  const T* src = static_cast<const T*>(x0);
  const T* dg = static_cast<const T*>(diag);
  const T* bv = static_cast<const T*>(b);
  int pass = 0;
  for (int done = 0; done < sweeps; done += depth, ++pass) {
    const int n = sweeps - done < depth ? sweeps - done : depth;
    if (n != depth &&
        !make_march_tile(offsets, K, nx, ny, nz, C, bx, by, bz, n, &mt)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    T* dst = bufs[pass % 2];
    for (int g = 0; g < B; g += 3) {
      const int nb = B - g < 3 ? B - g : 3;
      const T* bg = bv + g * C;
      const T* sg = src + g * C;
      T* dstg = dst + g * C;
      const int err =
          nb == 1 ? launch_march_nb<T, 1>(dg, c, bg, sg, dstg, mt, n, relax,
                                          omr, stream)
          : nb == 2 ? launch_march_nb<T, 2>(dg, c, bg, sg, dstg, mt, n,
                                            relax, omr, stream)
                    : launch_march_nb<T, 3>(dg, c, bg, sg, dstg, mt, n,
                                            relax, omr, stream);
      if (err != 0) return err;
    }
    src = dst;
  }
  return 0;
}

}  // namespace orc

// depth 0: a launch per sweep (jacobi_sweep_kernel); depth >= 1: tiles of
// (bx, by, bz) cells of the (nx, ny, nz) box, at most `depth` sweeps a
// launch (jacobi_tile_kernel).
extern "C" int orc_jacobi_sweeps(int dtype, const void* diag,
                                 const void* const* cols,
                                 const long long* strides,
                                 const long long* offsets, int K,
                                 const void* b, const void* x0, void* buf0,
                                 void* buf1, long long C, int B, int sweeps,
                                 double relaxation, long long nx,
                                 long long ny, long long nz, int depth,
                                 int bx, int by, int bz, void* stream) {
  if (K < 0 || K > orc::MAX_K || B < 1 || sweeps < 1 || C < 0 || depth < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (depth > 0) {
    if (dtype == orc::kF32) {
      return orc::launch_jacobi_tiles<float>(
          diag, 0, cols, strides, nullptr, offsets, K, b, x0, buf0, buf1, C,
          B, sweeps, relaxation, nx, ny, nz, depth, bx, by, bz, s);
    }
    if (dtype == orc::kF64) {
      return orc::launch_jacobi_tiles<double>(
          diag, 0, cols, strides, nullptr, offsets, K, b, x0, buf0, buf1, C,
          B, sweeps, relaxation, nx, ny, nz, depth, bx, by, bz, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == orc::kF32) {
    return orc::launch_jacobi_sweeps<float>(diag, 0, cols, strides, nullptr,
                                            offsets, K, b, x0, buf0, buf1, C,
                                            B, sweeps, relaxation, s);
  }
  if (dtype == orc::kF64) {
    return orc::launch_jacobi_sweeps<double>(diag, 0, cols, strides, nullptr,
                                             offsets, K, b, x0, buf0, buf1,
                                             C, B, sweeps, relaxation, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// One matrix per batch row: diag of row b at diag + b * diag_bs, column
// k at cols[k] + b * batch_strides[k]; depth 0: a launch per sweep
// (jacobi_sweep_kernel), depth >= 1: tiles of (bx, by, bz) cells of the
// (nx, ny, nz) box, at most `depth` sweeps a launch, every batch row in
// one launch (jacobi_tile_kernel's per-row instance).
extern "C" int orc_jacobi_sweeps_rows(
    int dtype, const void* diag, long long diag_bs, const void* const* cols,
    const long long* strides, const long long* batch_strides,
    const long long* offsets, int K, const void* b, const void* x0,
    void* buf0, void* buf1, long long C, int B, int sweeps,
    double relaxation, long long nx, long long ny, long long nz, int depth,
    int bx, int by, int bz, void* stream) {
  if (K < 0 || K > orc::MAX_K || B < 1 || sweeps < 1 || C < 0 ||
      depth < 0 || batch_strides == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (depth > 0) {
    if (dtype == orc::kF32) {
      return orc::launch_jacobi_tiles<float>(
          diag, diag_bs, cols, strides, batch_strides, offsets, K, b, x0,
          buf0, buf1, C, B, sweeps, relaxation, nx, ny, nz, depth, bx, by, bz,
          s);
    }
    if (dtype == orc::kF64) {
      return orc::launch_jacobi_tiles<double>(
          diag, diag_bs, cols, strides, batch_strides, offsets, K, b, x0,
          buf0, buf1, C, B, sweeps, relaxation, nx, ny, nz, depth, bx, by, bz,
          s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == orc::kF32) {
    return orc::launch_jacobi_sweeps<float>(
        diag, diag_bs, cols, strides, batch_strides, offsets, K, b, x0, buf0,
        buf1, C, B, sweeps, relaxation, s);
  }
  if (dtype == orc::kF64) {
    return orc::launch_jacobi_sweeps<double>(
        diag, diag_bs, cols, strides, batch_strides, offsets, K, b, x0, buf0,
        buf1, C, B, sweeps, relaxation, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// A 3-D box of steps, shared matrix: marches of at most `depth` sweeps
// over xy tiles of (bx, by) cells and z-chunks of bz planes
// (jacobi_march_kernel).
extern "C" int orc_jacobi_march(int dtype, const void* diag,
                                const void* const* cols,
                                const long long* strides,
                                const long long* offsets, int K,
                                const void* b, const void* x0, void* buf0,
                                void* buf1, long long C, int B, int sweeps,
                                double relaxation, long long nx,
                                long long ny, long long nz, int depth,
                                int bx, int by, int bz, void* stream) {
  if (K < 0 || K > orc::MAX_K || B < 1 || sweeps < 1 || C < 0 || depth < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == orc::kF32) {
    return orc::launch_jacobi_march<float>(
        diag, cols, strides, offsets, K, b, x0, buf0, buf1, C, B, sweeps,
        relaxation, nx, ny, nz, depth, bx, by, bz, s);
  }
  if (dtype == orc::kF64) {
    return orc::launch_jacobi_march<double>(
        diag, cols, strides, offsets, K, b, x0, buf0, buf1, C, B, sweeps,
        relaxation, nx, ny, nz, depth, bx, by, bz, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
