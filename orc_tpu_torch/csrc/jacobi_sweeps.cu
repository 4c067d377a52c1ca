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
// Two instances, picked by the wrapper from the offsets alone
// (orc_tpu_torch/ops/fused_smooth.py `sweep_plan`):
//
// jacobi_tile_kernel (temporal blocking on box tiles). On a box whose
// every column steps one cell along an axis (or is a padding column of
// offset 0), cell (x, y, z) is row x + nx (y + ny z). A CTA takes a tile
// of bx x by x bz cells and stages a window of x around it, H cells
// deeper on every axis of extent > 1, in shared memory as ping-pong
// buffers; diag, the columns and b of the window stay in the registers
// of the thread that owns each window cell (Q cells a thread), so the
// window holds at most 2048 float32 (1024 float64) cells: 38 x 28 tiles
// in 50 x 40 windows on the 1024^2 cavity at six sweeps. Sweep s updates
// the window cells at least s cells from its edge, a barrier apart, and
// after `sweeps` <= H sweeps the tile's cells are written out: the
// matrix and b are read once (and the halo again from L2), x once, the
// result written once, for all sweeps in one launch. A window slot
// holds row x + nx (y + ny z) of its box coordinates whenever that row
// lies in [0, C) and 0 otherwise, so its step neighbours are the rows
// i + d_k whichever face they cross: the tile computes exactly what the
// per-sweep kernel does, coefficient for coefficient. The TPU kernel
// blocks the flat row index instead; on the 1024^2 cavity that needs
// halos of sweeps * 1024 rows, which no Hopper CTA can stage.
//
// jacobi_sweep_kernel (a launch per sweep, the first design) takes the
// other matrices: periodic boxes, whose wrap columns step across the
// box, column counts other than 2, 4 and 6, and 3-D boxes, where a
// window as deep as two sweeps holds three times the tile's cells. One
// thread per row reads diag and its K coefficients once and updates all
// B components. Its per-row instance (template flag PR, entry point
// `orc_jacobi_sweeps_rows`) takes one matrix per batch row (the CD2 and
// in-matrix TVD momentum systems): diag and column k of batch row b
// start a batch-row stride further on, and the thread reads each
// row's coefficients in the batch loop. Per row the function moves
// (1 + K + 3) B values a row (diag, the K columns, b and x0 read, x
// written): 24 float32 planes, 100.7 MB, 30.0 us
// at 3.35 TB/s on the 1024^2 TVD cavity (B = 3, K = 4); the launch per
// sweep reads the matrix and x again every sweep. The tile kernel keeps
// one matrix in registers and is not instantiated per row.
//
// The arithmetic of a row is the first design's as nvcc contracted it
// (its SASS on sm_90a): diag * x rounded, one fused multiply-add per
// column in order, ax_off = fma(-diag, x, mv), the product ax_off *
// inv_d rounded, fma(b, inv_d, -that) (b / diag is never rounded on its
// own), times w rounded, then fma(x, 1 - w, that). The tile kernel
// spells it out with mul_rn / fma_rn, so both instances agree bit for
// bit.
#include "common.cuh"

namespace orc {

// Batch-row strides (elements) of a per-row matrix: diag and each
// column of batch row b start at b * stride.
struct SweepRowStrides {
  long long diag;
  long long col[MAX_K];
};

template <typename T, bool PR>
__global__ void jacobi_sweep_kernel(const T* __restrict__ diag,
                                    Columns<T> cols, SweepRowStrides rs,
                                    const T* __restrict__ b,
                                    const T* __restrict__ x,
                                    T* __restrict__ x_new, long long C,
                                    int B, T relax, T one_minus_relax) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < C; i += step) {
    T d = diag[i];
    T inv_d = T(1) / d;
    T o[MAX_K];
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) {
      o[k] = (k < cols.K) ? cols.col[k][i * cols.stride[k]] : T(0);
    }
    for (int bb = 0; bb < B; ++bb) {
      if constexpr (PR) {
        if (bb > 0) {
          d = diag[bb * rs.diag + i];
          inv_d = T(1) / d;
#pragma unroll
          for (int k = 0; k < MAX_K; ++k) {
            o[k] = (k < cols.K)
                       ? cols.col[k][bb * rs.col[k] + i * cols.stride[k]]
                       : T(0);
          }
        }
      }
      const T* xb = x + bb * C;
      const T xc = xb[i];
      T mv = d * xc;
#pragma unroll
      for (int k = 0; k < MAX_K; ++k) {
        if (k < cols.K) {
          const long long j = i + cols.offset[k];
          const T xv = (j >= 0 && j < C) ? xb[j] : T(0);
          mv = mv + o[k] * xv;
        }
      }
      const T ax_off = mv - d * xc;
      const T b_prime = b[bb * C + i] * inv_d;
      x_new[bb * C + i] =
          relax * (b_prime - ax_off * inv_d) + one_minus_relax * xc;
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
template <typename T, int NB, int K>
__global__ void __launch_bounds__(kTileThreads, 1)
    jacobi_tile_kernel(const T* __restrict__ diag, Columns<T> cols,
                       const T* __restrict__ b, const T* __restrict__ x,
                       T* __restrict__ y, SweepTile tl, int sweeps,
                       T relax, T one_minus_relax) {
  constexpr int Q = tile_cells<T>();
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
      for (int k = 0; k < K; ++k) o[j][k] = cols.col[k][rr * cols.stride[k]];
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

template <typename T, int NB, int K>
int launch_tile_nb(const T* diag, const Columns<T>& cols, const T* b,
                   const T* x, T* y, const SweepTile& tl, int sweeps,
                   T relax, T omr, cudaStream_t stream) {
  const size_t smem =
      2 * NB * 3 * kTileThreads * tile_cells<T>() * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        jacobi_tile_kernel<T, NB, K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long tiles = static_cast<long long>(tl.tx) * tl.ty *
                          ((tl.nz + tl.bz - 1) / tl.bz);
  jacobi_tile_kernel<T, NB, K>
      <<<static_cast<unsigned>(tiles), kTileThreads, smem, stream>>>(
          diag, cols, b, x, y, tl, sweeps, relax, omr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int launch_tile_k(const T* diag, const Columns<T>& cols, const T* b,
                  const T* x, T* y, const SweepTile& tl, int nb, int sweeps,
                  T relax, T omr, cudaStream_t stream) {
  switch (nb) {
    case 1:
      return launch_tile_nb<T, 1, K>(diag, cols, b, x, y, tl, sweeps, relax,
                                     omr, stream);
    case 2:
      return launch_tile_nb<T, 2, K>(diag, cols, b, x, y, tl, sweeps, relax,
                                     omr, stream);
    default:
      return launch_tile_nb<T, 3, K>(diag, cols, b, x, y, tl, sweeps, relax,
                                     omr, stream);
  }
}

template <typename T>
int launch_tile(const T* diag, const Columns<T>& cols, const T* b,
                const T* x, T* y, const SweepTile& tl, int nb, int sweeps,
                T relax, T omr, cudaStream_t stream) {
  switch (cols.K) {
    case 2:
      return launch_tile_k<T, 2>(diag, cols, b, x, y, tl, nb, sweeps, relax,
                                 omr, stream);
    case 4:
      return launch_tile_k<T, 4>(diag, cols, b, x, y, tl, nb, sweeps, relax,
                                 omr, stream);
    case 6:
      return launch_tile_k<T, 6>(diag, cols, b, x, y, tl, nb, sweeps, relax,
                                 omr, stream);
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
      jacobi_sweep_kernel<T, true><<<grid_blocks(C), kThreads, 0, stream>>>(
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
// (bx, by, bz) cells with a halo of `depth`; the batch in groups of up
// to three rows, a launch per group. Pass p reads x0 (p = 0) or
// buf[(p - 1) % 2] and writes buf[p % 2]; the result is in buf[(passes
// - 1) % 2], passes = ceil(sweeps / depth).
template <typename T>
int launch_jacobi_tiles(const void* diag, const void* const* cols,
                        const long long* strides, const long long* offsets,
                        int K, const void* b, const void* x0, void* buf0,
                        void* buf1, long long C, int B, int sweeps,
                        double relaxation, long long nx, long long ny,
                        long long nz, int depth, int bx, int by, int bz,
                        cudaStream_t stream) {
  SweepTile tl;
  if (!make_sweep_tile(offsets, K, nx, ny, nz, C, bx, by, bz, depth,
                       kTileThreads * tile_cells<T>(), &tl)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles =
      static_cast<long long>(tl.tx) * tl.ty * ((nz + bz - 1) / bz);
  if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const Columns<T> c = make_columns<T>(cols, strides, offsets, K);
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
    for (int g = 0; g < B; g += 3) {
      const int nb = B - g < 3 ? B - g : 3;
      const int err = launch_tile<T>(dg, c, bb + g * C, src + g * C,
                                     dst + g * C, tl, nb, n, relax, omr,
                                     stream);
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
          diag, cols, strides, offsets, K, b, x0, buf0, buf1, C, B, sweeps,
          relaxation, nx, ny, nz, depth, bx, by, bz, s);
    }
    if (dtype == orc::kF64) {
      return orc::launch_jacobi_tiles<double>(
          diag, cols, strides, offsets, K, b, x0, buf0, buf1, C, B, sweeps,
          relaxation, nx, ny, nz, depth, bx, by, bz, s);
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

// One matrix per batch row, a launch per sweep: diag of row b at diag +
// b * diag_bs, column k at cols[k] + b * batch_strides[k].
extern "C" int orc_jacobi_sweeps_rows(int dtype, const void* diag,
                                      long long diag_bs,
                                      const void* const* cols,
                                      const long long* strides,
                                      const long long* batch_strides,
                                      const long long* offsets, int K,
                                      const void* b, const void* x0,
                                      void* buf0, void* buf1, long long C,
                                      int B, int sweeps, double relaxation,
                                      void* stream) {
  if (K < 0 || K > orc::MAX_K || B < 1 || sweeps < 1 || C < 0 ||
      batch_strides == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
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
