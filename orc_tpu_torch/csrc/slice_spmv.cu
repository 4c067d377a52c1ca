// Slice-plan SpMV and neighbour-value gather of irregular meshes on
// Hopper (sm_90a).
//
// Replaces: orc_tpu/ops/pallas_slice.py `_kernel` and `_kernel_heavy`
// (reached from `_slice_spmv_pallas`), `_kernel_wide` (from
// `_slice_spmv_pallas_wide`), `_kernel_exact` and `_kernel_wide_exact`
// (from `_slice_spmv_exact`), `_nbr_kernel` (from `_slice_nbr_pallas`)
// and `_nbr_kernel_wide` (from `_slice_nbr_pallas_wide`).
//
// The plan (orc_tpu_torch/mesh/reorder.py) groups the RCM-ordered cells
// into tiles of T rows; slice column j of tile t is one neighbour delta,
// starting at starts[t, j] in x padded by pad_lo zeros.
//
//   slice_spmv_kernel:
//     y[b,c] = diag[b?,c] x[b,c]
//            + sum_{j < tile_nj[t]} coef[b?,t,j,l] x[b, starts[t,j] - pad_lo + l]
//     with c = t*T + l < C and reads outside [0, C) taken as 0.
//   slice_spmv_exact_kernel (float32, the df32 residual of
//   solver/refine.py): the off-diagonal sum above with every product
//   an exact two-product and every accumulation a two-sum, as (y, err).
//   slice_nbr_kernel:
//     out[c,k,f] = x[c',f], c' = starts[t, col_tile[t,k,l]] - pad_lo + l,
//     at interior slots; x[c,f] elsewhere.
//
// Bound on the H100: device memory. The SpMV reads the used
// coefficients (sum_t tile_nj[t] * T values), x, diag and writes y; the
// exact product reads the same but diag and writes y and err (its ten
// float32 operations per coefficient stay far below the 67 TFLOP/s
// peak); the gather reads the interior mask, the column index of each
// interior slot and x, and writes C*K*F values, which dominate (at
// 1024^2 cells, K = 6, 9 float32 fields: 226 of 287 MB).
//
// Design of the SpMVs. The TPU kernels DMA one x window per group of
// tiles into VMEM and rotate 128-lane rows, statically unrolled over
// n_max (a dynamic trip count was 14x slower there), with the heavy
// tiles split off into a second kernel. On the card a dynamic loop
// bound costs nothing: thread l of a tile walks the tile's used columns
// only, reading coef[t, j, l] and the slice of x coalesced (consecutive
// threads, consecutive addresses; the RCM band keeps x in L2). The
// diagonal term is folded in and x is read unpadded with a bounds test,
// so no padded copy of x is made per matvec.
//
// The first design of both SpMVs took one CTA per (tile, batch row):
// slice_spmv_kernel ran 0.0073 ms for the 8,192-row couette (64 CTAs on
// 132 SMs) and 34% of HBM on a plan of 1024-row tiles (196 CTAs of 256
// threads, 1.48 waves, each thread four rows), the exact product 27%
// there, on an NVIDIA H100 80GB HBM3 at 700 W. Now both take:
//  - one CTA per (chunk of R rows of a tile, group of batch rows), R a
//    power of two, at most 128 and at least 32, halved until the grid
//    has 264 CTAs (two per SM), one row per thread;
//  - a matrix shared by the batch is read once for up to four batch
//    rows (a thread keeps one sum per row); one matrix per row takes a
//    CTA row per batch row;
//  - 32 registers at one batch row, so 16 CTAs share an SM;
//  - the exact product keeps one (acc, err) pair per batch row and its
//    error-free transforms in the first design's order.
// The starts are read from L1 (one address per warp) and one column at a
// time: staging them in shared memory and issuing the loads of 2, 4 or 8
// columns before their multiply-adds were each measured slower on the
// card (kernel_ab.py, PERF.md). The arithmetic is the first design's as
// nvcc contracted it: diag * x rounded, then one fused multiply-add per
// column in order (mul_rn, fma_rn), so the sums are unchanged bit for bit.
//
// Design of the gather. Its first design (one thread per (c, k) slot, a
// chain of four dependent loads, two divisions by runtime values, an
// F-value scalar copy) lost to torch's own x[cell_neighbors] on the
// H100: with F = 9 a warp's store touched nine times the sectors it
// filled. Now one CTA copies a chunk of R rows of one tile, whose
// output out[c0 : c0 + R] is one contiguous span of R*K*F values:
//   1. the source row of each of its R*K slots is resolved once, from
//      coalesced reads of col_tile (contiguous in l for each k) and the
//      interior mask, into shared memory;
//   2. the values are read with consecutive threads on consecutive
//      (l, f) of one slot column k, which in RCM order are consecutive
//      rows of x, and staged in shared memory in the [R, K, F] order of
//      the output;
//   3. the stage is written out with 16-byte stores.
// R is a power of two (so the thread-to-slot maps divide by constants
// only; F is a template parameter for 1, 3 and 9) chosen so the stage
// takes at most kNbrStageBytes and several CTAs share an SM. A row
// wider than the shared memory a CTA may use is copied straight to the
// output instead (same order, no stage). It stays a copy: bitwise
// equal to x[cell_neighbors].
#include <cstdint>

#include "common.cuh"

namespace orc {

// Rows of a slice SpMV CTA at most (one row per thread).
constexpr int kSpmvMaxRows = 128;

// One CTA per (chunk of R = blockDim.x rows of tile t, group of up to
// NB batch rows); thread l takes row c = t*tile + r0 + l. With one batch
// row, 32 registers let 16 CTAs share an SM.
template <typename T, int NB>
__global__ void __launch_bounds__(kSpmvMaxRows, NB == 1 ? 16 : 8)
    slice_spmv_kernel(const T* __restrict__ diag, long long diag_bs,
                      const T* __restrict__ coef, long long coef_bs,
                      const int* __restrict__ starts,
                      const int* __restrict__ tile_nj,
                      const T* __restrict__ x, T* __restrict__ y, int C,
                      int tile, int n_max, int pad_lo, int chunks, int B) {
  const int t = static_cast<int>(blockIdx.x) / chunks;
  const int r0 = (static_cast<int>(blockIdx.x) - t * chunks) *
                 static_cast<int>(blockDim.x);
  const int l = r0 + static_cast<int>(threadIdx.x);
  const int c = t * tile + l;
  if (l >= tile || c >= C) return;
  const int b0 = static_cast<int>(blockIdx.y) * NB;
  const int nb = min(NB, B - b0);
  // The tile's slice starts: one address for every thread of the tile,
  // served by L1.
  const int* st = starts + static_cast<long long>(t) * n_max;
  const int nj = tile_nj[t];
  // With one matrix per batch row the launcher sets NB = 1.
  const T* cb = coef + b0 * coef_bs +
                static_cast<long long>(t) * n_max * tile + l;
  const T* xb = x + static_cast<long long>(b0) * C;
  T acc[NB];
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    acc[q] = q < nb ? mul_rn(diag[(b0 + q) * diag_bs + c],
                             xb[static_cast<long long>(q) * C + c])
                    : T(0);
  }
  for (int j = 0; j < nj; ++j) {
    const int src = __ldg(st + j) - pad_lo + l;
    const bool in = static_cast<unsigned>(src) < static_cast<unsigned>(C);
    const T a = cb[static_cast<long long>(j) * tile];
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const T xv = (in && q < nb) ? xb[static_cast<long long>(q) * C + src]
                                  : T(0);
      acc[q] = fma_rn(a, xv, acc[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    if (q < nb) y[static_cast<long long>(b0 + q) * C + c] = acc[q];
  }
}

// Exact-accumulation product of the df32 residual (float32 only):
//   p = coef * x exactly as p + pe (pe by one FMA), acc = two_sum(acc, p)
//   with its error te, err += te + pe, over the tile's used columns in
//   order. Every operation is an explicitly rounded intrinsic: nvcc
//   contracts a * b + c into an FMA by default, which would make the
//   two-sum's error terms vanish, and the shared NVCC_FLAGS stay as they
//   are for every other kernel. Columns past tile_nj carry zero
//   coefficients and leave (acc, err) unchanged, so (y, err) equal the
//   plain version's n_max-column loop bit for bit.
//
// The CTAs are slice_spmv_kernel's: one per (chunk of R = blockDim.x
// rows of tile t, group of up to NB batch rows), one row per thread, a
// coefficient shared by the batch read once for all NB rows, each with
// its own (acc, err) pair.
template <int NB>
__global__ void __launch_bounds__(kSpmvMaxRows, NB == 1 ? 16 : 8)
    slice_spmv_exact_kernel(const float* __restrict__ coef,
                            long long coef_bs,
                            const int* __restrict__ starts,
                            const int* __restrict__ tile_nj,
                            const float* __restrict__ x,
                            float* __restrict__ y, float* __restrict__ err_out,
                            int C, int tile, int n_max, int pad_lo,
                            int chunks, int B) {
  const int t = static_cast<int>(blockIdx.x) / chunks;
  const int r0 = (static_cast<int>(blockIdx.x) - t * chunks) *
                 static_cast<int>(blockDim.x);
  const int l = r0 + static_cast<int>(threadIdx.x);
  const int c = t * tile + l;
  if (l >= tile || c >= C) return;
  const int b0 = static_cast<int>(blockIdx.y) * NB;
  const int nb = min(NB, B - b0);
  const int* st = starts + static_cast<long long>(t) * n_max;
  const int nj = tile_nj[t];
  // With one matrix per batch row the launcher sets NB = 1.
  const float* cb = coef + b0 * coef_bs +
                    static_cast<long long>(t) * n_max * tile + l;
  const float* xb = x + static_cast<long long>(b0) * C;
  float acc[NB], err[NB];
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    acc[q] = 0.0f;
    err[q] = 0.0f;
  }
  // Eight columns unrolled, their loads issued ahead of the transforms:
  // at 448^2 0.0067 (B=1) and 0.0105 (B=3) ms against 0.0070 and
  // 0.0106 unrolled by four and 0.0070 and 0.0109 as the compiler
  // chose, the 1024-row plan alike, on an NVIDIA H100 80GB HBM3 at
  // 700 W (kernel_ab.py). Four for four batch rows, which spill
  // unrolled by eight within the 64 registers of 8 CTAs an SM.
#pragma unroll(NB == 4 ? 4 : 8)
  for (int j = 0; j < nj; ++j) {
    const int src = __ldg(st + j) - pad_lo + l;
    const bool in = static_cast<unsigned>(src) < static_cast<unsigned>(C);
    const float a = cb[static_cast<long long>(j) * tile];
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const float xv =
          (in && q < nb) ? xb[static_cast<long long>(q) * C + src] : 0.0f;
      const float p = __fmul_rn(a, xv);
      const float pe = __fmaf_rn(a, xv, -p);
      const float s = __fadd_rn(acc[q], p);
      const float bb = __fsub_rn(s, acc[q]);
      const float te = __fadd_rn(__fsub_rn(acc[q], __fsub_rn(s, bb)),
                                 __fsub_rn(p, bb));
      acc[q] = s;
      err[q] = __fadd_rn(err[q], __fadd_rn(te, pe));
    }
  }
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    if (q < nb) {
      y[static_cast<long long>(b0 + q) * C + c] = acc[q];
      err_out[static_cast<long long>(b0 + q) * C + c] = err[q];
    }
  }
}

// Shared memory a gather chunk's stage may take: 16 KB lets the 227 KB
// of an SM hold eight 256-thread CTAs with their slot tables.
constexpr int kNbrStageBytes = 16384;
// A row (K*F values) wider than this is copied straight to the output.
constexpr int kNbrMaxStageBytes = 40960;

template <typename T, int FT>
__global__ void __launch_bounds__(kThreads)
    slice_nbr_kernel(const T* __restrict__ x,
                     const unsigned char* __restrict__ interior,
                     const int* __restrict__ starts,
                     const int* __restrict__ col_tile, T* __restrict__ out,
                     int C, int K, int f_rt, int tile, int n_max, int pad_lo,
                     int lg_r, int chunks, int staged) {
  const int F = FT > 0 ? FT : f_rt;
  const int t = static_cast<int>(blockIdx.x) / chunks;
  const int r0 = (static_cast<int>(blockIdx.x) - t * chunks) << lg_r;
  const int c0 = t * tile + r0;  // the launcher checks (C + tile) * K fits
  const int rows = min(1 << lg_r, min(tile - r0, C - c0));
  if (rows <= 0) return;
  const int* st = starts + static_cast<long long>(t) * n_max;
  const int* ct = col_tile + static_cast<long long>(t) * K * tile + r0;
  const unsigned char* in = interior + static_cast<long long>(c0) * K;
  T* dst = out + static_cast<long long>(c0) * K * F;
  if (!staged) {  // one row (lg_r = 0), slot by slot, F values each
    for (int k = 0; k < K; ++k) {
      const int s = in[k] ? __ldg(st + ct[k * tile]) - pad_lo + r0 : c0;
      const T* xs = x + static_cast<long long>(s) * F;
      T* o = dst + static_cast<long long>(k) * F;
      for (int f = threadIdx.x; f < F; f += blockDim.x) o[f] = xs[f];
    }
    return;
  }
  // The stage starts as far past a 16-byte boundary as dst does, so the
  // two align together.
  extern __shared__ __align__(16) unsigned char smem[];
  int* src = reinterpret_cast<int*>(smem);  // [K][R]
  const int n = rows * K * F;
  constexpr int V = 16 / sizeof(T);
  const int mis =
      static_cast<int>((reinterpret_cast<uintptr_t>(dst) & 15) / sizeof(T));
  const int src_bytes = ((K << lg_r) * 4 + 15) & ~15;
  T* stage = reinterpret_cast<T*>(smem + src_bytes) + mis;
  // 1. The source row of every (k, l) slot of the chunk, q = l + R*k;
  // with one field its value is read at once (steps 1 and 2 in one).
  const int mask = (1 << lg_r) - 1;
#pragma unroll 4
  for (int q = threadIdx.x; q < (K << lg_r); q += blockDim.x) {
    const int l = q & mask;
    if (l < rows) {
      const int k = q >> lg_r;
      const int s = in[l * K + k]
                        ? __ldg(st + ct[k * tile + l]) - pad_lo + r0 + l
                        : c0 + l;
      if constexpr (FT == 1) {
        stage[l * K + k] = x[s];
      } else {
        src[q] = s;
      }
    }
  }
  __syncthreads();
  if constexpr (FT != 1) {
    // 2. stage[(l*K + k)*F + f] = x[src[k*R + l]*F + f], consecutive
    // threads on consecutive f, then l, then k: q = f + F*(l + R*k).
    const int total = (K * F) << lg_r;
#pragma unroll 4
    for (int q = threadIdx.x; q < total; q += blockDim.x) {
      int kl;
      if constexpr (FT > 0) {
        kl = q / FT;  // a multiply and a shift
      } else {
        kl = q / F;
      }
      const int l = kl & mask;
      if (l < rows) {
        const int f = q - kl * F;
        const int k = kl >> lg_r;
        stage[(l * K + k) * F + f] =
            x[static_cast<long long>(src[kl]) * F + f];
      }
    }
    __syncthreads();
  }
  // 3. Write the span out: a scalar head up to a 16-byte boundary, then
  // 16-byte stores, then a scalar tail.
  const int head = min(n, (V - mis) % V);
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = stage[i];
  const int nvec = (n - head) / V;
  const uint4* sv = reinterpret_cast<const uint4*>(stage + head);
  uint4* dv = reinterpret_cast<uint4*>(dst + head);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) dv[i] = sv[i];
  for (int i = head + nvec * V + threadIdx.x; i < n; i += blockDim.x) {
    dst[i] = stage[i];
  }
}

// Chunk rows R of the slice SpMVs: a power of two, at most kSpmvMaxRows
// and no more than the tile needs, halved down to 32 until there are two
// CTAs per SM of an H100 (the couette's 64 tiles of 128 rows give 256
// CTAs).
inline int spmv_chunk_rows(int tile, long long ntiles, long long groups) {
  int rows = kSpmvMaxRows;
  while (rows > 32 && rows / 2 >= tile) rows /= 2;
  while (rows > 32 &&
         ntiles * ((tile + rows - 1) / rows) * groups < 264) {
    rows /= 2;
  }
  return rows;
}

template <typename T, int NB>
int launch_slice_spmv_nb(const void* diag, long long diag_bs,
                         const void* coef, long long coef_bs,
                         const void* starts, const void* tile_nj,
                         const void* x, void* y, long long C, int tile,
                         long long ntiles, int n_max, long long pad_lo,
                         int B, cudaStream_t stream) {
  const long long groups = (B + NB - 1) / NB;
  const int rows = spmv_chunk_rows(tile, ntiles, groups);
  const int chunks = (tile + rows - 1) / rows;
  const dim3 grid(static_cast<unsigned>(ntiles * chunks),
                  static_cast<unsigned>(groups));
  slice_spmv_kernel<T, NB><<<grid, rows, 0, stream>>>(
      static_cast<const T*>(diag), diag_bs, static_cast<const T*>(coef),
      coef_bs, static_cast<const int*>(starts),
      static_cast<const int*>(tile_nj), static_cast<const T*>(x),
      static_cast<T*>(y), static_cast<int>(C), tile, n_max,
      static_cast<int>(pad_lo), chunks, B);
  return static_cast<int>(cudaGetLastError());
}

// The batch applied once: a shared matrix takes up to four batch rows
// per CTA, each coefficient read once for all of them; one matrix per
// batch row takes a CTA row per batch row.
template <typename T>
int launch_slice_spmv(const void* diag, long long diag_bs, const void* coef,
                      long long coef_bs, const void* starts,
                      const void* tile_nj, const void* x, void* y,
                      long long C, int tile, long long ntiles, int n_max,
                      long long pad_lo, int B, cudaStream_t stream) {
  const int nb = coef_bs != 0 ? 1 : (B < 4 ? B : 4);
  switch (nb) {
    case 1:
      return launch_slice_spmv_nb<T, 1>(diag, diag_bs, coef, coef_bs, starts,
                                        tile_nj, x, y, C, tile, ntiles, n_max,
                                        pad_lo, B, stream);
    case 2:
      return launch_slice_spmv_nb<T, 2>(diag, diag_bs, coef, coef_bs, starts,
                                        tile_nj, x, y, C, tile, ntiles, n_max,
                                        pad_lo, B, stream);
    case 3:
      return launch_slice_spmv_nb<T, 3>(diag, diag_bs, coef, coef_bs, starts,
                                        tile_nj, x, y, C, tile, ntiles, n_max,
                                        pad_lo, B, stream);
    default:
      return launch_slice_spmv_nb<T, 4>(diag, diag_bs, coef, coef_bs, starts,
                                        tile_nj, x, y, C, tile, ntiles, n_max,
                                        pad_lo, B, stream);
  }
}

template <int NB>
int launch_slice_spmv_exact_nb(const void* coef, long long coef_bs,
                               const void* starts, const void* tile_nj,
                               const void* x, void* y, void* err, long long C,
                               int tile, long long ntiles, int n_max,
                               long long pad_lo, int B, cudaStream_t stream) {
  const long long groups = (B + NB - 1) / NB;
  const int rows = spmv_chunk_rows(tile, ntiles, groups);
  const int chunks = (tile + rows - 1) / rows;
  const dim3 grid(static_cast<unsigned>(ntiles * chunks),
                  static_cast<unsigned>(groups));
  slice_spmv_exact_kernel<NB><<<grid, rows, 0, stream>>>(
      static_cast<const float*>(coef), coef_bs,
      static_cast<const int*>(starts), static_cast<const int*>(tile_nj),
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<float*>(err), static_cast<int>(C), tile, n_max,
      static_cast<int>(pad_lo), chunks, B);
  return static_cast<int>(cudaGetLastError());
}

// The batch as in launch_slice_spmv: up to four rows per CTA over a
// shared matrix, a CTA row per batch row over one matrix per row.
int launch_slice_spmv_exact(const void* coef, long long coef_bs,
                            const void* starts, const void* tile_nj,
                            const void* x, void* y, void* err, long long C,
                            int tile, long long ntiles, int n_max,
                            long long pad_lo, int B, cudaStream_t stream) {
  const int nb = coef_bs != 0 ? 1 : (B < 4 ? B : 4);
  switch (nb) {
    case 1:
      return launch_slice_spmv_exact_nb<1>(coef, coef_bs, starts, tile_nj, x,
                                           y, err, C, tile, ntiles, n_max,
                                           pad_lo, B, stream);
    case 2:
      return launch_slice_spmv_exact_nb<2>(coef, coef_bs, starts, tile_nj, x,
                                           y, err, C, tile, ntiles, n_max,
                                           pad_lo, B, stream);
    case 3:
      return launch_slice_spmv_exact_nb<3>(coef, coef_bs, starts, tile_nj, x,
                                           y, err, C, tile, ntiles, n_max,
                                           pad_lo, B, stream);
    default:
      return launch_slice_spmv_exact_nb<4>(coef, coef_bs, starts, tile_nj, x,
                                           y, err, C, tile, ntiles, n_max,
                                           pad_lo, B, stream);
  }
}

template <typename T, int FT>
int launch_slice_nbr_f(const void* x, const void* interior,
                       const void* starts, const void* col_tile, void* out,
                       long long C, long long ntiles, int K, int F, int tile,
                       int n_max, long long pad_lo, cudaStream_t stream) {
  // Chunk rows R = 1 << lg_r: the largest power of two whose stage fits
  // kNbrStageBytes, no more than the tile needs; 1 for wide rows. On a
  // small mesh, halved down to 32 rows until there are two CTAs per SM
  // of an H100: a CTA's few dependent loads are then spread out.
  const long long row_bytes = static_cast<long long>(K) * F * sizeof(T);
  int lg_r = 0;
  while ((1LL << (lg_r + 1)) * row_bytes <= kNbrStageBytes &&
         (1 << lg_r) < tile) {
    ++lg_r;
  }
  while (lg_r > 5 && ntiles * ((tile + (1LL << lg_r) - 1) >> lg_r) < 264) {
    --lg_r;
  }
  const int staged = row_bytes <= kNbrMaxStageBytes;
  const long long src_bytes =
      ((static_cast<long long>(K) << lg_r) * 4 + 15) & ~15LL;
  const long long smem = staged ? src_bytes + 16 + (row_bytes << lg_r) : 0;
  if (smem > 48 * 1024) {  // rows of thousands of slots: at most 80 KB
    const cudaError_t e = cudaFuncSetAttribute(
        slice_nbr_kernel<T, FT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // One CTA per (tile, chunk); ntiles * chunks <= C + tile fits an int.
  const int chunks = static_cast<int>((tile + (1LL << lg_r) - 1) >> lg_r);
  slice_nbr_kernel<T, FT>
      <<<static_cast<unsigned>(ntiles * chunks), kThreads,
         static_cast<size_t>(smem), stream>>>(
          static_cast<const T*>(x),
          static_cast<const unsigned char*>(interior),
          static_cast<const int*>(starts), static_cast<const int*>(col_tile),
          static_cast<T*>(out), static_cast<int>(C), K, F, tile, n_max,
          static_cast<int>(pad_lo), lg_r, chunks, staged);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_slice_nbr(const void* x, const void* interior, const void* starts,
                     const void* col_tile, void* out, long long C, int K,
                     int F, int tile, int n_max, long long pad_lo,
                     cudaStream_t stream) {
  const long long ntiles = (C + tile - 1) / tile;
  switch (F) {
    case 1:
      return launch_slice_nbr_f<T, 1>(x, interior, starts, col_tile, out, C,
                                      ntiles, K, F, tile, n_max, pad_lo,
                                      stream);
    case 3:
      return launch_slice_nbr_f<T, 3>(x, interior, starts, col_tile, out, C,
                                      ntiles, K, F, tile, n_max, pad_lo,
                                      stream);
    case 9:
      return launch_slice_nbr_f<T, 9>(x, interior, starts, col_tile, out, C,
                                      ntiles, K, F, tile, n_max, pad_lo,
                                      stream);
    default:
      return launch_slice_nbr_f<T, 0>(x, interior, starts, col_tile, out, C,
                                      ntiles, K, F, tile, n_max, pad_lo,
                                      stream);
  }
}

}  // namespace orc

extern "C" int orc_slice_spmv(int dtype, const void* diag, long long diag_bs,
                              const void* coef, long long coef_bs,
                              const void* starts, const void* tile_nj,
                              const void* x, void* y, long long C, int tile,
                              long long ntiles, int n_max, long long pad_lo,
                              int B, void* stream) {
  // The kernel indexes rows, slices and CTAs in 32 bits.
  if (C < 0 || tile < 1 || n_max < 0 || ntiles < 0 || B < 1 || B > 65535 ||
      ntiles * tile < C || ntiles * tile + pad_lo > 2147483647LL ||
      pad_lo < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == orc::kF32) {
    return orc::launch_slice_spmv<float>(diag, diag_bs, coef, coef_bs, starts,
                                         tile_nj, x, y, C, tile, ntiles,
                                         n_max, pad_lo, B, s);
  }
  if (dtype == orc::kF64) {
    return orc::launch_slice_spmv<double>(diag, diag_bs, coef, coef_bs,
                                          starts, tile_nj, x, y, C, tile,
                                          ntiles, n_max, pad_lo, B, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int orc_slice_spmv_exact(const void* coef, long long coef_bs,
                                    const void* starts, const void* tile_nj,
                                    const void* x, void* y, void* err,
                                    long long C, int tile, long long ntiles,
                                    int n_max, long long pad_lo, int B,
                                    void* stream) {
  // The kernel indexes rows, slices and CTAs in 32 bits.
  if (C < 0 || tile < 1 || n_max < 0 || ntiles < 0 || B < 1 || B > 65535 ||
      ntiles * tile < C || ntiles * tile + pad_lo > 2147483647LL ||
      pad_lo < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C == 0) return 0;
  return orc::launch_slice_spmv_exact(coef, coef_bs, starts, tile_nj, x, y,
                                      err, C, tile, ntiles, n_max, pad_lo, B,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" int orc_slice_nbr(int dtype, const void* x, const void* interior,
                             const void* starts, const void* col_tile,
                             void* out, long long C, int K, int F, int tile,
                             int n_max, long long pad_lo, void* stream) {
  // The kernel indexes slots and the column table in 32 bits.
  if (C < 0 || K < 1 || F < 1 || tile < 1 || n_max < 1 ||
      C * K > 2147483647LL || (C + tile) * K > 2147483647LL ||
      pad_lo > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == orc::kF32) {
    return orc::launch_slice_nbr<float>(x, interior, starts, col_tile, out, C,
                                        K, F, tile, n_max, pad_lo, s);
  }
  if (dtype == orc::kF64) {
    return orc::launch_slice_nbr<double>(x, interior, starts, col_tile, out,
                                         C, K, F, tile, n_max, pad_lo, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
