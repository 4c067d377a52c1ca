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
// peak); the gather reads the interior mask, col_tile and x and writes
// C*K*F values.
//
// Design. The TPU kernels DMA one x window per group of tiles into VMEM
// and rotate 128-lane rows, statically unrolled over n_max (a dynamic
// trip count was 14x slower there), with the heavy tiles split off into
// a second kernel. On the card a dynamic loop bound costs nothing: one
// CTA per (tile, batch row), thread l walks the tile's used columns
// only, reading coef[t, j, l] and the slice of x coalesced (consecutive
// threads, consecutive addresses; the RCM band keeps x in L2). The
// diagonal term is folded in and x is read unpadded with a bounds test,
// so no padded copy of x is made per matvec. The gather runs one thread
// per (c, k) slot with 32-bit index arithmetic (a 64-bit divide per
// output element made it 2x slower than torch's own gather on the
// H100) and copies the slot's F contiguous values, writing the [C,K,F]
// output in the layout the (c,k) ops read, with no transpose. Simple
// and right first: no shared-memory staging of x, no TMA.
#include "common.cuh"

namespace orc {

template <typename T>
__global__ void slice_spmv_kernel(const T* __restrict__ diag,
                                  long long diag_bs,
                                  const T* __restrict__ coef,
                                  long long coef_bs,
                                  const int* __restrict__ starts,
                                  const int* __restrict__ tile_nj,
                                  const T* __restrict__ x,
                                  T* __restrict__ y, long long C, int tile,
                                  int n_max, long long pad_lo) {
  const long long t = blockIdx.x;
  const long long b = blockIdx.y;
  const T* xb = x + b * C;
  T* yb = y + b * C;
  const T* db = diag + b * diag_bs;
  const T* cb = coef + b * coef_bs + t * n_max * static_cast<long long>(tile);
  const int* st = starts + t * n_max;
  const int nj = tile_nj[t];
  for (int l = threadIdx.x; l < tile; l += blockDim.x) {
    const long long c = t * tile + l;
    if (c >= C) break;
    T acc = db[c] * xb[c];
    for (int j = 0; j < nj; ++j) {
      const long long src = static_cast<long long>(st[j]) - pad_lo + l;
      const T xv = (src >= 0 && src < C) ? xb[src] : T(0);
      acc = acc + cb[static_cast<long long>(j) * tile + l] * xv;
    }
    yb[c] = acc;
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
__global__ void slice_spmv_exact_kernel(const float* __restrict__ coef,
                                        long long coef_bs,
                                        const int* __restrict__ starts,
                                        const int* __restrict__ tile_nj,
                                        const float* __restrict__ x,
                                        float* __restrict__ y,
                                        float* __restrict__ err_out,
                                        long long C, int tile, int n_max,
                                        long long pad_lo) {
  const long long t = blockIdx.x;
  const long long b = blockIdx.y;
  const float* xb = x + b * C;
  const float* cb =
      coef + b * coef_bs + t * n_max * static_cast<long long>(tile);
  const int* st = starts + t * n_max;
  const int nj = tile_nj[t];
  for (int l = threadIdx.x; l < tile; l += blockDim.x) {
    const long long c = t * tile + l;
    if (c >= C) break;
    float acc = 0.0f, err = 0.0f;
    for (int j = 0; j < nj; ++j) {
      const long long src = static_cast<long long>(st[j]) - pad_lo + l;
      const float xv = (src >= 0 && src < C) ? xb[src] : 0.0f;
      const float a = cb[static_cast<long long>(j) * tile + l];
      const float p = __fmul_rn(a, xv);
      const float pe = __fmaf_rn(a, xv, -p);
      const float s = __fadd_rn(acc, p);
      const float bb = __fsub_rn(s, acc);
      const float te =
          __fadd_rn(__fsub_rn(acc, __fsub_rn(s, bb)), __fsub_rn(p, bb));
      acc = s;
      err = __fadd_rn(err, __fadd_rn(te, pe));
    }
    y[b * C + c] = acc;
    err_out[b * C + c] = err;
  }
}

template <typename T>
__global__ void slice_nbr_kernel(const T* __restrict__ x,
                                 const unsigned char* __restrict__ interior,
                                 const int* __restrict__ starts,
                                 const int* __restrict__ col_tile,
                                 T* __restrict__ out, int C, int K, int F,
                                 int tile, int n_max, int pad_lo) {
  // One thread per (c, k) slot; its F values are contiguous in x and
  // out. 32-bit index arithmetic (the launcher checks C * K fits).
  const int slots = C * K;
  const int step = gridDim.x * blockDim.x;
  for (int ck = blockIdx.x * blockDim.x + threadIdx.x; ck < slots;
       ck += step) {
    const int c = ck / K;
    int src = c;
    if (interior[ck]) {
      const int k = ck - c * K;
      const int t = c / tile;
      const int l = c - t * tile;
      const int j = col_tile[(t * K + k) * tile + l];
      src = starts[t * n_max + j] - pad_lo + l;
    }
    const T* xs = x + static_cast<long long>(src) * F;
    T* o = out + static_cast<long long>(ck) * F;
    for (int f = 0; f < F; ++f) o[f] = xs[f];
  }
}

template <typename T>
int launch_slice_spmv(const void* diag, long long diag_bs, const void* coef,
                      long long coef_bs, const void* starts,
                      const void* tile_nj, const void* x, void* y,
                      long long C, int tile, long long ntiles, int n_max,
                      long long pad_lo, int B, cudaStream_t stream) {
  const unsigned threads = tile < kThreads ? static_cast<unsigned>(tile)
                                           : static_cast<unsigned>(kThreads);
  const dim3 grid(static_cast<unsigned>(ntiles), static_cast<unsigned>(B));
  slice_spmv_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(diag), diag_bs, static_cast<const T*>(coef),
      coef_bs, static_cast<const int*>(starts),
      static_cast<const int*>(tile_nj), static_cast<const T*>(x),
      static_cast<T*>(y), C, tile, n_max, pad_lo);
  return static_cast<int>(cudaGetLastError());
}

int launch_slice_spmv_exact(const void* coef, long long coef_bs,
                            const void* starts, const void* tile_nj,
                            const void* x, void* y, void* err, long long C,
                            int tile, long long ntiles, int n_max,
                            long long pad_lo, int B, cudaStream_t stream) {
  const unsigned threads = tile < kThreads ? static_cast<unsigned>(tile)
                                           : static_cast<unsigned>(kThreads);
  const dim3 grid(static_cast<unsigned>(ntiles), static_cast<unsigned>(B));
  slice_spmv_exact_kernel<<<grid, threads, 0, stream>>>(
      static_cast<const float*>(coef), coef_bs,
      static_cast<const int*>(starts), static_cast<const int*>(tile_nj),
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<float*>(err), C, tile, n_max, pad_lo);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_slice_nbr(const void* x, const void* interior, const void* starts,
                     const void* col_tile, void* out, long long C, int K,
                     int F, int tile, int n_max, long long pad_lo,
                     cudaStream_t stream) {
  const long long slots = C * K;
  long long blocks = (slots + kThreads - 1) / kThreads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride beyond this
  slice_nbr_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const unsigned char*>(interior),
      static_cast<const int*>(starts), static_cast<const int*>(col_tile),
      static_cast<T*>(out), static_cast<int>(C), K, F, tile, n_max,
      static_cast<int>(pad_lo));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace orc

extern "C" int orc_slice_spmv(int dtype, const void* diag, long long diag_bs,
                              const void* coef, long long coef_bs,
                              const void* starts, const void* tile_nj,
                              const void* x, void* y, long long C, int tile,
                              long long ntiles, int n_max, long long pad_lo,
                              int B, void* stream) {
  if (C < 0 || tile < 1 || n_max < 0 || ntiles < 0 || ntiles > 2147483647LL ||
      B < 1 || B > 65535 || ntiles * tile < C) {
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
  if (C < 0 || tile < 1 || n_max < 0 || ntiles < 0 || ntiles > 2147483647LL ||
      B < 1 || B > 65535 || ntiles * tile < C) {
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
