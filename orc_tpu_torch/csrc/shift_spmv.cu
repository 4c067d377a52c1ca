// Structured-offset ELL SpMV on Hopper (sm_90a).
//
// Replaces: orc_tpu/ops/pallas_spmv.py `_kernel` (reached from
// `shift_spmv`), the TPU kernel that loads one x window per block into
// VMEM and applies every flat-index shift as a lane slice.
//
//   y[b,i] = diag[i] * x[b,i] + sum_k off_k[i] * x[b, i + d_k]
//
// with reads outside [0, C) taken as 0, like the TPU kernel's zero
// padding. B right-hand sides (the u/v/w momentum systems) share one
// matrix, or (the per-row instance, `orc_shift_spmv_rows`) each has its
// own: diag and column k of batch row b start a batch-row stride
// further on (the CD2 and in-matrix TVD momentum systems, one matrix
// per velocity component). Both float32 and float64 (the couette case
// runs in f64).
//
// Bound on the H100: device memory. At B = 1 each row moves
// (K + 3) * sizeof(T) bytes (diag, K columns, x, y), and each further
// batch row 2 * sizeof(T): 29.4 MB, 8.8 us at 3.35 TB/s, for the
// 1024^2 f32 pressure system (K = 4). The K neighbour reads of x hit
// lines that nearby rows already brought into L1/L2, so HBM sees x once.
// Per row, each batch row moves (K + 3) * sizeof(T) bytes a row: 21
// float32 planes, 88.1 MB, 26.3 us for the 1024^2 TVD cavity's momentum
// systems (B = 3, K = 4).
//
// Design. The first design (one row per thread, scalar loads, a 64-bit
// index product per column and row, one CTA row per batch row that
// re-read the shared matrix) moved 1.46 TB/s at 1024^2 f32 on an NVIDIA
// H100 80GB HBM3 at 700 W: too few loads in flight. Now:
//  - a thread owns V = 16 / sizeof(T) consecutive rows and reads diag,
//    each contiguous column and x with one 16-byte load each; a plane
//    that starts unaligned (an odd C, an offset view of x, a later batch
//    row of a ragged C) or a strided [C, K] column takes scalar loads in
//    the same kernel;
//  - small shifts (|d_k| <= H, the +-1 of every box) read a shared-memory
//    window of x that the CTA fills once per batch row (its own rows and
//    H more on each side): two aligned 16-byte reads combined in
//    registers instead of misaligned global loads;
//  - large shifts (+-nx, +-nx*ny; a 128^3 box's +-16384 fits no window)
//    read x from global memory (L2), 16 bytes at a time where aligned,
//    issued before the window's barrier;
//  - the matrix is read once into registers and applied to every batch
//    row (the window is double-buffered: one barrier per batch row);
//    a system too small to fill the card takes one CTA per batch row;
//  - K = 4 and 6 are template instances (any K <= MAX_K runs the generic
//    one); 64-bit index arithmetic once per thread, not per row.
// The arithmetic is the first design's: diag * x rounded, then one fused
// multiply-add per column in order (acc = acc + col * x as nvcc
// contracted it), so the results are unchanged bit for bit.
//
// The per-row instance (template flag PR) is the same kernel with the
// matrix loads moved into the batch loop, at the batch row's strides:
// 16-byte loads where that row's plane is contiguous and aligned,
// scalar loads otherwise. The shared instance is unchanged.
#include <cstdint>

#include "common.cuh"

namespace orc {

constexpr int kSpmvThreads = 128;

// V = 16 / sizeof(T) consecutive values, one 16-byte load or store.
template <typename T>
struct alignas(16) Vec {
  static constexpr int V = 16 / sizeof(T);
  T v[V];
};

// p[j * stride] for j < n (zero for j >= n): one 16-byte load when `vec`
// (p contiguous and 16-byte aligned) and the whole vector is in range.
template <typename T>
__device__ __forceinline__ Vec<T> load_rows(const T* __restrict__ p,
                                            long long stride, bool vec,
                                            int n) {
  constexpr int V = Vec<T>::V;
  if (vec && n >= V) return *reinterpret_cast<const Vec<T>*>(p);
  Vec<T> r;
#pragma unroll
  for (int j = 0; j < V; ++j) r.v[j] = j < n ? p[j * stride] : T(0);
  return r;
}

// x[i + d + j], j < n, zero outside [0, C): from global memory.
template <typename T>
__device__ __forceinline__ Vec<T> load_shifted(const T* __restrict__ xb,
                                               long long i, long long d,
                                               long long C, int n) {
  constexpr int V = Vec<T>::V;
  const long long s = i + d;
  const T* p = xb + s;
  if (n >= V && s >= 0 && s + V <= C &&
      (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    return *reinterpret_cast<const Vec<T>*>(p);
  }
  Vec<T> r;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    r.v[j] = (j < n && s + j >= 0 && s + j < C) ? p[j] : T(0);
  }
  return r;
}

// Values R..R+V-1 of the 2V values lo, hi.
template <typename T, int R>
__device__ __forceinline__ Vec<T> take(const Vec<T>& lo, const Vec<T>& hi) {
  constexpr int V = Vec<T>::V;
  Vec<T> o;
#pragma unroll
  for (int j = 0; j < V; ++j) o.v[j] = (j + R < V ? lo : hi).v[(j + R) % V];
  return o;
}

// w[pos + d + j], j < V, pos a multiple of V: two aligned reads.
template <typename T>
__device__ __forceinline__ Vec<T> window_read(const T* w, int pos, int d) {
  constexpr int V = Vec<T>::V;
  const int r = d & (V - 1);
  const Vec<T>* p = reinterpret_cast<const Vec<T>*>(w + pos + d - r);
  const Vec<T> lo = p[0];
  if (r == 0) return lo;
  const Vec<T> hi = p[1];
  if constexpr (V == 4) {
    if (r == 1) return take<T, 1>(lo, hi);
    if (r == 2) return take<T, 2>(lo, hi);
    return take<T, 3>(lo, hi);
  } else {
    return take<T, 1>(lo, hi);
  }
}

// Batch-row strides (elements) of a matrix per batch row: diag and each
// column of batch row b start at b * stride.
struct RowStrides {
  long long diag;
  long long col[MAX_K];
};

template <typename T>
__device__ __forceinline__ bool aligned16(const T* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int KT, bool PR>
__global__ void __launch_bounds__(kSpmvThreads)
    shift_spmv_kernel(const T* __restrict__ diag, Columns<T> cols,
                      unsigned col_vec, RowStrides rs,
                      const T* __restrict__ x, T* __restrict__ y,
                      long long C, int B) {
  constexpr int V = Vec<T>::V;
  constexpr int H = 4 * V;               // window halo on each side
  constexpr int N = kSpmvThreads * V;    // rows of a CTA
  constexpr int KM = KT > 0 ? KT : MAX_K;
  const int K = KT > 0 ? KT : cols.K;
  __shared__ Vec<T> win[2][(N + 2 * H) / V];
  const long long i0 = static_cast<long long>(blockIdx.x) * N;
  const int m = threadIdx.x * V;
  const long long i = i0 + m;
  // Rows of this thread: V, fewer at the end of C, <= 0 past it.
  const int n = static_cast<int>(min(static_cast<long long>(V), C - i));
  Vec<T> dg;
  Vec<T> a[KM];
  if constexpr (!PR) {
    dg = load_rows(diag + i, 1, (reinterpret_cast<uintptr_t>(diag) & 15) == 0,
                   n);
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      if (k < K) {
        a[k] = load_rows(cols.col[k] + i * cols.stride[k], cols.stride[k],
                         (col_vec >> k) & 1u, n);
      }
    }
  }
  // Batch rows blockIdx.y, + gridDim.y, ...: all of them in one CTA on
  // large systems; one each where C alone gives too few CTAs.
  int parity = 0;
  for (int b = blockIdx.y; b < B; b += gridDim.y, parity ^= 1) {
    if constexpr (PR) {
      const T* db = diag + b * rs.diag;
      dg = load_rows(db + i, 1, aligned16(db), n);
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        if (k < K) {
          const T* cb = cols.col[k] + b * rs.col[k];
          a[k] = load_rows(cb + i * cols.stride[k], cols.stride[k],
                           cols.stride[k] == 1 && aligned16(cb), n);
        }
      }
    }
    const T* xb = x + b * C;
    T* w = reinterpret_cast<T*>(win[parity]);
    const Vec<T> xo = load_rows(
        xb + i, 1, (reinterpret_cast<uintptr_t>(xb + i) & 15) == 0, n);
    *reinterpret_cast<Vec<T>*>(w + H + m) = xo;  // zeros past C
    if (threadIdx.x < 2 * H) {
      const int h = threadIdx.x;
      const long long j = h < H ? i0 - H + h : i0 + N + (h - H);
      w[h < H ? h : N + h] = (j >= 0 && j < C) ? xb[j] : T(0);
    }
    Vec<T> xf[KM];
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      const long long d = cols.offset[k];
      if (k < K && (d < -H || d > H)) xf[k] = load_shifted(xb, i, d, C, n);
    }
    __syncthreads();
    Vec<T> acc;
#pragma unroll
    for (int j = 0; j < V; ++j) acc.v[j] = mul_rn(dg.v[j], xo.v[j]);
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      if (k < K) {
        const long long d = cols.offset[k];
        const Vec<T> xk = (d < -H || d > H)
                              ? xf[k]
                              : window_read(w, H + m, static_cast<int>(d));
#pragma unroll
        for (int j = 0; j < V; ++j) {
          acc.v[j] = fma_rn(a[k].v[j], xk.v[j], acc.v[j]);
        }
      }
    }
    T* yb = y + b * C + i;
    if (n >= V && (reinterpret_cast<uintptr_t>(yb) & 15) == 0) {
      *reinterpret_cast<Vec<T>*>(yb) = acc;
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (j < n) yb[j] = acc.v[j];
      }
    }
  }
}

template <typename T, int KT, bool PR>
int launch_shift_spmv_k(const void* diag, const Columns<T>& c, unsigned col_vec,
                        const RowStrides& rs, const void* x, void* y,
                        long long C, int B, cudaStream_t stream) {
  constexpr long long N = kSpmvThreads * Vec<T>::V;
  const long long blocks = (C + N - 1) / N;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  // Fewer CTAs than two per SM of an H100: one CTA per batch row, which
  // re-reads the (small) matrix from L2 instead of looping over B.
  const dim3 grid(static_cast<unsigned>(blocks),
                  blocks < 264 ? static_cast<unsigned>(B) : 1u);
  shift_spmv_kernel<T, KT, PR><<<grid, kSpmvThreads, 0, stream>>>(
          static_cast<const T*>(diag), c, col_vec, rs,
          static_cast<const T*>(x), static_cast<T*>(y), C, B);
  return static_cast<int>(cudaGetLastError());
}

// batch_strides == nullptr: the batch shares the matrix; otherwise
// diag_bs and batch_strides[k] step diag and column k by batch row.
template <typename T>
int launch_shift_spmv(const void* diag, long long diag_bs,
                      const void* const* cols, const long long* strides,
                      const long long* batch_strides,
                      const long long* offsets, int K, const void* x,
                      void* y, long long C, int B, cudaStream_t stream) {
  const Columns<T> c = make_columns<T>(cols, strides, offsets, K);
  // Bit k: column k is contiguous and 16-byte aligned (16-byte loads).
  unsigned col_vec = 0;
  for (int k = 0; k < K; ++k) {
    if (strides[k] == 1 && (reinterpret_cast<uintptr_t>(cols[k]) & 15) == 0) {
      col_vec |= 1u << k;
    }
  }
  RowStrides rs{};
  if (batch_strides != nullptr) {
    rs.diag = diag_bs;
    for (int k = 0; k < K; ++k) rs.col[k] = batch_strides[k];
    if (K == 4) {
      return launch_shift_spmv_k<T, 4, true>(diag, c, col_vec, rs, x, y, C, B,
                                             stream);
    }
    if (K == 6) {
      return launch_shift_spmv_k<T, 6, true>(diag, c, col_vec, rs, x, y, C, B,
                                             stream);
    }
    return launch_shift_spmv_k<T, 0, true>(diag, c, col_vec, rs, x, y, C, B,
                                           stream);
  }
  if (K == 4) {
    return launch_shift_spmv_k<T, 4, false>(diag, c, col_vec, rs, x, y, C, B,
                                            stream);
  }
  if (K == 6) {
    return launch_shift_spmv_k<T, 6, false>(diag, c, col_vec, rs, x, y, C, B,
                                            stream);
  }
  return launch_shift_spmv_k<T, 0, false>(diag, c, col_vec, rs, x, y, C, B,
                                          stream);
}

inline int shift_spmv_entry(int dtype, const void* diag, long long diag_bs,
                            const void* const* cols, const long long* strides,
                            const long long* batch_strides,
                            const long long* offsets, int K, const void* x,
                            void* y, long long C, int B, void* stream) {
  if (K < 0 || K > MAX_K || B < 1 || B > 65535 || C < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    return launch_shift_spmv<float>(diag, diag_bs, cols, strides,
                                    batch_strides, offsets, K, x, y, C, B, s);
  }
  if (dtype == kF64) {
    return launch_shift_spmv<double>(diag, diag_bs, cols, strides,
                                     batch_strides, offsets, K, x, y, C, B, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace orc

extern "C" int orc_shift_spmv(int dtype, const void* diag,
                              const void* const* cols,
                              const long long* strides,
                              const long long* offsets, int K,
                              const void* x, void* y, long long C, int B,
                              void* stream) {
  return orc::shift_spmv_entry(dtype, diag, 0, cols, strides, nullptr,
                               offsets, K, x, y, C, B, stream);
}

// One matrix per batch row: diag of row b at diag + b * diag_bs, column
// k at cols[k] + b * batch_strides[k].
extern "C" int orc_shift_spmv_rows(int dtype, const void* diag,
                                   long long diag_bs,
                                   const void* const* cols,
                                   const long long* strides,
                                   const long long* batch_strides,
                                   const long long* offsets, int K,
                                   const void* x, void* y, long long C,
                                   int B, void* stream) {
  if (batch_strides == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return orc::shift_spmv_entry(dtype, diag, diag_bs, cols, strides,
                               batch_strides, offsets, K, x, y, C, B, stream);
}

extern "C" const char* orc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
