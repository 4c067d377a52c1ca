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
// matrix. Both float32 and float64 (the couette case runs in f64).
//
// Bound on the H100: device memory. Each row moves (K + 3) * sizeof(T)
// bytes at B = 1 (diag, K columns, x, y); the K neighbour reads of x
// hit lines that adjacent rows already brought into L1/L2 (|d_k| * 8 B
// is at most a few KB apart within a tile), so HBM sees x once.
// Design: one thread per row in a grid-stride loop, coalesced column
// reads (each column is a contiguous [C] plane or a strided view),
// blockIdx.y over the batch. Simple and right first: with B = 3 each
// batch row re-reads the shared matrix (from L2 for the 2nd and 3rd);
// reading it once per row for all B is later work.
#include "common.cuh"

namespace orc {

template <typename T>
__global__ void shift_spmv_kernel(const T* __restrict__ diag,
                                  Columns<T> cols,
                                  const T* __restrict__ x,
                                  T* __restrict__ y, long long C) {
  const long long b = blockIdx.y;
  const T* xb = x + b * C;
  T* yb = y + b * C;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < C; i += step) {
    // Same accumulation order as the plain version: diag first, then
    // the columns in order.
    T acc = diag[i] * xb[i];
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) {
      if (k < cols.K) {
        const long long j = i + cols.offset[k];
        const T xv = (j >= 0 && j < C) ? xb[j] : T(0);
        acc = acc + cols.col[k][i * cols.stride[k]] * xv;
      }
    }
    yb[i] = acc;
  }
}

template <typename T>
int launch_shift_spmv(const void* diag, const void* const* cols,
                      const long long* strides, const long long* offsets,
                      int K, const void* x, void* y, long long C, int B,
                      cudaStream_t stream) {
  const Columns<T> c = make_columns<T>(cols, strides, offsets, K);
  const dim3 grid(grid_blocks(C), static_cast<unsigned>(B));
  shift_spmv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(diag), c, static_cast<const T*>(x),
      static_cast<T*>(y), C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace orc

extern "C" int orc_shift_spmv(int dtype, const void* diag,
                              const void* const* cols,
                              const long long* strides,
                              const long long* offsets, int K,
                              const void* x, void* y, long long C, int B,
                              void* stream) {
  if (K < 0 || K > orc::MAX_K || B < 1 || B > 65535 || C < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == orc::kF32) {
    return orc::launch_shift_spmv<float>(diag, cols, strides, offsets, K,
                                         x, y, C, B, s);
  }
  if (dtype == orc::kF64) {
    return orc::launch_shift_spmv<double>(diag, cols, strides, offsets, K,
                                          x, y, C, B, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* orc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
