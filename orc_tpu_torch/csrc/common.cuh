// Shared definitions of the port's Hopper kernels (plain C interface,
// no PyTorch headers; built by orc_tpu_torch/ops/_cuda.py).
#pragma once

#include <cuda_runtime.h>

namespace orc {

// ELL column capacity of a kernel-argument struct (a 3-D box has K=6).
constexpr int MAX_K = 8;
constexpr int kThreads = 256;
enum DType { kF32 = 0, kF64 = 1 };

// K off-diagonal columns: column k of row i is col[k][i * stride[k]],
// its neighbour is row i + offset[k]. Passed by value as a kernel
// argument, so the launch needs no device-side table.
template <typename T>
struct Columns {
  const T* col[MAX_K];
  long long stride[MAX_K];
  long long offset[MAX_K];
  int K;
};

template <typename T>
inline Columns<T> make_columns(const void* const* cols,
                               const long long* strides,
                               const long long* offsets, int K) {
  Columns<T> c{};
  c.K = K;
  for (int k = 0; k < K; ++k) {
    c.col[k] = static_cast<const T*>(cols[k]);
    c.stride[k] = strides[k];
    c.offset[k] = offsets[k];
  }
  return c;
}

// Blocks for a grid-stride loop over n rows.
inline unsigned grid_blocks(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > 65535) b = 65535;
  return static_cast<unsigned>(b);
}

// The rounding of the SpMVs' first designs, whose separate basic blocks
// kept nvcc from fusing diag * x with the first column: a rounded
// product, then one fused multiply-add per column. Spelled out, so that
// unrolled straight-line code cannot be contracted another way.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

}  // namespace orc
