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
//
// Bound on the H100: device memory. One sweep moves
// (1 + K) * sizeof(T) bytes of matrix per row plus 3 * B * sizeof(T)
// of b, x and x_new. Design: one launch per sweep with ping-pong
// buffers; one thread per row reads diag and its K coefficients once
// and updates all B components, so the matrix is read once per sweep
// for the whole batch. Reads outside [0, C) are 0 (the TPU kernel's
// zero padding).
//
// Limit: the TPU kernel's temporal blocking (all sweeps per window)
// needs halos of sweeps * max|d| rows each side; on the 1024^2 cavity
// that is 6 * 1024 rows, which does not fit Hopper's 227 KB of shared
// memory along the flat index. Temporal blocking over 2-D tiles is
// later work, so here HBM sees the matrix and the batch once per sweep.
#include "common.cuh"

namespace orc {

template <typename T>
__global__ void jacobi_sweep_kernel(const T* __restrict__ diag,
                                    Columns<T> cols,
                                    const T* __restrict__ b,
                                    const T* __restrict__ x,
                                    T* __restrict__ x_new, long long C,
                                    int B, T relax, T one_minus_relax) {
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

// Sweep s reads x0 (s = 0) or buf[(s - 1) % 2] and writes buf[s % 2];
// the result is in buf[(sweeps - 1) % 2].
template <typename T>
int launch_jacobi_sweeps(const void* diag, const void* const* cols,
                         const long long* strides, const long long* offsets,
                         int K, const void* b, const void* x0, void* buf0,
                         void* buf1, long long C, int B, int sweeps,
                         double relaxation, cudaStream_t stream) {
  const Columns<T> c = make_columns<T>(cols, strides, offsets, K);
  T* bufs[2] = {static_cast<T*>(buf0), static_cast<T*>(buf1)};
  const T relax = static_cast<T>(relaxation);
  const T omr = static_cast<T>(1.0 - relaxation);
  const T* src = static_cast<const T*>(x0);
  for (int s = 0; s < sweeps; ++s) {
    T* dst = bufs[s % 2];
    jacobi_sweep_kernel<T><<<grid_blocks(C), kThreads, 0, stream>>>(
        static_cast<const T*>(diag), c, static_cast<const T*>(b), src, dst,
        C, B, relax, omr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}

}  // namespace orc

extern "C" int orc_jacobi_sweeps(int dtype, const void* diag,
                                 const void* const* cols,
                                 const long long* strides,
                                 const long long* offsets, int K,
                                 const void* b, const void* x0, void* buf0,
                                 void* buf1, long long C, int B, int sweeps,
                                 double relaxation, void* stream) {
  if (K < 0 || K > orc::MAX_K || B < 1 || sweeps < 1 || C < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == orc::kF32) {
    return orc::launch_jacobi_sweeps<float>(diag, cols, strides, offsets, K,
                                            b, x0, buf0, buf1, C, B, sweeps,
                                            relaxation, s);
  }
  if (dtype == orc::kF64) {
    return orc::launch_jacobi_sweeps<double>(diag, cols, strides, offsets,
                                             K, b, x0, buf0, buf1, C, B,
                                             sweeps, relaxation, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
