// Fused momentum and pressure-correction assembly on Hopper (sm_90a).
//
// Replaces: orc_tpu/ops/pallas_assembly.py `_momentum_kernel` (reached
// from `momentum_assembly` via `_momentum_asm`) and `_pc_kernel`
// (reached from `pc_assembly`), for the branches the port's kernel gate
// admits: UD / CD1 advection with Linear[Weighted] face velocities and
// face pressures (LinearWeighted == Linear on a uniform box), implicit
// (Patankar) relaxation, no transient term, no Rhie-Chow, SecondOrder
// pressure or in-kernel Green-Gauss gradient (those branches are later
// work).
//
// Momentum, per cell c over its K static columns (uniform box):
//   F_k   = rho A_k * (interior ? 0.5 (v_c + v_n).n_k : boundary flux)
//   a_nb  = CD1 ? F/2 : min(F, 0);  d = mu A / dist
//   off_k = a_nb - d_int (interior), diag += -a_nb + F + d,
//   b     = Dirichlet sources - sum_k n_k p_f A_k, then Patankar
//           relaxation b += (1-alpha)/alpha diag v_c, diag /= alpha.
// Pressure correction:
//   b -= F_k,  off_k = -rho A^2 / (0.5 (md_c + md_n)) (interior),
//   diag += rho A^2 / a_face (interior) or rho A^2 / md_c / 2 (every
//   boundary face: the reference's boundary term, kept on purpose).
// The arithmetic follows the TPU kernels term by term.
//
// Bound on the H100: device memory. Momentum reads vel (3), p and one
// int32 flag word per cell and writes diag, K off planes and 3 b rows:
// about (4 + 1 + K + 3) * sizeof(T) + 4 bytes per cell at B = 1; the
// pressure correction reads vel (3), md and flags and writes diag, K
// off planes and b: (4 + 2 + K) * sizeof(T) + 4. Neighbour reads come
// from L1/L2 lines of adjacent rows. Design: one thread per cell, the
// column constants (offset, area, n_out, distances, BC kind, zone) in a
// kernel-argument struct, the [Z,4] BC table read from device memory,
// off written as K contiguous [C] planes so the solver's column split
// is free. Every per-face intermediate stays in registers.
#include "common.cuh"

namespace orc {

constexpr int ACTIVE_BIT = 6;
enum Kind { kWall = 0, kSymmetry = 1, kPressure = 2, kVinlet = 3 };

template <typename T>
struct AsmCols {
  long long offset[MAX_K];
  T area[MAX_K];
  T n[MAX_K][3];
  T dist_fo[MAX_K];
  T dist_on[MAX_K];
  int kind[MAX_K];
  int zone[MAX_K];
  int K;
};

template <typename T>
AsmCols<T> make_asm_cols(const long long* offsets, const double* geom,
                         const int* kind, const int* zone, int K) {
  AsmCols<T> c{};
  c.K = K;
  for (int k = 0; k < K; ++k) {
    c.offset[k] = offsets[k];
    c.area[k] = static_cast<T>(geom[6 * k + 0]);
    c.n[k][0] = static_cast<T>(geom[6 * k + 1]);
    c.n[k][1] = static_cast<T>(geom[6 * k + 2]);
    c.n[k][2] = static_cast<T>(geom[6 * k + 3]);
    c.dist_fo[k] = static_cast<T>(geom[6 * k + 4]);
    c.dist_on[k] = static_cast<T>(geom[6 * k + 5]);
    c.kind[k] = kind[k];
    c.zone[k] = zone[k];
  }
  return c;
}

// u*nx + v*ny + w*nz skipping zero components and unit factors, as the
// TPU kernels' _dot_n does (axis-aligned normals: one term survives).
template <typename T>
__device__ __forceinline__ T dot_n(T u, T v, T w, const T* n) {
  T acc = T(0);
  bool have = false;
  const T vals[3] = {u, v, w};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (n[a] != T(0)) {
      const T t = (n[a] == T(1)) ? vals[a] : vals[a] * n[a];
      acc = have ? acc + t : t;
      have = true;
    }
  }
  return acc;
}

template <typename T>
__device__ __forceinline__ T boundary_flux(const AsmCols<T>& cols, int k,
                                           const T* __restrict__ bc, T u_c,
                                           T v_c, T w_c) {
  const int kind = cols.kind[k];
  if (kind == kPressure) return dot_n(u_c, v_c, w_c, cols.n[k]);
  if (kind == kVinlet) {
    const T* row = bc + 4 * cols.zone[k];
    return dot_n(row[0], row[1], row[2], cols.n[k]);
  }
  return T(0);  // wall / symmetry: no flux through the face
}

template <typename T, bool kCD1>
__global__ void momentum_kernel(AsmCols<T> cols, const T* __restrict__ vel,
                                const T* __restrict__ p,
                                const T* __restrict__ bc,
                                const int* __restrict__ flags, T rho, T mu,
                                T alpha, T* __restrict__ diag_out,
                                T* __restrict__ off_out,
                                T* __restrict__ b_out, long long C) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < C; i += step) {
    const int fl = flags[i];
    const bool active = (fl >> ACTIVE_BIT) & 1;
    const T u_c = vel[3 * i], v_c = vel[3 * i + 1], w_c = vel[3 * i + 2];
    const T p_c = p[i];
    T diag = T(0), bu = T(0), bv = T(0), bw = T(0);
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) {
      if (k >= cols.K) continue;
      const bool interior = (fl >> k) & 1;
      T u_n = u_c, v_n = v_c, w_n = w_c, p_n = p_c;
      if (interior) {
        const long long j = i + cols.offset[k];
        u_n = vel[3 * j];
        v_n = vel[3 * j + 1];
        w_n = vel[3 * j + 2];
        p_n = p[j];
      }
      const T* n = cols.n[k];
      const T area = cols.area[k];
      // --- face mass flow F ---
      const T vn_int = T(0.5) * dot_n(u_c + u_n, v_c + v_n, w_c + w_n, n);
      const T vn_bnd = boundary_flux(cols, k, bc, u_c, v_c, w_c);
      const T F = (interior ? vn_int : vn_bnd) * (area * rho);
      // --- advection + diffusion coefficients ---
      const T a_nb = kCD1 ? F * T(0.5) : (F < T(0) ? F : T(0));
      const T d_int = mu * area / cols.dist_on[k];
      const T d_bnd = mu * area / cols.dist_fo[k];
      off_out[k * C + i] = (active && interior) ? a_nb - d_int : T(0);
      const int kind = cols.kind[k];
      const bool dirichlet = kind == kWall || kind == kVinlet;
      const T d_b = dirichlet ? d_bnd : T(0);
      diag = diag + (interior ? -a_nb + F + d_int : -a_nb + F + d_b);
      if (dirichlet) {
        // (a_nb - F) v_bc + d_bnd v_bc from the traced BC table.
        const T s_w = interior ? T(0) : (a_nb - F) + d_bnd;
        const T* row = bc + 4 * cols.zone[k];
        bu = bu + s_w * row[0];
        bv = bv + s_w * row[1];
        bw = bw + s_w * row[2];
      }
      // --- pressure force: -n_out p_f A ---
      const T p_bnd = (kind == kPressure) ? bc[4 * cols.zone[k] + 3] : p_c;
      const T p_f = interior ? T(0.5) * (p_c + p_n) : p_bnd;
      const T pfA = p_f * area;
      if (n[0] != T(0)) bu = bu - n[0] * pfA;
      if (n[1] != T(0)) bv = bv - n[1] * pfA;
      if (n[2] != T(0)) bw = bw - n[2] * pfA;
    }
    // Implicit (Patankar) relaxation + inactive padding rows.
    bu = bu + (T(1) - alpha) / alpha * diag * u_c;
    bv = bv + (T(1) - alpha) / alpha * diag * v_c;
    bw = bw + (T(1) - alpha) / alpha * diag * w_c;
    diag = diag / alpha;
    diag_out[i] = active ? diag : T(1);
    b_out[i] = active ? bu : T(0);
    b_out[C + i] = active ? bv : T(0);
    b_out[2 * C + i] = active ? bw : T(0);
  }
}

template <typename T>
__global__ void pc_kernel(AsmCols<T> cols, const T* __restrict__ vel,
                          const T* __restrict__ md,
                          const T* __restrict__ bc,
                          const int* __restrict__ flags, T rho,
                          T* __restrict__ diag_out, T* __restrict__ off_out,
                          T* __restrict__ b_out, long long C) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < C; i += step) {
    const int fl = flags[i];
    const bool active = (fl >> ACTIVE_BIT) & 1;
    const T u_c = vel[3 * i], v_c = vel[3 * i + 1], w_c = vel[3 * i + 2];
    const T md_c = md[i];
    T diag = T(0), b = T(0);
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) {
      if (k >= cols.K) continue;
      const bool interior = (fl >> k) & 1;
      T u_n = u_c, v_n = v_c, w_n = w_c, md_n = md_c;
      if (interior) {
        const long long j = i + cols.offset[k];
        u_n = vel[3 * j];
        v_n = vel[3 * j + 1];
        w_n = vel[3 * j + 2];
        md_n = md[j];
      }
      const T area = cols.area[k];
      const T vn_int =
          T(0.5) * dot_n(u_c + u_n, v_c + v_n, w_c + w_n, cols.n[k]);
      const T vn_bnd = boundary_flux(cols, k, bc, u_c, v_c, w_c);
      const T F2 = (interior ? vn_int : vn_bnd) * (area * rho);
      b = b - F2;
      // Shared momentum diagonal: |md n| == md for unit normals.
      const T a_face = T(0.5) * (md_c + md_n);
      const T a_nb = (rho * area * area) / a_face;
      const T a_bnd = (rho * area * area) / md_c * T(0.5);
      off_out[k * C + i] = (active && interior) ? -a_nb : T(0);
      diag = diag + (interior ? a_nb : a_bnd);
    }
    diag_out[i] = active ? diag : T(1);
    b_out[i] = active ? b : T(0);
  }
}

template <typename T>
int launch_momentum(int scheme, const AsmCols<T>& c, const void* vel,
                    const void* p, const void* bc, const int* flags,
                    double rho, double mu, double alpha, void* diag,
                    void* off, void* b, long long C, cudaStream_t stream) {
  void (*kernel)(AsmCols<T>, const T*, const T*, const T*, const int*, T, T,
                 T, T*, T*, T*, long long) =
      scheme == 1 ? momentum_kernel<T, true> : momentum_kernel<T, false>;
  kernel<<<grid_blocks(C), kThreads, 0, stream>>>(
      c, static_cast<const T*>(vel), static_cast<const T*>(p),
      static_cast<const T*>(bc), flags, static_cast<T>(rho),
      static_cast<T>(mu), static_cast<T>(alpha), static_cast<T*>(diag),
      static_cast<T*>(off), static_cast<T*>(b), C);
  return static_cast<int>(cudaGetLastError());
}

bool valid_cols(const int* kind, int K) {
  if (K < 1 || K > MAX_K) return false;
  for (int k = 0; k < K; ++k) {
    if (kind[k] < kWall || kind[k] > kVinlet) return false;
  }
  return true;
}

}  // namespace orc

extern "C" int orc_momentum_assembly(
    int dtype, int scheme, const long long* col_offsets,
    const double* col_geom, const int* col_kind, const int* col_zone, int K,
    const void* vel, const void* p, const void* bc, const void* flags,
    double rho, double mu, double alpha, void* diag, void* off, void* b,
    long long C, void* stream) {
  if (!orc::valid_cols(col_kind, K) || (scheme != 0 && scheme != 1) ||
      C < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int* fl = static_cast<const int*>(flags);
  if (dtype == orc::kF32) {
    const auto c =
        orc::make_asm_cols<float>(col_offsets, col_geom, col_kind, col_zone, K);
    return orc::launch_momentum<float>(scheme, c, vel, p, bc, fl, rho, mu,
                                       alpha, diag, off, b, C, s);
  }
  if (dtype == orc::kF64) {
    const auto c = orc::make_asm_cols<double>(col_offsets, col_geom,
                                              col_kind, col_zone, K);
    return orc::launch_momentum<double>(scheme, c, vel, p, bc, fl, rho, mu,
                                        alpha, diag, off, b, C, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int orc_pc_assembly(int dtype, const long long* col_offsets,
                               const double* col_geom, const int* col_kind,
                               const int* col_zone, int K, const void* vel,
                               const void* md, const void* bc,
                               const void* flags, double rho, void* diag,
                               void* off, void* b, long long C,
                               void* stream) {
  if (!orc::valid_cols(col_kind, K) || C < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int* fl = static_cast<const int*>(flags);
  const unsigned blocks = orc::grid_blocks(C);
  if (dtype == orc::kF32) {
    const auto c =
        orc::make_asm_cols<float>(col_offsets, col_geom, col_kind, col_zone, K);
    orc::pc_kernel<float><<<blocks, orc::kThreads, 0, s>>>(
        c, static_cast<const float*>(vel), static_cast<const float*>(md),
        static_cast<const float*>(bc), fl, static_cast<float>(rho),
        static_cast<float*>(diag), static_cast<float*>(off),
        static_cast<float*>(b), C);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == orc::kF64) {
    const auto c = orc::make_asm_cols<double>(col_offsets, col_geom,
                                              col_kind, col_zone, K);
    orc::pc_kernel<double><<<blocks, orc::kThreads, 0, s>>>(
        c, static_cast<const double*>(vel), static_cast<const double*>(md),
        static_cast<const double*>(bc), fl, rho, static_cast<double*>(diag),
        static_cast<double*>(off), static_cast<double*>(b), C);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
