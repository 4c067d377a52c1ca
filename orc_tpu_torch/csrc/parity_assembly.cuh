// Fused momentum and pressure-correction assembly of the parity SIMPLE
// loop on Hopper (sm_90a): the kernels and their launchers, included by
// parity_assembly.cu (float32 instances and the C entry points) and
// parity_assembly_f64.cu (float64 instances).
//
// Replaces, in orc_tpu/ops/pallas_assembly.py:
// - `_momentum_kernel`, parity branch (from `momentum_assembly` via
//   `_momentum_asm`) -> momentum_kernel;
// - `_pc_kernel` (from `pc_assembly`) -> pc_kernel;
// with every steady branch the TPU kernels have: UD / CD1 / TVD_DC
// advection, Linear[Weighted] or Rhie-Chow face fluxes (kRC),
// Linear[Weighted] or SecondOrder face pressures (kPSo), and the
// Green-Gauss pressure gradient either streamed as [C,3] or computed in
// the kernel from p (kGG, orc_tpu's `_gg_eval`), and the implicit-Euler
// inertia term of transient runs. LinearWeighted == Linear on a uniform
// box.
//
// Momentum, per cell c over its K static columns (uniform box):
//   F_k   = rho A_k * (interior ? v_f.n_k : boundary flux), with
//           v_f.n = 0.5 (v_c + v_n).n, or under Rhie-Chow
//           0.5 [(v_c + v_n).n + (V/a_c + V/a_n)(p_c - p_n)/d_on
//                + (V/a_c gp_c + V/a_n gp_n) n_a]   (a = md, the shared
//           momentum diagonal of the previous iteration);
//   a_nb  = CD1 ? F/2 : min(F, 0);  d = mu A / dist
//   off_k = a_nb - d_int (interior), diag += -a_nb + F + d,
//   b     = Dirichlet sources - sum_k n_k p_f A_k (p_f Linear, or
//           SecondOrder 0.5 [(p_c + p_n) + gp_c . r_cf + gp_n . r_nf]),
//           under TVD_DC minus the deferred correction F psi(r)/2
//           (phi_D - phi_U) of each interior face (as fc_momentum_kernel,
//           assembly.cu); in transient runs diag += rho V/dt and
//           b += rho V/dt v^n; then Patankar relaxation
//           b += (1-alpha)/alpha diag v_c, diag /= alpha.
// Pressure correction, from the post-momentum velocity and diagonal md
// (and, under Rhie-Chow, the iteration-start p and grad p):
//   b -= F_k,  off_k = -rho A^2 / (0.5 (md_c + md_n)) (interior),
//   diag += rho A^2 / a_face (interior) or rho A^2 / md_c / 2 (every
//   boundary face: the reference's boundary term, kept on purpose).
// The arithmetic follows the TPU kernels term by term.
//
// Bound on the H100: device memory. Momentum reads vel (3), p and one
// int32 flag word per cell (plus md under Rhie-Chow, grad p (3) when
// streamed, grad vel (9) under TVD_DC, rho V/dt and v^n (4) in transient
// runs) and writes diag, K off planes and 3 b rows; the pressure correction reads vel (3), md and flags (plus p
// and grad p under Rhie-Chow) and writes diag, K off planes and b.
// Neighbour reads come from L1/L2 lines of adjacent rows. With kGG the
// gradient of a neighbour reads p two hops away: a plain read per
// thread from device memory, served by L1/L2 (no shared-memory tiling
// yet), in exchange for the [C,3] gradient pass and its planes. Design:
// one thread per cell, the column constants in a kernel-argument
// struct, off written as K contiguous [C] planes so the solver's column
// split is free, every per-face intermediate in registers. Each scheme,
// limiter, face model and gradient source is its own template instance,
// so the branches a configuration does not take cost neither registers
// nor loads. The inertia term is not a template parameter: its two
// pointers are null in steady runs, a branch the same for every thread,
// which keeps the instance count (and nvcc's time) where it was.
#pragma once

#include "assembly.cuh"

namespace orc {

template <typename T>
__device__ __forceinline__ T pick3(int a, T g0, T g1, T g2) {
  return a == 0 ? g0 : (a == 1 ? g1 : g2);
}

// The own cell's gradient on every axis a neighbour column uses
// (computed once per cell, as orc_tpu memoizes gp at offset 0).
template <typename T>
__device__ __forceinline__ void gg_own(const AsmCols<T>& cols,
                                       const T* __restrict__ p,
                                       const T* __restrict__ bc, long long i,
                                       int fl, T p_c, T g[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    g[a] = ((cols.axes >> a) & 1)
               ? gg_gradient(cols, p, bc, i, fl, p_c, cols.gw[a])
               : T(0);
  }
}

// gp_c and gp_n on column k's axis ax: in-kernel (kGG: the neighbour's
// gradient from its own flags and its neighbours' p) or streamed.
template <typename T, bool kGG>
__device__ __forceinline__ void face_gradients(
    const AsmCols<T>& cols, int k, int ax, bool interior, long long i,
    long long j, const T* __restrict__ p, const T* __restrict__ grad_p,
    const T* __restrict__ bc, const int* __restrict__ flags, T p_n,
    const T g_own[3], T& gp_c, T& gp_n) {
  if (kGG) {
    gp_c = pick3(ax, g_own[0], g_own[1], g_own[2]);
    gp_n = interior
               ? gg_gradient(cols, p, bc, j, flags[j], p_n, cols.gwk[k])
               : gp_c;
  } else {
    gp_c = grad_p[3 * i + ax];
    gp_n = interior ? grad_p[3 * j + ax] : gp_c;
  }
}

template <typename T, int kScheme, int kPsi, bool kRC, bool kPSo, bool kGG>
__global__ void momentum_kernel(
    AsmCols<T> cols, const T* __restrict__ vel, const T* __restrict__ p,
    const T* __restrict__ grad_p, const T* __restrict__ md,
    const T* __restrict__ grad_vel, const T* __restrict__ rv_dt,
    const T* __restrict__ vel_n, const T* __restrict__ bc,
    const int* __restrict__ flags, T rho, T mu, T alpha, T vol,
    T* __restrict__ diag_out, T* __restrict__ off_out,
    T* __restrict__ b_out, long long C) {
  constexpr bool kGrad = kRC || kPSo;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < C; i += step) {
    const int fl = flags[i];
    const bool active = (fl >> ACTIVE_BIT) & 1;
    const T u_c = vel[3 * i], v_c = vel[3 * i + 1], w_c = vel[3 * i + 2];
    const T p_c = p[i];
    T g_own[3] = {T(0), T(0), T(0)};
    if (kGG) gg_own(cols, p, bc, i, fl, p_c, g_own);
    const T md_c = kRC ? md[i] : T(1);
    const T voa_c = kRC ? vol / md_c : T(0);
    T diag = T(0), bu = T(0), bv = T(0), bw = T(0);
#pragma unroll
    for (int k = 0; k < kAsmK; ++k) {
      if (k >= cols.K) continue;
      const bool interior = (fl >> k) & 1;
      const long long j = interior ? i + cols.offset[k] : i;
      T u_n = u_c, v_n = v_c, w_n = w_c, p_n = p_c;
      if (interior) {
        u_n = vel[3 * j];
        v_n = vel[3 * j + 1];
        w_n = vel[3 * j + 2];
        p_n = p[j];
      }
      const T* n = cols.n[k];
      const T area = cols.area[k];
      const int ax = cols.axis[k];
      T gp_c = T(0), gp_n = T(0);
      if (kGrad && ax >= 0) {
        face_gradients<T, kGG>(cols, k, ax, interior, i, j, p, grad_p, bc,
                               flags, p_n, g_own, gp_c, gp_n);
      }
      // --- face mass flow F ---
      T vn_int = T(0.5) * dot_n(u_c + u_n, v_c + v_n, w_c + w_n, n);
      if (kRC && ax >= 0) {
        const T term1 = dot_n(u_c + u_n, v_c + v_n, w_c + w_n, n);
        const T voa_n = vol / (interior ? md[j] : md_c);
        const T term2 = (voa_c + voa_n) * (p_c - p_n) * cols.inv_on[k];
        const T term3 = (voa_c * gp_c + voa_n * gp_n) * cols.na[k];
        vn_int = T(0.5) * (term1 + term2 + term3);
      }
      const T vn_bnd = boundary_flux(cols, k, bc, u_c, v_c, w_c);
      const T F = (interior ? vn_int : vn_bnd) * (area * rho);
      // --- advection + diffusion coefficients ---
      const T a_nb = kScheme == kCD1 ? F * T(0.5) : (F < T(0) ? F : T(0));
      const T d_int = mu * area / cols.dist_on[k];
      const T d_bnd = mu * area / cols.dist_fo[k];
      off_out[k * C + i] = (active && interior) ? a_nb - d_int : T(0);
      const int kind = cols.kind[k];
      const bool dirichlet = kind == kWall || kind == kVinlet;
      const T d_b = dirichlet ? d_bnd : T(0);
      diag = diag + (interior ? -a_nb + F + d_int : -a_nb + F + d_b);
      if (dirichlet) {
        // (a_nb - F) v_bc + d_bnd v_bc from the BC table.
        const T s_w = interior ? T(0) : (a_nb - F) + d_bnd;
        const T* row = bc + 4 * cols.zone[k];
        bu = bu + s_w * row[0];
        bv = bv + s_w * row[1];
        bw = bw + s_w * row[2];
      }
      // --- TVD deferred correction (ck_momentum TVD_DC) ---
      if (kScheme == kTvdDc && ax >= 0) {
        const bool up_c = F > T(0);
        const T e_on = cols.e_on[k];
        const T x_c[3] = {u_c, v_c, w_c};
        const T x_n[3] = {u_n, v_n, w_n};
        T acc[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const T gv_c = grad_vel[9 * i + 3 * q + ax];
          const T gv_n = interior ? grad_vel[9 * j + 3 * q + ax] : gv_c;
          const T d_cd = x_n[q] - x_c[q];
          const T delta = up_c ? d_cd : -d_cd;  // phi_D - phi_U
          const T gdotr = up_c ? gv_c * e_on : gv_n * (-e_on);
          const T safe = delta == T(0) ? T(1) : delta;
          const T rr = T(2) * gdotr / safe - T(1);
          const T corr =
              delta == T(0) ? T(0) : tvd_psi<T, kPsi>(rr) * T(0.5) * delta;
          acc[q] = interior ? F * corr : T(0);
        }
        bu = bu - acc[0];
        bv = bv - acc[1];
        bw = bw - acc[2];
      }
      // --- pressure force: -n_out p_f A ---
      const T p_bnd = (kind == kPressure) ? bc[4 * cols.zone[k] + 3] : p_c;
      T p_int = T(0.5) * (p_c + p_n);
      if (kPSo && ax >= 0) {
        // SecondOrder: 0.5 [(p_c + p_n) + gp_c . r_cf + gp_n . r_nf].
        p_int = T(0.5) * ((p_c + p_n) + gp_c * cols.e_c[k] +
                          gp_n * cols.e_n[k]);
      }
      const T p_f = interior ? p_int : p_bnd;
      const T pfA = p_f * area;
      if (n[0] != T(0)) bu = bu - n[0] * pfA;
      if (n[1] != T(0)) bv = bv - n[1] * pfA;
      if (n[2] != T(0)) bw = bw - n[2] * pfA;
    }
    // Implicit-Euler inertia of transient runs (rv_dt and vel_n are null
    // in steady ones, the same for every thread): rho V/dt on the
    // diagonal, rho V/dt vel^n on the RHS, before the relaxation.
    if (rv_dt != nullptr) {
      const T rvdt = rv_dt[i];
      diag = diag + rvdt;
      bu = bu + rvdt * vel_n[3 * i];
      bv = bv + rvdt * vel_n[3 * i + 1];
      bw = bw + rvdt * vel_n[3 * i + 2];
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

template <typename T, bool kRC, bool kGG>
__global__ void pc_kernel(AsmCols<T> cols, const T* __restrict__ vel,
                          const T* __restrict__ md, const T* __restrict__ p,
                          const T* __restrict__ grad_p,
                          const T* __restrict__ bc,
                          const int* __restrict__ flags, T rho, T vol,
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
    const T p_c = kRC ? p[i] : T(0);
    const T voa_c = kRC ? vol / md_c : T(0);
    T g_own[3] = {T(0), T(0), T(0)};
    if (kRC && kGG) gg_own(cols, p, bc, i, fl, p_c, g_own);
    T diag = T(0), b = T(0);
#pragma unroll
    for (int k = 0; k < kAsmK; ++k) {
      if (k >= cols.K) continue;
      const bool interior = (fl >> k) & 1;
      const long long j = interior ? i + cols.offset[k] : i;
      T u_n = u_c, v_n = v_c, w_n = w_c, md_n = md_c;
      if (interior) {
        u_n = vel[3 * j];
        v_n = vel[3 * j + 1];
        w_n = vel[3 * j + 2];
        md_n = md[j];
      }
      const T area = cols.area[k];
      const int ax = cols.axis[k];
      T vn_int =
          T(0.5) * dot_n(u_c + u_n, v_c + v_n, w_c + w_n, cols.n[k]);
      if (kRC && ax >= 0) {
        // Rhie-Chow (ck_flux) with the iteration-start p and grad p.
        const T p_n = interior ? p[j] : p_c;
        T gp_c, gp_n;
        face_gradients<T, kGG>(cols, k, ax, interior, i, j, p, grad_p, bc,
                               flags, p_n, g_own, gp_c, gp_n);
        const T term1 = dot_n(u_c + u_n, v_c + v_n, w_c + w_n, cols.n[k]);
        const T voa_n = vol / md_n;
        const T term2 = (voa_c + voa_n) * (p_c - p_n) * cols.inv_on[k];
        const T term3 = (voa_c * gp_c + voa_n * gp_n) * cols.na[k];
        vn_int = T(0.5) * (term1 + term2 + term3);
      }
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
using MomentumKernel = void (*)(AsmCols<T>, const T*, const T*, const T*,
                                const T*, const T*, const T*, const T*,
                                const T*, const int*, T, T, T, T, T*, T*, T*,
                                long long);

// The instance of a face-flux, face-pressure and gradient choice; the
// gradient source matters only under Rhie-Chow or SecondOrder.
template <typename T, int kScheme, int kPsi>
MomentumKernel<T> momentum_faces(bool rc, bool p_so, bool gg) {
  if (rc && p_so) {
    return gg ? momentum_kernel<T, kScheme, kPsi, true, true, true>
              : momentum_kernel<T, kScheme, kPsi, true, true, false>;
  }
  if (rc) {
    return gg ? momentum_kernel<T, kScheme, kPsi, true, false, true>
              : momentum_kernel<T, kScheme, kPsi, true, false, false>;
  }
  if (p_so) {
    return gg ? momentum_kernel<T, kScheme, kPsi, false, true, true>
              : momentum_kernel<T, kScheme, kPsi, false, true, false>;
  }
  return momentum_kernel<T, kScheme, kPsi, false, false, false>;
}

// The instance of a (scheme, limiter) choice; the limiter code matters
// under TVD_DC only.
template <typename T>
MomentumKernel<T> momentum_select(int scheme, int psi, bool rc, bool p_so,
                                  bool gg) {
  if (scheme == kUD) return momentum_faces<T, kUD, 0>(rc, p_so, gg);
  if (scheme == kCD1) return momentum_faces<T, kCD1, 0>(rc, p_so, gg);
  if (psi == 0) return momentum_faces<T, kTvdDc, 0>(rc, p_so, gg);
  if (psi == 1) return momentum_faces<T, kTvdDc, 1>(rc, p_so, gg);
  return momentum_faces<T, kTvdDc, 2>(rc, p_so, gg);
}

template <typename T>
int launch_momentum(int scheme, int psi, bool rc, bool p_so, bool gg,
                    const AsmCols<T>& c, const void* vel, const void* p,
                    const void* grad_p, const void* md, const void* grad_vel,
                    const void* rv_dt, const void* vel_n, const void* bc,
                    const int* flags, double rho, double mu, double alpha,
                    double vol, void* diag, void* off, void* b, long long C,
                    cudaStream_t stream) {
  const MomentumKernel<T> kernel =
      momentum_select<T>(scheme, psi, rc, p_so, gg);
  kernel<<<grid_blocks(C), kThreads, 0, stream>>>(
      c, static_cast<const T*>(vel), static_cast<const T*>(p),
      static_cast<const T*>(grad_p), static_cast<const T*>(md),
      static_cast<const T*>(grad_vel), static_cast<const T*>(rv_dt),
      static_cast<const T*>(vel_n), static_cast<const T*>(bc), flags,
      static_cast<T>(rho), static_cast<T>(mu), static_cast<T>(alpha),
      static_cast<T>(vol), static_cast<T*>(diag), static_cast<T*>(off),
      static_cast<T*>(b), C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pc(bool rc, bool gg, const AsmCols<T>& c, const void* vel,
              const void* md, const void* p, const void* grad_p,
              const void* bc, const int* flags, double rho, double vol,
              void* diag, void* off, void* b, long long C,
              cudaStream_t stream) {
  void (*kernel)(AsmCols<T>, const T*, const T*, const T*, const T*,
                 const T*, const int*, T, T, T*, T*, T*, long long) =
      !rc ? pc_kernel<T, false, false>
          : (gg ? pc_kernel<T, true, true> : pc_kernel<T, true, false>);
  kernel<<<grid_blocks(C), kThreads, 0, stream>>>(
      c, static_cast<const T*>(vel), static_cast<const T*>(md),
      static_cast<const T*>(p), static_cast<const T*>(grad_p),
      static_cast<const T*>(bc), flags, static_cast<T>(rho),
      static_cast<T>(vol), static_cast<T*>(diag), static_cast<T*>(off),
      static_cast<T*>(b), C);
  return static_cast<int>(cudaGetLastError());
}


// The float64 instances compile in parity_assembly_f64.cu, beside this
// translation unit, so nvcc builds the two halves in parallel.
extern template int launch_momentum<double>(
    int, int, bool, bool, bool, const AsmCols<double>&, const void*,
    const void*, const void*, const void*, const void*, const void*,
    const void*, const void*, const int*, double, double, double, double,
    void*, void*, void*, long long, cudaStream_t);
extern template int launch_pc<double>(bool, bool, const AsmCols<double>&,
                                      const void*, const void*, const void*,
                                      const void*, const void*, const int*,
                                      double, double, void*, void*, void*,
                                      long long, cudaStream_t);

}  // namespace orc
