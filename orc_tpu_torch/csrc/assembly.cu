// Fused SIMPLE_FC momentum and pressure assembly on Hopper (sm_90a).
//
// Replaces, in orc_tpu/ops/pallas_assembly.py:
// - `_momentum_kernel`, SIMPLE_FC branch (from `fc_momentum_assembly`)
//   -> fc_momentum_kernel;
// - `_fc_pc_kernel` (from `fc_pc_assembly`) -> fc_pc_kernel.
// The parity kernels live in parity_assembly.cuh, the shared column
// constants and face helpers in assembly.cuh. The arithmetic follows
// the TPU kernels term by term.
#include "assembly.cuh"

namespace orc {

// fc_momentum_kernel: the momentum system of the parity momentum_kernel
// (parity_assembly.cuh), advected with the stored conservative flux
// (F = flux_k * area * rho, the flux a [K,C] planes array written by
// the previous correction) instead of interpolated face velocities.
// Scheme UD / CD1, or TVD_DC: the UD
// matrix plus, on each interior face, the deferred correction
// -F psi(r)/2 (phi_D - phi_U) per velocity component, with
// r = 2 grad_U . r_UD / (phi_D - phi_U) - 1 from the streamed [C,3,3]
// velocity gradient; a face with phi_D == phi_U takes none. The limiter
// psi is a template code (tvd_lud 0, tvd_quick 1, tvd_umist 2): a
// kernel takes no Python callable. Face pressures are Linear, or
// SecondOrder (kPSo) from the streamed [C,3] grad p. The inertia term of
// transient runs (nullable rv_dt, vel_n), Patankar relaxation and
// inactive rows as the parity momentum_kernel.
//
// fc_pc_kernel: the SIMPLE_FC full-p continuity system and the flux
// predictor in one pass (orc_tpu/solver/fc.py ck_flux_h + ck_d_coeffs
// + ck_fc_pressure_system):
//   flux_h = 0.5 (v_c + v_n).n  (+ 0.5 (V/md_c gp_c + V/md_n gp_n) na,
//            the Rhie-Chow term3, under kRC), the boundary rules of
//            the parity kernels on boundary faces, written as K planes;
//   d_int  = 0.5 rho A / d_on (V/md_c + V/md_n), off = -d_int;
//   pressure columns close with d_bnd = rho A / d_fo V/md_c and add
//   d_bnd p_BC to b; prescribed-flux boundaries add nothing;
//   b      = -sum_k flux_h A rho (+ the p_BC sources).
//
// Bound on the H100: device memory, as the parity kernels, plus the
// K flux planes (momentum) or the K flux_h planes (pressure), and for
// TVD_DC six grad-vel reads per column (two cells x three components,
// mostly L1/L2 hits of neighbouring rows). Each scheme, limiter and
// face-pressure choice is its own template instance, so the branches a
// configuration does not take cost neither registers nor loads.

template <typename T, int kScheme, int kPsi, bool kPSo>
__global__ void fc_momentum_kernel(
    AsmCols<T> cols, const T* __restrict__ vel, const T* __restrict__ p,
    const T* __restrict__ flux, const T* __restrict__ grad_p,
    const T* __restrict__ grad_vel, const T* __restrict__ rv_dt,
    const T* __restrict__ vel_n, const T* __restrict__ bc,
    const int* __restrict__ flags, T rho, T mu, T alpha,
    T* __restrict__ diag_out, T* __restrict__ off_out,
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
    for (int k = 0; k < kAsmK; ++k) {
      if (k >= cols.K) continue;
      const bool interior = (fl >> k) & 1;
      const long long j = interior ? i + cols.offset[k] : i;
      const T p_n = interior ? p[j] : p_c;
      const T* n = cols.n[k];
      const T area = cols.area[k];
      const int ax = cols.axis[k];
      // --- face mass flow: the stored conservative flux ---
      const T F = flux[k * C + i] * (area * rho);
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
        T acc[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const T x_n = interior ? vel[3 * j + q] : x_c[q];
          const T gv_c = grad_vel[9 * i + 3 * q + ax];
          const T gv_n = interior ? grad_vel[9 * j + 3 * q + ax] : gv_c;
          const T d_cd = x_n - x_c[q];
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
        const T gp_c = grad_p[3 * i + ax];
        const T gp_n = interior ? grad_p[3 * j + ax] : gp_c;
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

template <typename T, bool kRC>
__global__ void fc_pc_kernel(AsmCols<T> cols, const T* __restrict__ vel,
                             const T* __restrict__ md,
                             const T* __restrict__ grad_p,
                             const T* __restrict__ bc,
                             const int* __restrict__ flags, T rho, T vol,
                             T* __restrict__ diag_out,
                             T* __restrict__ off_out, T* __restrict__ b_out,
                             T* __restrict__ fh_out, long long C) {
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
      // Flux predictor: no compact pressure term (the equation re-adds
      // it with the new p); term3 only under Rhie-Chow.
      const T term1 = dot_n(u_c + u_n, v_c + v_n, w_c + w_n, cols.n[k]);
      T vn_int = T(0.5) * term1;
      if (kRC && ax >= 0) {
        const T gp_c = grad_p[3 * i + ax];
        const T gp_n = interior ? grad_p[3 * j + ax] : gp_c;
        const T voa_c = vol / md_c;
        const T voa_n = vol / md_n;
        const T term3 = (voa_c * gp_c + voa_n * gp_n) * cols.na[k];
        vn_int = T(0.5) * (term1 + term3);
      }
      const T vn_bnd = boundary_flux(cols, k, bc, u_c, v_c, w_c);
      const T fh = interior ? vn_int : vn_bnd;
      fh_out[k * C + i] = active ? fh : T(0);
      b = b - fh * (area * rho);
      // d coefficients: |md n| == md for unit normals, V/a == vol/md.
      const T d_int =
          (T(0.5) * rho * area / cols.dist_on[k]) * (vol / md_c + vol / md_n);
      off_out[k * C + i] = (active && interior) ? -d_int : T(0);
      if (cols.kind[k] == kPressure) {
        const T d_bnd = (rho * area / cols.dist_fo[k]) * (vol / md_c);
        diag = diag + (interior ? d_int : d_bnd);
        const T p_bc = bc[4 * cols.zone[k] + 3];
        b = b + (interior ? T(0) : d_bnd * p_bc);
      } else {
        // Prescribed-flux boundaries: no matrix contribution.
        diag = diag + (interior ? d_int : T(0));
      }
    }
    diag_out[i] = active ? diag : T(1);
    b_out[i] = active ? b : T(0);
  }
}

template <typename T>
using FcMomentumKernel = void (*)(AsmCols<T>, const T*, const T*, const T*,
                                  const T*, const T*, const T*, const T*,
                                  const T*, const int*, T, T, T, T*, T*, T*,
                                  long long);

template <typename T, int kScheme, int kPsi>
FcMomentumKernel<T> fc_momentum_pick(bool p_so) {
  return p_so ? fc_momentum_kernel<T, kScheme, kPsi, true>
              : fc_momentum_kernel<T, kScheme, kPsi, false>;
}

// The instance of a (scheme, limiter, face pressure) choice; the
// limiter code matters under TVD_DC only.
template <typename T>
FcMomentumKernel<T> fc_momentum_select(int scheme, int psi, bool p_so) {
  if (scheme == kUD) return fc_momentum_pick<T, kUD, 0>(p_so);
  if (scheme == kCD1) return fc_momentum_pick<T, kCD1, 0>(p_so);
  if (psi == 0) return fc_momentum_pick<T, kTvdDc, 0>(p_so);
  if (psi == 1) return fc_momentum_pick<T, kTvdDc, 1>(p_so);
  return fc_momentum_pick<T, kTvdDc, 2>(p_so);
}

template <typename T>
int launch_fc_momentum(int scheme, int psi, bool p_so, const AsmCols<T>& c,
                       const void* vel, const void* p, const void* flux,
                       const void* grad_p, const void* grad_vel,
                       const void* rv_dt, const void* vel_n, const void* bc,
                       const int* flags, double rho, double mu, double alpha,
                       void* diag, void* off, void* b, long long C,
                       cudaStream_t stream) {
  const FcMomentumKernel<T> kernel = fc_momentum_select<T>(scheme, psi, p_so);
  kernel<<<grid_blocks(C), kThreads, 0, stream>>>(
      c, static_cast<const T*>(vel), static_cast<const T*>(p),
      static_cast<const T*>(flux), static_cast<const T*>(grad_p),
      static_cast<const T*>(grad_vel), static_cast<const T*>(rv_dt),
      static_cast<const T*>(vel_n), static_cast<const T*>(bc), flags,
      static_cast<T>(rho), static_cast<T>(mu), static_cast<T>(alpha),
      static_cast<T*>(diag), static_cast<T*>(off), static_cast<T*>(b), C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fc_pc(bool rc, const AsmCols<T>& c, const void* vel,
                 const void* md, const void* grad_p, const void* bc,
                 const int* flags, double rho, double vol, void* diag,
                 void* off, void* b, void* flux_h, long long C,
                 cudaStream_t stream) {
  void (*kernel)(AsmCols<T>, const T*, const T*, const T*, const T*,
                 const int*, T, T, T*, T*, T*, T*, long long) =
      rc ? fc_pc_kernel<T, true> : fc_pc_kernel<T, false>;
  kernel<<<grid_blocks(C), kThreads, 0, stream>>>(
      c, static_cast<const T*>(vel), static_cast<const T*>(md),
      static_cast<const T*>(grad_p), static_cast<const T*>(bc), flags,
      static_cast<T>(rho), static_cast<T>(vol), static_cast<T*>(diag),
      static_cast<T*>(off), static_cast<T*>(b), static_cast<T*>(flux_h), C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace orc

extern "C" int orc_fc_momentum_assembly(
    int dtype, int scheme, int psi, int p_so, const long long* col_offsets,
    const double* col_geom, const int* col_kind, const int* col_zone, int K,
    const void* vel, const void* p, const void* flux, const void* grad_p,
    const void* grad_vel, const void* rv_dt, const void* vel_n,
    const void* bc, const void* flags, double rho, double mu, double alpha,
    void* diag, void* off, void* b, long long C, void* stream) {
  if (!orc::valid_cols(col_kind, K) || scheme < orc::kUD ||
      scheme > orc::kTvdDc || psi < 0 || psi > 2 || C < 0 ||
      (p_so && grad_p == nullptr) ||
      (scheme == orc::kTvdDc && grad_vel == nullptr) ||
      ((rv_dt == nullptr) != (vel_n == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int* fl = static_cast<const int*>(flags);
  if (dtype == orc::kF32) {
    const auto c =
        orc::make_asm_cols<float>(col_offsets, col_geom, col_kind, col_zone, K);
    return orc::launch_fc_momentum<float>(scheme, psi, p_so != 0, c, vel, p,
                                          flux, grad_p, grad_vel, rv_dt, vel_n,
                                          bc, fl, rho, mu, alpha, diag, off, b,
                                          C, s);
  }
  if (dtype == orc::kF64) {
    const auto c = orc::make_asm_cols<double>(col_offsets, col_geom,
                                              col_kind, col_zone, K);
    return orc::launch_fc_momentum<double>(scheme, psi, p_so != 0, c, vel, p,
                                           flux, grad_p, grad_vel, rv_dt,
                                           vel_n, bc, fl, rho, mu, alpha, diag,
                                           off, b, C, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int orc_fc_pc_assembly(int dtype, int rc,
                                  const long long* col_offsets,
                                  const double* col_geom, const int* col_kind,
                                  const int* col_zone, int K, const void* vel,
                                  const void* md, const void* grad_p,
                                  const void* bc, const void* flags,
                                  double rho, double vol, void* diag,
                                  void* off, void* b, void* flux_h,
                                  long long C, void* stream) {
  if (!orc::valid_cols(col_kind, K) || C < 0 || (rc && grad_p == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int* fl = static_cast<const int*>(flags);
  if (dtype == orc::kF32) {
    const auto c =
        orc::make_asm_cols<float>(col_offsets, col_geom, col_kind, col_zone, K);
    return orc::launch_fc_pc<float>(rc != 0, c, vel, md, grad_p, bc, fl, rho,
                                    vol, diag, off, b, flux_h, C, s);
  }
  if (dtype == orc::kF64) {
    const auto c = orc::make_asm_cols<double>(col_offsets, col_geom,
                                              col_kind, col_zone, K);
    return orc::launch_fc_pc<double>(rc != 0, c, vel, md, grad_p, bc, fl, rho,
                                     vol, diag, off, b, flux_h, C, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
