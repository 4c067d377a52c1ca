// C entry points of the parity assembly kernels (parity_assembly.cuh)
// and their float32 instances; the float64 instances are in
// parity_assembly_f64.cu.
#include "parity_assembly.cuh"

extern "C" int orc_momentum_assembly(
    int dtype, int scheme, int psi, int rc, int p_so, int gg,
    const long long* col_offsets, const double* col_geom, const int* col_kind,
    const int* col_zone, int K, long long nx, long long ny, long long nz,
    long long row0, const void* vel, const void* p, const void* grad_p,
    const void* md, const void* grad_vel, const void* rv_dt,
    const void* vel_n, const void* bc, const void* flags, double rho,
    double mu, double alpha, double vol, void* diag, void* off, void* b,
    long long C, void* stream) {
  const bool grad = rc || p_so;
  const bool in_kernel = grad && gg;
  if (!orc::valid_box(nx, ny, nz, row0, C) ||
      !orc::valid_cols(col_kind, K) || scheme < orc::kUD ||
      scheme > orc::kTvdDc || psi < 0 || psi > 2 ||
      (grad && !in_kernel && grad_p == nullptr) || (rc && md == nullptr) ||
      (scheme == orc::kTvdDc && grad_vel == nullptr) ||
      ((rc || in_kernel) && !(vol > 0.0)) ||
      ((rv_dt == nullptr) != (vel_n == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int* fl = static_cast<const int*>(flags);
  if (dtype == orc::kF32) {
    const auto c = orc::make_asm_cols<float>(col_offsets, col_geom, col_kind,
                                             col_zone, K, vol);
    return orc::launch_momentum<float>(
        scheme, psi, rc != 0, p_so != 0, in_kernel, c, static_cast<int>(nx),
        static_cast<int>(ny), static_cast<int>(nz), static_cast<int>(row0),
        vel, p, grad_p, md, grad_vel, rv_dt, vel_n, bc, fl, rho, mu, alpha,
        vol, diag, off, b, C, s);
  }
  if (dtype == orc::kF64) {
    const auto c = orc::make_asm_cols<double>(col_offsets, col_geom, col_kind,
                                              col_zone, K, vol);
    return orc::launch_momentum<double>(
        scheme, psi, rc != 0, p_so != 0, in_kernel, c, static_cast<int>(nx),
        static_cast<int>(ny), static_cast<int>(nz), static_cast<int>(row0),
        vel, p, grad_p, md, grad_vel, rv_dt, vel_n, bc, fl, rho, mu, alpha,
        vol, diag, off, b, C, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int orc_pc_assembly(int dtype, int rc, int gg,
                               const long long* col_offsets,
                               const double* col_geom, const int* col_kind,
                               const int* col_zone, int K, long long nx,
                               long long ny, long long nz, long long row0,
                               const void* vel, const void* md, const void* p,
                               const void* grad_p, const void* bc,
                               const void* flags, double rho, double vol,
                               void* diag, void* off, void* b, long long C,
                               void* stream) {
  const bool in_kernel = rc && gg;
  if (!orc::valid_box(nx, ny, nz, row0, C) ||
      !orc::valid_cols(col_kind, K) || (rc && p == nullptr) ||
      (rc && !in_kernel && grad_p == nullptr) ||
      (rc && !(vol > 0.0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int* fl = static_cast<const int*>(flags);
  const int bx = static_cast<int>(nx), by = static_cast<int>(ny),
            bz = static_cast<int>(nz), r0 = static_cast<int>(row0);
  if (dtype == orc::kF32) {
    const auto c = orc::make_asm_cols<float>(col_offsets, col_geom, col_kind,
                                             col_zone, K, vol);
    return orc::launch_pc<float>(rc != 0, in_kernel, c, bx, by, bz, r0, vel,
                                 md, p, grad_p, bc, fl, rho, vol, diag, off, b,
                                 C, s);
  }
  if (dtype == orc::kF64) {
    const auto c = orc::make_asm_cols<double>(col_offsets, col_geom, col_kind,
                                              col_zone, K, vol);
    return orc::launch_pc<double>(rc != 0, in_kernel, c, bx, by, bz, r0, vel,
                                  md, p, grad_p, bc, fl, rho, vol, diag, off,
                                  b, C, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
