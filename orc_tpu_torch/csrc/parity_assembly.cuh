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
// runs) and writes diag, K off planes and 3 b rows; the pressure
// correction reads vel (3), md and flags (plus p and grad p under
// Rhie-Chow) and writes diag, K off planes and b.
//
// Design shared by both: the column constants in a kernel-argument
// struct, off written as K contiguous [C] planes so the solver's column
// split is free, every per-face intermediate in registers. Each scheme,
// limiter, face model and gradient source is its own template instance,
// so the branches a configuration does not take cost neither registers
// nor loads. The inertia term is not a template parameter: its two
// pointers are null in steady runs, a branch the same for every thread,
// which keeps the instance count (and nvcc's time) where it was.
//
// momentum_kernel. Its first design: one thread per cell, grid-stride;
// up to K + 1 threads recomputed each cell's Green-Gauss gradient, a
// neighbour's gradient waited on flags[i], flags[j] and then p, and the
// velocity was read as [C,3] with stride 3 (CD1+SO+RC+GG at 1024^2 f32:
// 0.1199 ms against a 0.0200 ms bound on an NVIDIA H100 80GB HBM3 at
// 700 W). Now a CTA takes a tile of the box (32 x 8 cells in 2-D,
// 16 x 4 x 4 in 3-D, down to 64 cells where a small box would leave SMs
// idle; one cell per thread; BoxTile) and:
//  1. stages p over the tile and its face neighbours two cells out
//     along each axis under kGG (one otherwise), and the flag words, the
//     velocity (transposed into three planes), V / md (kRC, one division
//     a cell) and a streamed gradient over the tile and one cell out, in
//     shared memory with coalesced reads;
//  2. under kGG computes the Green-Gauss gradient once per cell, of the
//     tile's cells on the axes the columns use and of each face
//     neighbour on its face's axis, into shared memory (the first
//     design's arithmetic and column order);
//  3. assembles each cell from the stage and writes diag, the K off
//     planes and the 3 b rows, coalesced.
// grad vel (TVD_DC) and the inertia pair stay global reads: the first
// is read at two cells per face on one axis, the second once per cell.
// Every per-face expression is the first design's, so nvcc contracts
// it the same way and the results are unchanged bit for bit.
//
// pc_kernel has the same first design, kept for the Linear instance and
// the Rhie-Chow instance with a streamed gradient: in box tiles both
// ran slower than grid-stride on the 128^3 box (Linear 0.0566 against
// 0.0509 ms, streamed 0.0876 against 0.0755; the halo staged 2.1 cells a
// cell there) and no faster at 1024^2 (0.0278 against 0.0280, 0.0410
// against 0.0396), NVIDIA H100 80GB HBM3 at 700 W; both run above half
// their bound. The Rhie-Chow instance with the in-kernel gradient (RC+GG
// at 1024^2 f32: 0.0599 ms against a 0.0175 ms bound, the gradient 1.5x
// a streamed one) is pc_gg_kernel: momentum_kernel's tiles and steps, a
// halo of two cells; the flag words, the velocity as three planes, md, p
// and V / md (once a cell) staged in shared memory, the gradient
// computed once per cell; A rho and (rho A) A from the host (PcConsts),
// the boundary term rho A^2 / md / 2 formed on boundary faces only. Each
// per-face expression is pc_kernel's.
#pragma once

#include "assembly.cuh"

namespace orc {

// orc_tpu's `_gg_eval` of the cell in slot s with Linear face
// pressures, exactly ck_pressure_gradient: the sum in column order over
// the columns with a weight w[k] (cols.gw[a] for axis a) of the mean of
// the two cells on interior faces, the BC value on pressure boundaries,
// the cell's own value on the others, the neighbours' p read from the
// stage.
template <typename T>
__device__ __forceinline__ T gg_gradient_tile(const AsmCols<T>& cols,
                                              const BoxTile& t, const T* ps,
                                              const T* __restrict__ bc,
                                              int s, int fl, T p_c,
                                              const T* w) {
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < kAsmK; ++k) {
    if (k >= cols.K || w[k] == T(0)) continue;
    T p_f;
    if ((fl >> k) & 1) {
      p_f = T(0.5) * (p_c + ps[s + t.ds[k]]);
    } else {
      p_f = cols.kind[k] == kPressure ? bc[4 * cols.zone[k] + 3] : p_c;
    }
    acc = acc + w[k] * p_f;
  }
  return acc;
}

// The Green-Gauss gradient of each face neighbour of the tile (the halo
// one cell out), on the axis of its face, into gs[a * S + s]; p is
// staged two cells out, the flag words one. The tile's own cells are
// their threads' (tile_gg_own).
template <typename T>
__device__ __forceinline__ void tile_gg_halo(const AsmCols<T>& cols,
                                             const BoxTile& t, const T* ps,
                                             const int* fs,
                                             const T* __restrict__ bc, T* gs,
                                             int S) {
  const int nh = t.nh_x + t.nh_y + t.nh_z;
  for (int q = threadIdx.x; q < nh; q += blockDim.x) {
    int x, y, z, d, a;
    halo_slot(t, q, x, y, z, d, a);
    const int s = x + t.sx * (y + t.sy * z);
    if (d == 1 && ((cols.axes >> a) & 1)) {
      gs[a * S + s] =
          gg_gradient_tile(cols, t, ps, bc, s, fs[s], ps[s], cols.gw[a]);
    }
  }
}

// The gradient of the tile cell in slot s on each axis a column uses,
// into gs and g.
template <typename T>
__device__ __forceinline__ void tile_gg_own(const AsmCols<T>& cols,
                                            const BoxTile& t, const T* ps,
                                            const T* __restrict__ bc, T* gs,
                                            int S, int s, int fl, T p_c,
                                            T g[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    g[a] = T(0);
    if ((cols.axes >> a) & 1) {
      g[a] = gg_gradient_tile(cols, t, ps, bc, s, fl, p_c, cols.gw[a]);
      gs[a * S + s] = g[a];
    }
  }
}

// Shared memory of a momentum tile: p, u, v, w, V / md (kRC) and three
// gradient planes (kRC or kPSo) of T, then the int32 flag words.
template <typename T>
inline long long momentum_smem_bytes(const BoxTile& t, bool rc, bool grad) {
  const long long S = static_cast<long long>(t.sx) * t.sy * t.sz;
  return S * (static_cast<long long>(sizeof(T)) * (4 + rc + 3 * grad) + 4);
}

template <typename T, int kScheme, int kPsi, bool kRC, bool kPSo, bool kGG>
__global__ void momentum_kernel(
    AsmCols<T> cols, BoxTile box, MomentumConsts<T> mc,
    const T* __restrict__ vel,
    const T* __restrict__ p, const T* __restrict__ grad_p,
    const T* __restrict__ md, const T* __restrict__ grad_vel,
    const T* __restrict__ rv_dt, const T* __restrict__ vel_n,
    const T* __restrict__ bc, const int* __restrict__ flags, T alpha, T vol,
    T* __restrict__ diag_out, T* __restrict__ off_out, T* __restrict__ b_out,
    long long C) {
  constexpr bool kGrad = kRC || kPSo;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = box.sx * box.sy * box.sz;
  T* ps = reinterpret_cast<T*>(smem);
  T* us = ps + S;
  T* vs = us + S;
  T* ws = vs + S;
  T* voas = ws + S;
  T* gs = voas + (kRC ? S : 0);
  int* fs = reinterpret_cast<int*>(gs + (kGrad ? 3 * S : 0));
  // Rows in 32 bits: the launcher checks that every staged row fits.
  const int nx = box.nx, nxy = box.nx * box.ny, rows = static_cast<int>(C);
  const int x0 = static_cast<int>(blockIdx.x) * box.bx - box.hx;
  const int y0 = static_cast<int>(blockIdx.y) * box.by - box.hy;
  const int z0 = static_cast<int>(blockIdx.z) * box.bz - box.hz;
  // Stages slot s from row r (zeros where r lies outside [0, C)): p,
  // and with `all` the flag word, the velocity as three planes, V / md
  // and a streamed gradient.
  auto stage = [&](int s, int r, bool all) {
    const bool in = r >= 0 && r < rows;
    ps[s] = in ? p[r] : T(0);
    if (!all) return;
    const T* v = vel + 3 * static_cast<long long>(r);
    fs[s] = in ? flags[r] : 0;
    us[s] = in ? v[0] : T(0);
    vs[s] = in ? v[1] : T(0);
    ws[s] = in ? v[2] : T(0);
    if (kRC) voas[s] = vol / (in ? md[r] : T(1));  // V / a, once a cell
    if (kGrad && !kGG) {
      const T* g = grad_p + 3 * static_cast<long long>(r);
#pragma unroll
      for (int a = 0; a < 3; ++a) gs[a * S + s] = in ? g[a] : T(0);
    }
  };
  // 1. Each thread stages its own cell, then the halo's slots in turn.
  const int tx = threadIdx.x & (box.bx - 1);
  const int ty = (threadIdx.x >> box.lg_bx) & (box.by - 1);
  const int tz = threadIdx.x >> (box.lg_bx + box.lg_by);
  const int s =
      (tx + box.hx) + box.sx * ((ty + box.hy) + box.sy * (tz + box.hz));
  const int i32 = (x0 + box.hx + tx) + nx * (y0 + box.hy + ty) +
                  nxy * (z0 + box.hz + tz) - box.r0;
  stage(s, i32, true);
  const int nh = box.nh_x + box.nh_y + box.nh_z;
  for (int q = threadIdx.x; q < nh; q += blockDim.x) {
    int x, y, z, d, a;
    halo_slot(box, q, x, y, z, d, a);
    stage(x + box.sx * (y + box.sy * z),
          (x0 + x) + nx * (y0 + y) + nxy * (z0 + z) - box.r0, d == 1);
  }
  __syncthreads();
  const bool mine = x0 + box.hx + tx < box.nx && y0 + box.hy + ty < box.ny &&
                    z0 + box.hz + tz < box.nz && i32 >= 0 && i32 < rows;
  const int fl = fs[s];
  const T p_c = ps[s];
  // 2. The in-kernel gradient, once per cell: the tile's cells (those
  // past the box too, as a flag crossing the box's side would read
  // them), then their face neighbours.
  T g_own[3] = {T(0), T(0), T(0)};
  if (kGG) {
    tile_gg_own(cols, box, ps, bc, gs, S, s, fl, p_c, g_own);
    tile_gg_halo(cols, box, ps, fs, bc, gs, S);
    __syncthreads();
  }
  // 3. Each thread assembles its cell from the stage.
  if (!mine) return;
  const long long i = i32;
  const bool active = (fl >> ACTIVE_BIT) & 1;
  const T u_c = us[s], v_c = vs[s], w_c = ws[s];
  const T voa_c = kRC ? voas[s] : T(0);
  T diag = T(0), bu = T(0), bv = T(0), bw = T(0);
#pragma unroll
  for (int k = 0; k < kAsmK; ++k) {
    if (k >= cols.K) continue;
    const bool interior = (fl >> k) & 1;
    const int sj = interior ? s + box.ds[k] : s;
    const long long j = interior ? i + cols.offset[k] : i;
    T u_n = u_c, v_n = v_c, w_n = w_c, p_n = p_c;
    if (interior) {
      u_n = us[sj];
      v_n = vs[sj];
      w_n = ws[sj];
      p_n = ps[sj];
    }
    const T* n = cols.n[k];
    const T area = cols.area[k];
    const int ax = cols.axis[k];
    T gp_c = T(0), gp_n = T(0);
    if (kGrad && ax >= 0) {
      gp_c = kGG ? pick3(ax, g_own[0], g_own[1], g_own[2]) : gs[ax * S + s];
      gp_n = interior ? gs[ax * S + sj] : gp_c;
    }
    // --- face mass flow F ---
    T vn_int = T(0.5) * dot_n(u_c + u_n, v_c + v_n, w_c + w_n, n);
    if (kRC && ax >= 0) {
      const T term1 = dot_n(u_c + u_n, v_c + v_n, w_c + w_n, n);
      const T voa_n = interior ? voas[sj] : voa_c;
      const T term2 = (voa_c + voa_n) * (p_c - p_n) * cols.inv_on[k];
      const T term3 = (voa_c * gp_c + voa_n * gp_n) * cols.na[k];
      vn_int = T(0.5) * (term1 + term2 + term3);
    }
    const T vn_bnd = boundary_flux(cols, k, bc, u_c, v_c, w_c);
    const T F = (interior ? vn_int : vn_bnd) * mc.arho[k];
    // --- advection + diffusion coefficients ---
    const T a_nb = kScheme == kCD1 ? F * T(0.5) : (F < T(0) ? F : T(0));
    const T d_int = mc.d_int[k];
    const T d_bnd = mc.d_bnd[k];
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
  bu = bu + mc.relax * diag * u_c;
  bv = bv + mc.relax * diag * v_c;
  bw = bw + mc.relax * diag * w_c;
  diag = diag / alpha;
  diag_out[i] = active ? diag : T(1);
  b_out[i] = active ? bu : T(0);
  b_out[C + i] = active ? bv : T(0);
  b_out[2 * C + i] = active ? bw : T(0);
}

// pc_kernel: the Linear and the streamed-gradient Rhie-Chow instances,
// one thread per cell (grid-stride), neighbour values read from L1/L2.
template <typename T, bool kRC>
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
        const T gp_c = grad_p[3 * i + ax];
        const T gp_n = interior ? grad_p[3 * j + ax] : gp_c;
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

// Shared memory of a pc_gg_kernel tile: p, u, v, w, md, V / md and
// three gradient planes of T, then the int32 flag words.
template <typename T>
inline long long pc_smem_bytes(const BoxTile& t) {
  const long long S = static_cast<long long>(t.sx) * t.sy * t.sz;
  return S * (static_cast<long long>(sizeof(T)) * 9 + 4);
}

// The per-column products of Python numbers pc_kernel forms in every
// thread, formed once by pc_gg_kernel's launcher with the same rounded
// operations: A rho and (rho A) A.
template <typename T>
struct PcConsts {
  T arho[kAsmK];
  T raa[kAsmK];
};

template <typename T>
PcConsts<T> make_pc_consts(const AsmCols<T>& c, T rho) {
  PcConsts<T> m{};
  for (int k = 0; k < c.K; ++k) {
    m.arho[k] = c.area[k] * rho;
    m.raa[k] = rho * c.area[k] * c.area[k];
  }
  return m;
}

// pc_gg_kernel: the Rhie-Chow instance with the in-kernel gradient, on
// momentum_kernel's tiles and steps (a halo of two cells).
template <typename T>
__global__ void pc_gg_kernel(AsmCols<T> cols, BoxTile box, PcConsts<T> pcc,
                             const T* __restrict__ vel,
                             const T* __restrict__ md,
                             const T* __restrict__ p,
                             const T* __restrict__ bc,
                             const int* __restrict__ flags, T vol,
                             T* __restrict__ diag_out,
                             T* __restrict__ off_out, T* __restrict__ b_out,
                             long long C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = box.sx * box.sy * box.sz;
  T* ps = reinterpret_cast<T*>(smem);
  T* us = ps + S;
  T* vs = us + S;
  T* ws = vs + S;
  T* mds = ws + S;
  T* voas = mds + S;
  T* gs = voas + S;
  int* fs = reinterpret_cast<int*>(gs + 3 * S);
  // Rows in 32 bits: the launcher checks that every staged row fits.
  const int nx = box.nx, nxy = box.nx * box.ny, rows = static_cast<int>(C);
  const int x0 = static_cast<int>(blockIdx.x) * box.bx - box.hx;
  const int y0 = static_cast<int>(blockIdx.y) * box.by - box.hy;
  const int z0 = static_cast<int>(blockIdx.z) * box.bz - box.hz;
  // Stages slot s from row r (zeros where r lies outside [0, C)): p,
  // and with `all` the flag word, the velocity as three planes, md and
  // V / md.
  auto stage = [&](int s, int r, bool all) {
    const bool in = r >= 0 && r < rows;
    ps[s] = in ? p[r] : T(0);
    if (!all) return;
    const T* v = vel + 3 * static_cast<long long>(r);
    fs[s] = in ? flags[r] : 0;
    us[s] = in ? v[0] : T(0);
    vs[s] = in ? v[1] : T(0);
    ws[s] = in ? v[2] : T(0);
    const T m = in ? md[r] : T(1);
    mds[s] = m;
    voas[s] = vol / m;  // V / a, once a cell
  };
  // 1. Each thread stages its own cell, then the halo's slots in turn.
  const int tx = threadIdx.x & (box.bx - 1);
  const int ty = (threadIdx.x >> box.lg_bx) & (box.by - 1);
  const int tz = threadIdx.x >> (box.lg_bx + box.lg_by);
  const int s =
      (tx + box.hx) + box.sx * ((ty + box.hy) + box.sy * (tz + box.hz));
  const int i32 = (x0 + box.hx + tx) + nx * (y0 + box.hy + ty) +
                  nxy * (z0 + box.hz + tz) - box.r0;
  stage(s, i32, true);
  const int nh = box.nh_x + box.nh_y + box.nh_z;
  for (int q = threadIdx.x; q < nh; q += blockDim.x) {
    int x, y, z, d, a;
    halo_slot(box, q, x, y, z, d, a);
    stage(x + box.sx * (y + box.sy * z),
          (x0 + x) + nx * (y0 + y) + nxy * (z0 + z) - box.r0, d == 1);
  }
  __syncthreads();
  const bool mine = x0 + box.hx + tx < box.nx && y0 + box.hy + ty < box.ny &&
                    z0 + box.hz + tz < box.nz && i32 >= 0 && i32 < rows;
  const int fl = fs[s];
  const T p_c = ps[s];
  // 2. The gradient, once per cell (as momentum_kernel).
  T g_own[3];
  tile_gg_own(cols, box, ps, bc, gs, S, s, fl, p_c, g_own);
  tile_gg_halo(cols, box, ps, fs, bc, gs, S);
  __syncthreads();
  // 3. Each thread assembles its cell from the stage.
  if (!mine) return;
  const long long i = i32;
  const bool active = (fl >> ACTIVE_BIT) & 1;
  const T u_c = us[s], v_c = vs[s], w_c = ws[s];
  const T md_c = mds[s];
  const T voa_c = voas[s];
  T diag = T(0), b = T(0);
#pragma unroll
  for (int k = 0; k < kAsmK; ++k) {
    if (k >= cols.K) continue;
    const bool interior = (fl >> k) & 1;
    // The neighbour's slot: the own one on a boundary face, so every
    // neighbour value read from it is the own cell's there.
    const int sj = interior ? s + box.ds[k] : s;
    const T u_n = us[sj], v_n = vs[sj], w_n = ws[sj], md_n = mds[sj];
    const int ax = cols.axis[k];
    T vn_int = T(0.5) * dot_n(u_c + u_n, v_c + v_n, w_c + w_n, cols.n[k]);
    if (ax >= 0) {
      // Rhie-Chow (ck_flux) with the iteration-start p and grad p.
      const T p_n = ps[sj];
      const T gp_c = pick3(ax, g_own[0], g_own[1], g_own[2]);
      const T gp_n = gs[ax * S + sj];
      const T term1 = dot_n(u_c + u_n, v_c + v_n, w_c + w_n, cols.n[k]);
      const T voa_n = voas[sj];
      const T term2 = (voa_c + voa_n) * (p_c - p_n) * cols.inv_on[k];
      const T term3 = (voa_c * gp_c + voa_n * gp_n) * cols.na[k];
      vn_int = T(0.5) * (term1 + term2 + term3);
    }
    const T vn_bnd = boundary_flux(cols, k, bc, u_c, v_c, w_c);
    const T F2 = (interior ? vn_int : vn_bnd) * pcc.arho[k];
    b = b - F2;
    // Shared momentum diagonal: |md n| == md for unit normals.
    if (interior) {
      const T a_face = T(0.5) * (md_c + md_n);
      const T a_nb = pcc.raa[k] / a_face;
      off_out[k * C + i] = active ? -a_nb : T(0);
      diag = diag + a_nb;
    } else {
      off_out[k * C + i] = T(0);
      diag = diag + pcc.raa[k] / md_c * T(0.5);
    }
  }
  diag_out[i] = active ? diag : T(1);
  b_out[i] = active ? b : T(0);
}

template <typename T>
using MomentumKernel = void (*)(AsmCols<T>, BoxTile, MomentumConsts<T>,
                                const T*, const T*, const T*, const T*,
                                const T*, const T*, const T*, const T*,
                                const int*, T, T, T*, T*, T*, long long);

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
                    const AsmCols<T>& c, int nx, int ny, int nz, int row0,
                    const void* vel, const void* p, const void* grad_p,
                    const void* md, const void* grad_vel, const void* rv_dt,
                    const void* vel_n, const void* bc, const int* flags,
                    double rho, double mu, double alpha, double vol,
                    void* diag, void* off, void* b, long long C,
                    cudaStream_t stream) {
  const MomentumKernel<T> kernel =
      momentum_select<T>(scheme, psi, rc, p_so, gg);
  BoxTile t;
  dim3 grid;
  if (!make_box_tile(c, nx, ny, nz, gg ? 2 : 1, &t) || !box_grid(t, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  t.r0 = row0;
  // 3-D float64 tiles with the in-kernel gradient take over 48 KB.
  const long long smem = momentum_smem_bytes<T>(t, rc, rc || p_so);
  if (const int e = fit_smem(kernel, smem)) return e;
  kernel<<<grid, static_cast<unsigned>(t.bx * t.by * t.bz),
           static_cast<size_t>(smem), stream>>>(
      c, t,
      make_momentum_consts<T>(c, static_cast<T>(rho), static_cast<T>(mu),
                              static_cast<T>(alpha)),
      static_cast<const T*>(vel), static_cast<const T*>(p),
      static_cast<const T*>(grad_p), static_cast<const T*>(md),
      static_cast<const T*>(grad_vel), static_cast<const T*>(rv_dt),
      static_cast<const T*>(vel_n), static_cast<const T*>(bc), flags,
      static_cast<T>(alpha), static_cast<T>(vol), static_cast<T*>(diag),
      static_cast<T*>(off), static_cast<T*>(b), C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pc(bool rc, bool gg, const AsmCols<T>& c, int nx, int ny, int nz,
              int row0, const void* vel, const void* md, const void* p,
              const void* grad_p, const void* bc, const int* flags,
              double rho, double vol, void* diag, void* off, void* b,
              long long C, cudaStream_t stream) {
  if (!(rc && gg)) {
    void (*kernel)(AsmCols<T>, const T*, const T*, const T*, const T*,
                   const T*, const int*, T, T, T*, T*, T*, long long) =
        rc ? pc_kernel<T, true> : pc_kernel<T, false>;
    kernel<<<grid_blocks(C), kThreads, 0, stream>>>(
        c, static_cast<const T*>(vel), static_cast<const T*>(md),
        static_cast<const T*>(p), static_cast<const T*>(grad_p),
        static_cast<const T*>(bc), flags, static_cast<T>(rho),
        static_cast<T>(vol), static_cast<T*>(diag), static_cast<T*>(off),
        static_cast<T*>(b), C);
    return static_cast<int>(cudaGetLastError());
  }
  BoxTile t;
  dim3 grid;
  // Whole tiles on a small box too: smaller ones stage more of the halo
  // of two a cell (the 128 x 64 couette ran 0.0081 ms against 0.0077 on
  // an NVIDIA H100 80GB HBM3 at 700 W).
  if (!make_box_tile(c, nx, ny, nz, 2, &t, kThreads, kThreads) ||
      !box_grid(t, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  t.r0 = row0;
  // 3-D tiles take over 48 KB.
  const long long smem = pc_smem_bytes<T>(t);
  if (const int e = fit_smem(pc_gg_kernel<T>, smem)) return e;
  pc_gg_kernel<T><<<grid, static_cast<unsigned>(t.bx * t.by * t.bz),
                    static_cast<size_t>(smem), stream>>>(
      c, t, make_pc_consts<T>(c, static_cast<T>(rho)),
      static_cast<const T*>(vel), static_cast<const T*>(md),
      static_cast<const T*>(p), static_cast<const T*>(bc), flags,
      static_cast<T>(vol), static_cast<T*>(diag), static_cast<T*>(off),
      static_cast<T*>(b), C);
  return static_cast<int>(cudaGetLastError());
}

// The float64 instances compile in parity_assembly_f64.cu, beside this
// translation unit, so nvcc builds the two halves in parallel.
extern template int launch_momentum<double>(
    int, int, bool, bool, bool, const AsmCols<double>&, int, int, int, int,
    const void*, const void*, const void*, const void*, const void*,
    const void*, const void*, const void*, const int*, double, double,
    double, double, void*, void*, void*, long long, cudaStream_t);
extern template int launch_pc<double>(bool, bool, const AsmCols<double>&,
                                      int, int, int, int, const void*,
                                      const void*, const void*, const void*,
                                      const void*, const int*, double, double,
                                      void*, void*, void*, long long,
                                      cudaStream_t);

}  // namespace orc
