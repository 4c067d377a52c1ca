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
// TVD_DC the [C,3,3] velocity gradient. Each scheme, limiter and
// face-pressure choice is its own template instance, so the branches a
// configuration does not take cost neither registers nor loads.
//
// fc_pc_kernel. Its first design was a grid-stride loop of 256-thread
// CTAs (32 CTAs on a 128 x 64 box), each thread reading its K
// neighbours' velocity, md and grad p from L2 (a cell's about three
// times), dividing V/md twice in each face and forming every per-column
// constant itself (1024^2 f32 Rhie-Chow: 0.0510 ms against a 0.0275 ms
// bound on an NVIDIA H100 80GB HBM3 at 700 W). Now it takes
// fc_momentum_kernel's tiles: it stages the velocity (three planes), V/md
// (one IEEE division a slot, the same value the first design formed in
// each face) and, under Rhie-Chow, the grad p component on each axis a
// column uses (a halo slot's on its face's axis only); it reads its own
// flag word while the stage fills, takes 0.5 rho A / d_on, rho A / d_fo
// and A rho from the host (FcPcConsts), and writes the K off and K
// flux_h planes coalesced. It is bound by device memory, two thirds of
// its bytes the 2K + 2 output planes; it moves them at about 62% of
// 3.35 TB/s (0.0444 ms), within 2.5% whatever the tile (128, 256 or 512
// cells) and within 1.3% with streaming stores (__stcs).
//
// fc_momentum_kernel. Its first design was fc_pc_kernel's, with each
// face's two velocity gradients read at a 36-byte stride by up to K + 1
// threads a cell and every per-column constant formed in every thread
// (TVD_DC+UMIST+RC at 1024^2 f32: 0.1085 ms against a 0.0376 ms bound
// on an NVIDIA H100 80GB HBM3 at 700 W). Now it takes the parity
// momentum kernel's box tiles (BoxTile, a halo of one cell) and:
//  1. stages p, the velocity (transposed into three planes) and, under
//     kPSo, the streamed grad p over the tile and its face neighbours in
//     shared memory; under TVD_DC the velocity gradient on each axis a
//     column uses, the tile's cells read as contiguous [9] rows by
//     consecutive threads, a halo slot's three components on its face's
//     axis only (fc_momentum_smem_bytes);
//  2. reads its own flag word and the K flux planes while the stage
//     fills, and the inertia pair later, straight from device memory,
//     coalesced: no neighbour's is needed;
//  3. assembles each cell from the stage with mu A / dist, A rho and
//     (1 - alpha) / alpha formed once on the host (MomentumConsts).
// The gradient planes are indexed by slot like the others, so a face
// finds its neighbour's components with the slot step it uses for p. The
// TVD_DC instances are limited by instruction throughput, not by
// bytes (1,944 SASS instructions in float32 against UD's 912: the
// limiter and an IEEE division per face and component, which bitwise
// equality with the first design keeps): a compact halo layout (three
// components a halo slot, tile cells apart) cost ~48 instructions of
// index arithmetic a face and ran 12% slower, and a persistent CTA
// copying the next tile with cp.async while it assembled the current
// one doubled the registers (45 to 86) and ran 11% slower.
// Each per-face expression is the first design's, so nvcc contracts it
// the same way and the results are unchanged bit for bit.

// The CTA size of both SIMPLE_FC kernels on a 2-D box: 128-cell tiles
// ran fc_momentum_kernel's TVD_DC instance 4% faster than 256-cell ones
// (finer CTAs overlap one tile's loads with another's arithmetic better)
// and its UD instance as fast; fc_pc_kernel ran 1% and 2.5% faster than
// on 256- and 512-cell tiles. A 3-D box keeps 256-cell tiles, whose halo
// is smaller.
constexpr int kFcThreads2D = 128;

// Shared memory of an FC momentum tile (halo 1): p, u, v, w and, under
// kPSo, three gradient planes over the stage, and under TVD_DC three
// velocity-gradient planes for each axis a column uses.
template <typename T>
inline long long fc_momentum_smem_bytes(const BoxTile& t, int axes,
                                        bool p_so, bool tvd) {
  const long long S = static_cast<long long>(t.sx) * t.sy * t.sz;
  const int used = (axes & 1) + ((axes >> 1) & 1) + ((axes >> 2) & 1);
  return static_cast<long long>(sizeof(T)) * S *
         (4 + 3 * p_so + (tvd ? 3 * used : 0));
}

template <typename T, int kScheme, int kPsi, bool kPSo>
__global__ void fc_momentum_kernel(
    AsmCols<T> cols, BoxTile box, MomentumConsts<T> mc,
    const T* __restrict__ vel, const T* __restrict__ p,
    const T* __restrict__ flux, const T* __restrict__ grad_p,
    const T* __restrict__ grad_vel, const T* __restrict__ rv_dt,
    const T* __restrict__ vel_n, const T* __restrict__ bc,
    const int* __restrict__ flags, T alpha, T* __restrict__ diag_out,
    T* __restrict__ off_out, T* __restrict__ b_out, long long C) {
  constexpr bool kTvd = kScheme == kTvdDc;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = box.sx * box.sy * box.sz;
  T* ps = reinterpret_cast<T*>(smem);
  T* us = ps + S;
  T* vs = us + S;
  T* ws = vs + S;
  T* gs = ws + S;
  // TVD_DC: gvs[(u * 3 + q) * S + s] holds component (q, a) of the
  // velocity gradient of slot s for the u-th axis a a column uses: every
  // such component of a tile slot, those on its face's axis of a halo
  // slot (the only ones a face reads there).
  T* gvs = gs + (kPSo ? 3 * S : 0);
  // Rows in 32 bits: the launcher checks that every staged row fits.
  const int nx = box.nx, nxy = box.nx * box.ny, rows = static_cast<int>(C);
  const int x0 = static_cast<int>(blockIdx.x) * box.bx - box.hx;
  const int y0 = static_cast<int>(blockIdx.y) * box.by - box.hy;
  const int z0 = static_cast<int>(blockIdx.z) * box.bz - box.hz;
  // Stages slot s from row r (zeros where r lies outside [0, C)).
  auto stage = [&](int s, int r) {
    const bool in = r >= 0 && r < rows;
    const T* v = vel + 3 * static_cast<long long>(r);
    ps[s] = in ? p[r] : T(0);
    us[s] = in ? v[0] : T(0);
    vs[s] = in ? v[1] : T(0);
    ws[s] = in ? v[2] : T(0);
    if (kPSo) {
      const T* g = grad_p + 3 * static_cast<long long>(r);
#pragma unroll
      for (int a = 0; a < 3; ++a) gs[a * S + s] = in ? g[a] : T(0);
    }
  };
  // 1. Each thread stages its own cell, then the halo's slots in turn.
  const int t = threadIdx.x;
  const int tx = t & (box.bx - 1);
  const int ty = (t >> box.lg_bx) & (box.by - 1);
  const int tz = t >> (box.lg_bx + box.lg_by);
  const int s =
      (tx + box.hx) + box.sx * ((ty + box.hy) + box.sy * (tz + box.hz));
  const int i32 = (x0 + box.hx + tx) + nx * (y0 + box.hy + ty) +
                  nxy * (z0 + box.hz + tz) - box.r0;
  stage(s, i32);
  const int nh = box.nh_x + box.nh_y + box.nh_z;
  for (int h = t; h < nh; h += blockDim.x) {
    int x, y, z, d, a;
    halo_slot(box, h, x, y, z, d, a);
    const int r = (x0 + x) + nx * (y0 + y) + nxy * (z0 + z) - box.r0;
    const int sh = x + box.sx * (y + box.sy * z);
    stage(sh, r);
    if (kTvd && ((cols.axes >> a) & 1)) {
      const bool in = r >= 0 && r < rows;
      const T* g = grad_vel + 9 * static_cast<long long>(r) + a;
      T* gv = gvs + 3 * __popc(cols.axes & ((1 << a) - 1)) * S + sh;
#pragma unroll
      for (int q = 0; q < 3; ++q) gv[q * S] = in ? g[3 * q] : T(0);
    }
  }
  if (kTvd) {
    // The tile's [9] rows, x-runs of them contiguous in device memory.
    const int cells = blockDim.x;
    for (int e = t; e < 9 * cells; e += blockDim.x) {
      const int c = e / 9, comp = e - 9 * c;
      const int q = comp / 3, a = comp - 3 * q;
      if (!((cols.axes >> a) & 1)) continue;
      const int cx = c & (box.bx - 1);
      const int cy = (c >> box.lg_bx) & (box.by - 1);
      const int cz = c >> (box.lg_bx + box.lg_by);
      const int r = (x0 + box.hx + cx) + nx * (y0 + box.hy + cy) +
                    nxy * (z0 + box.hz + cz) - box.r0;
      const int sc = (cx + box.hx) +
                     box.sx * ((cy + box.hy) + box.sy * (cz + box.hz));
      gvs[(__popc(cols.axes & ((1 << a) - 1)) * 3 + q) * S + sc] =
          r >= 0 && r < rows ? grad_vel[9 * static_cast<long long>(r) + comp]
                             : T(0);
    }
  }
  // 2. Its own flag word and flux planes, read while the stage fills
  // (row 0 by the threads past the box).
  const bool mine = x0 + box.hx + tx < box.nx && y0 + box.hy + ty < box.ny &&
                    z0 + box.hz + tz < box.nz && i32 >= 0 && i32 < rows;
  const long long i = mine ? i32 : 0;
  const int fl = flags[i];
  T flux_k[kAsmK];
#pragma unroll
  for (int k = 0; k < kAsmK; ++k) {
    flux_k[k] = k < cols.K ? flux[k * C + i] : T(0);
  }
  __syncthreads();
  if (!mine) return;
  // 3. Each thread assembles its cell.
  const bool active = (fl >> ACTIVE_BIT) & 1;
  const T u_c = us[s], v_c = vs[s], w_c = ws[s];
  const T p_c = ps[s];
  T diag = T(0), bu = T(0), bv = T(0), bw = T(0);
#pragma unroll
  for (int k = 0; k < kAsmK; ++k) {
    if (k >= cols.K) continue;
    const bool interior = (fl >> k) & 1;
    // The neighbour's slot: the own one on a boundary face, so every
    // neighbour value read from it is the own cell's there.
    const int sj = interior ? s + box.ds[k] : s;
    const T p_n = ps[sj];
    const T* n = cols.n[k];
    const T area = cols.area[k];
    const int ax = cols.axis[k];
    // --- face mass flow: the stored conservative flux ---
    const T F = flux_k[k] * mc.arho[k];
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
      const T s_w = interior ? T(0) : (a_nb - F) + d_bnd;
      const T* row = bc + 4 * cols.zone[k];
      bu = bu + s_w * row[0];
      bv = bv + s_w * row[1];
      bw = bw + s_w * row[2];
    }
    // --- TVD deferred correction (ck_momentum TVD_DC) ---
    if (kTvd && ax >= 0) {
      const bool up_c = F > T(0);
      const T e_on = cols.e_on[k];
      const T x_c[3] = {u_c, v_c, w_c};
      const T x_n[3] = {us[sj], vs[sj], ws[sj]};
      const T* gv = gvs + 3 * __popc(cols.axes & ((1 << ax) - 1)) * S;
      T acc[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const T gv_c = gv[q * S + s];
        const T gv_n = gv[q * S + sj];
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
      const T gp_c = gs[ax * S + s];
      const T gp_n = gs[ax * S + sj];
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

// The per-column products of Python numbers fc_pc_kernel's first design
// formed in every thread, formed once by the launcher in its operation
// order: 0.5 rho A / dist_on and rho A / dist_fo (d_int and d_bnd over
// V/md) and A rho.
template <typename T>
struct FcPcConsts {
  T d_int[kAsmK];
  T d_bnd[kAsmK];
  T arho[kAsmK];
};

template <typename T>
FcPcConsts<T> make_fc_pc_consts(const AsmCols<T>& c, T rho) {
  FcPcConsts<T> m{};
  for (int k = 0; k < c.K; ++k) {
    m.d_int[k] = T(0.5) * rho * c.area[k] / c.dist_on[k];
    m.d_bnd[k] = rho * c.area[k] / c.dist_fo[k];
    m.arho[k] = c.area[k] * rho;
  }
  return m;
}

// Shared memory of a SIMPLE_FC pressure tile (halo 1): u, v, w and V/md
// over the stage and, under Rhie-Chow, the grad p component on each axis
// a column uses.
template <typename T>
inline long long fc_pc_smem_bytes(const BoxTile& t, int axes, bool rc) {
  const long long S = static_cast<long long>(t.sx) * t.sy * t.sz;
  const int used = (axes & 1) + ((axes >> 1) & 1) + ((axes >> 2) & 1);
  return static_cast<long long>(sizeof(T)) * S * (4 + (rc ? used : 0));
}

template <typename T, bool kRC>
__global__ void fc_pc_kernel(AsmCols<T> cols, BoxTile box, FcPcConsts<T> pc,
                             const T* __restrict__ vel,
                             const T* __restrict__ md,
                             const T* __restrict__ grad_p,
                             const T* __restrict__ bc,
                             const int* __restrict__ flags, T vol,
                             T* __restrict__ diag_out,
                             T* __restrict__ off_out, T* __restrict__ b_out,
                             T* __restrict__ fh_out, long long C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = box.sx * box.sy * box.sz;
  T* us = reinterpret_cast<T*>(smem);
  T* vs = us + S;
  T* ws = vs + S;
  // vos[s] = V/md of slot s: the one IEEE division a cell, where the
  // first design divided twice in each of its faces.
  T* vos = ws + S;
  // kRC: gs[u * S + s] holds the grad p component on the u-th axis a a
  // column uses: every such component of a tile slot, the one on its
  // face's axis of a halo slot (the only one a face reads there).
  T* gs = vos + S;
  // Rows in 32 bits: the launcher checks that every staged row fits.
  const int nx = box.nx, nxy = box.nx * box.ny, rows = static_cast<int>(C);
  const int x0 = static_cast<int>(blockIdx.x) * box.bx - box.hx;
  const int y0 = static_cast<int>(blockIdx.y) * box.by - box.hy;
  const int z0 = static_cast<int>(blockIdx.z) * box.bz - box.hz;
  // Stages slot s from row r (zeros where r lies outside [0, C)).
  auto stage = [&](int s, int r) {
    const bool in = r >= 0 && r < rows;
    const T* v = vel + 3 * static_cast<long long>(r);
    us[s] = in ? v[0] : T(0);
    vs[s] = in ? v[1] : T(0);
    ws[s] = in ? v[2] : T(0);
    vos[s] = in ? vol / md[r] : T(0);
  };
  // 1. Each thread stages its own cell, then the halo's slots in turn.
  const int t = threadIdx.x;
  const int tx = t & (box.bx - 1);
  const int ty = (t >> box.lg_bx) & (box.by - 1);
  const int tz = t >> (box.lg_bx + box.lg_by);
  const int s =
      (tx + box.hx) + box.sx * ((ty + box.hy) + box.sy * (tz + box.hz));
  const int i32 = (x0 + box.hx + tx) + nx * (y0 + box.hy + ty) +
                  nxy * (z0 + box.hz + tz) - box.r0;
  stage(s, i32);
  if (kRC) {
    const bool in = i32 >= 0 && i32 < rows;
    const T* g = grad_p + 3 * static_cast<long long>(i32);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if ((cols.axes >> a) & 1) {
        gs[__popc(cols.axes & ((1 << a) - 1)) * S + s] = in ? g[a] : T(0);
      }
    }
  }
  const int nh = box.nh_x + box.nh_y + box.nh_z;
  for (int h = t; h < nh; h += blockDim.x) {
    int x, y, z, d, a;
    halo_slot(box, h, x, y, z, d, a);
    const int r = (x0 + x) + nx * (y0 + y) + nxy * (z0 + z) - box.r0;
    const int sh = x + box.sx * (y + box.sy * z);
    stage(sh, r);
    if (kRC && ((cols.axes >> a) & 1)) {
      const bool in = r >= 0 && r < rows;
      gs[__popc(cols.axes & ((1 << a) - 1)) * S + sh] =
          in ? grad_p[3 * static_cast<long long>(r) + a] : T(0);
    }
  }
  // 2. Its own flag word, read while the stage fills (row 0 by the
  // threads past the box).
  const bool mine = x0 + box.hx + tx < box.nx && y0 + box.hy + ty < box.ny &&
                    z0 + box.hz + tz < box.nz && i32 >= 0 && i32 < rows;
  const long long i = mine ? i32 : 0;
  const int fl = flags[i];
  __syncthreads();
  if (!mine) return;
  // 3. Each thread assembles its cell, writing the K off and K flux_h
  // planes coalesced.
  const bool active = (fl >> ACTIVE_BIT) & 1;
  const T u_c = us[s], v_c = vs[s], w_c = ws[s];
  const T voa_c = vos[s];
  T diag = T(0), b = T(0);
#pragma unroll
  for (int k = 0; k < kAsmK; ++k) {
    if (k >= cols.K) continue;
    const bool interior = (fl >> k) & 1;
    // The neighbour's slot: the own one on a boundary face, so every
    // neighbour value read from it is the own cell's there.
    const int sj = interior ? s + box.ds[k] : s;
    const T u_n = us[sj], v_n = vs[sj], w_n = ws[sj];
    const T voa_n = vos[sj];
    const int ax = cols.axis[k];
    // Flux predictor: no compact pressure term (the equation re-adds
    // it with the new p); term3 only under Rhie-Chow.
    const T term1 = dot_n(u_c + u_n, v_c + v_n, w_c + w_n, cols.n[k]);
    T vn_int = T(0.5) * term1;
    if (kRC && ax >= 0) {
      const T* g = gs + __popc(cols.axes & ((1 << ax) - 1)) * S;
      const T gp_c = g[s];
      const T gp_n = g[sj];
      const T term3 = (voa_c * gp_c + voa_n * gp_n) * cols.na[k];
      vn_int = T(0.5) * (term1 + term3);
    }
    const T vn_bnd = boundary_flux(cols, k, bc, u_c, v_c, w_c);
    const T fh = interior ? vn_int : vn_bnd;
    fh_out[k * C + i] = active ? fh : T(0);
    b = b - fh * pc.arho[k];
    // d coefficients: |md n| == md for unit normals, V/a == vol/md.
    const T d_int = pc.d_int[k] * (voa_c + voa_n);
    off_out[k * C + i] = (active && interior) ? -d_int : T(0);
    if (cols.kind[k] == kPressure) {
      const T d_bnd = pc.d_bnd[k] * voa_c;
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

template <typename T>
using FcMomentumKernel = void (*)(AsmCols<T>, BoxTile, MomentumConsts<T>,
                                  const T*, const T*, const T*, const T*,
                                  const T*, const T*, const T*, const T*,
                                  const int*, T, T*, T*, T*, long long);

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
                       int nx, int ny, int nz, int row0, const void* vel,
                       const void* p, const void* flux, const void* grad_p,
                       const void* grad_vel, const void* rv_dt,
                       const void* vel_n, const void* bc, const int* flags,
                       double rho, double mu, double alpha, void* diag,
                       void* off, void* b, long long C, cudaStream_t stream) {
  const FcMomentumKernel<T> kernel = fc_momentum_select<T>(scheme, psi, p_so);
  BoxTile t;
  dim3 grid;
  const int threads = nz > 1 ? kThreads : kFcThreads2D;
  if (!make_box_tile(c, nx, ny, nz, 1, &t, threads) || !box_grid(t, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  t.r0 = row0;
  // 3-D float64 tiles under TVD_DC take over 48 KB.
  const long long smem =
      fc_momentum_smem_bytes<T>(t, c.axes, p_so, scheme == kTvdDc);
  if (const int e = fit_smem(kernel, smem)) return e;
  kernel<<<grid, static_cast<unsigned>(t.bx * t.by * t.bz),
           static_cast<size_t>(smem), stream>>>(
      c, t,
      make_momentum_consts<T>(c, static_cast<T>(rho), static_cast<T>(mu),
                              static_cast<T>(alpha)),
      static_cast<const T*>(vel), static_cast<const T*>(p),
      static_cast<const T*>(flux), static_cast<const T*>(grad_p),
      static_cast<const T*>(grad_vel), static_cast<const T*>(rv_dt),
      static_cast<const T*>(vel_n), static_cast<const T*>(bc), flags,
      static_cast<T>(alpha), static_cast<T*>(diag), static_cast<T*>(off),
      static_cast<T*>(b), C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fc_pc(bool rc, const AsmCols<T>& c, int nx, int ny, int nz,
                 int row0, const void* vel, const void* md,
                 const void* grad_p, const void* bc, const int* flags,
                 double rho, double vol, void* diag, void* off, void* b,
                 void* flux_h, long long C, cudaStream_t stream) {
  void (*kernel)(AsmCols<T>, BoxTile, FcPcConsts<T>, const T*, const T*,
                 const T*, const T*, const int*, T, T*, T*, T*, T*,
                 long long) =
      rc ? fc_pc_kernel<T, true> : fc_pc_kernel<T, false>;
  BoxTile t;
  dim3 grid;
  const int threads = nz > 1 ? kThreads : kFcThreads2D;
  if (!make_box_tile(c, nx, ny, nz, 1, &t, threads) || !box_grid(t, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  t.r0 = row0;
  const long long smem = fc_pc_smem_bytes<T>(t, c.axes, rc);
  if (const int e = fit_smem(kernel, smem)) return e;
  kernel<<<grid, static_cast<unsigned>(t.bx * t.by * t.bz),
           static_cast<size_t>(smem), stream>>>(
      c, t, make_fc_pc_consts<T>(c, static_cast<T>(rho)),
      static_cast<const T*>(vel), static_cast<const T*>(md),
      static_cast<const T*>(grad_p), static_cast<const T*>(bc), flags,
      static_cast<T>(vol), static_cast<T*>(diag), static_cast<T*>(off),
      static_cast<T*>(b), static_cast<T*>(flux_h), C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace orc

extern "C" int orc_fc_momentum_assembly(
    int dtype, int scheme, int psi, int p_so, const long long* col_offsets,
    const double* col_geom, const int* col_kind, const int* col_zone, int K,
    long long nx, long long ny, long long nz, long long row0, const void* vel,
    const void* p, const void* flux, const void* grad_p, const void* grad_vel,
    const void* rv_dt, const void* vel_n, const void* bc, const void* flags,
    double rho, double mu, double alpha, void* diag, void* off, void* b,
    long long C, void* stream) {
  if (!orc::valid_box(nx, ny, nz, row0, C) ||
      !orc::valid_cols(col_kind, K) || scheme < orc::kUD ||
      scheme > orc::kTvdDc || psi < 0 || psi > 2 ||
      (p_so && grad_p == nullptr) ||
      (scheme == orc::kTvdDc && grad_vel == nullptr) ||
      ((rv_dt == nullptr) != (vel_n == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int* fl = static_cast<const int*>(flags);
  const int bx = static_cast<int>(nx), by = static_cast<int>(ny),
            bz = static_cast<int>(nz), r0 = static_cast<int>(row0);
  if (dtype == orc::kF32) {
    const auto c =
        orc::make_asm_cols<float>(col_offsets, col_geom, col_kind, col_zone, K);
    return orc::launch_fc_momentum<float>(
        scheme, psi, p_so != 0, c, bx, by, bz, r0, vel, p, flux, grad_p,
        grad_vel, rv_dt, vel_n, bc, fl, rho, mu, alpha, diag, off, b, C, s);
  }
  if (dtype == orc::kF64) {
    const auto c = orc::make_asm_cols<double>(col_offsets, col_geom,
                                              col_kind, col_zone, K);
    return orc::launch_fc_momentum<double>(
        scheme, psi, p_so != 0, c, bx, by, bz, r0, vel, p, flux, grad_p,
        grad_vel, rv_dt, vel_n, bc, fl, rho, mu, alpha, diag, off, b, C, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int orc_fc_pc_assembly(
    int dtype, int rc, const long long* col_offsets, const double* col_geom,
    const int* col_kind, const int* col_zone, int K, long long nx,
    long long ny, long long nz, long long row0, const void* vel,
    const void* md, const void* grad_p, const void* bc, const void* flags,
    double rho, double vol, void* diag, void* off, void* b, void* flux_h,
    long long C, void* stream) {
  if (!orc::valid_box(nx, ny, nz, row0, C) ||
      !orc::valid_cols(col_kind, K) || (rc && grad_p == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int* fl = static_cast<const int*>(flags);
  const int bx = static_cast<int>(nx), by = static_cast<int>(ny),
            bz = static_cast<int>(nz), r0 = static_cast<int>(row0);
  if (dtype == orc::kF32) {
    const auto c =
        orc::make_asm_cols<float>(col_offsets, col_geom, col_kind, col_zone, K);
    return orc::launch_fc_pc<float>(rc != 0, c, bx, by, bz, r0, vel, md,
                                    grad_p, bc, fl, rho, vol, diag, off, b,
                                    flux_h, C, s);
  }
  if (dtype == orc::kF64) {
    const auto c = orc::make_asm_cols<double>(col_offsets, col_geom,
                                              col_kind, col_zone, K);
    return orc::launch_fc_pc<double>(rc != 0, c, bx, by, bz, r0, vel, md,
                                     grad_p, bc, fl, rho, vol, diag, off, b,
                                     flux_h, C, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
