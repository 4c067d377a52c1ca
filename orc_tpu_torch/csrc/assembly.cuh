// Shared definitions of the fused assembly kernels (assembly.cu for
// SIMPLE_FC, parity_assembly.cuh for the parity SIMPLE loop): the static
// per-column constants of a uniform box, the face-flux and limiter
// helpers, the box tiles the kernels stage in shared memory and the
// per-column products formed on the host.
#pragma once

#include "common.cuh"

namespace orc {

// Flag bits 0..5 mark interior columns and bit 6 the active row, so an
// assembly takes at most kAsmK = 6 columns (a box's +-x, +-y, +-z); the
// kernels unroll their column loops to that bound.
constexpr int ACTIVE_BIT = 6;
constexpr int kAsmK = ACTIVE_BIT;
enum Kind { kWall = 0, kSymmetry = 1, kPressure = 2, kVinlet = 3 };
enum Scheme { kUD = 0, kCD1 = 1, kTvdDc = 2 };

template <typename T>
struct AsmCols {
  long long offset[MAX_K];
  T area[MAX_K];
  T n[MAX_K][3];
  T dist_fo[MAX_K];
  T dist_on[MAX_K];
  int kind[MAX_K];
  int zone[MAX_K];
  // Gradient terms, per column with a neighbour offset (axis -1
  // otherwise): the axis of the unit normal, its component na, and the
  // products the TPU kernels form from Python floats (in double, then
  // rounded to T): na * dist_on (grad . r_on), na * dist_fo (grad .
  // r_cf), na * (dist_fo - dist_on) (grad . r_nf) and 1 / dist_on.
  int axis[MAX_K];
  T na[MAX_K];
  T e_on[MAX_K];
  T e_c[MAX_K];
  T e_n[MAX_K];
  T inv_on[MAX_K];
  // Green-Gauss weights n[a] * area / vol of each column on axis a
  // (0 where the normal has no component a), and the bit mask of the
  // axes some neighbour column has.
  T gw[3][MAX_K];
  int axes;
  int K;
};

template <typename T>
AsmCols<T> make_asm_cols(const long long* offsets, const double* geom,
                         const int* kind, const int* zone, int K,
                         double vol = 0.0) {
  AsmCols<T> c{};
  c.K = K;
  c.axes = 0;
  for (int k = 0; k < K; ++k) {
    const double* g = geom + 6 * k;
    c.offset[k] = offsets[k];
    c.area[k] = static_cast<T>(g[0]);
    c.n[k][0] = static_cast<T>(g[1]);
    c.n[k][1] = static_cast<T>(g[2]);
    c.n[k][2] = static_cast<T>(g[3]);
    c.dist_fo[k] = static_cast<T>(g[4]);
    c.dist_on[k] = static_cast<T>(g[5]);
    c.kind[k] = kind[k];
    c.zone[k] = zone[k];
    for (int a = 0; a < 3; ++a) {
      c.gw[a][k] = static_cast<T>(vol != 0.0 ? g[1 + a] * g[0] / vol : 0.0);
    }
    int ax = -1;
    double na = 0.0;
    if (offsets[k] != 0) {  // the first axis of largest |n|, as _axis
      ax = 0;
      for (int a = 1; a < 3; ++a) {
        const double m = g[1 + a] < 0 ? -g[1 + a] : g[1 + a];
        const double best = g[1 + ax] < 0 ? -g[1 + ax] : g[1 + ax];
        if (m > best) ax = a;
      }
      na = g[1 + ax];
      c.axes |= 1 << ax;
    }
    c.axis[k] = ax;
    c.na[k] = static_cast<T>(na);
    c.e_on[k] = static_cast<T>(na * g[5]);
    c.e_c[k] = static_cast<T>(na * g[4]);
    c.e_n[k] = static_cast<T>(na * (g[4] - g[5]));
    c.inv_on[k] = static_cast<T>(1.0 / g[5]);
  }
  return c;
}

// (nx, ny, nz, row0): the box whose cell (x, y, z) is row
// x + nx (y + ny z) - row0, of the fewest planes that hold rows [0, C)
// from row0 on. On a mesh that is the box, row0 = 0 and C = nx ny nz; a
// slab partition's window (parallel/partition.py) starts row0 cells
// into its first plane and may end inside its last. The box's cells
// outside rows [0, C) are neither read nor written.
inline bool valid_box(long long nx, long long ny, long long nz,
                      long long row0, long long C) {
  const long long plane = nx * ny;
  return nx >= 1 && ny >= 1 && nz >= 1 && nx <= 2147483647LL &&
         ny <= 2147483647LL && nz <= 2147483647LL && row0 >= 0 &&
         row0 < plane && C >= 1 && nz == (row0 + C + plane - 1) / plane;
}

inline bool valid_cols(const int* kind, int K) {
  if (K < 1 || K > kAsmK) return false;
  for (int k = 0; k < K; ++k) {
    if (kind[k] < kWall || kind[k] > kVinlet) return false;
  }
  return true;
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

template <typename T, int kPsi>
__device__ __forceinline__ T tvd_psi(T r) {
  if (kPsi == 0) return r;                  // tvd_lud
  if (kPsi == 1) return (T(3) + r) / T(4);  // tvd_quick
  // tvd_umist: max(0, min(min(2r, (1 + 3r)/4), min((3 + r)/4, 2)))
  const T a = T(2) * r;
  const T b = (T(1) + T(3) * r) / T(4);
  const T c = (T(3) + r) / T(4);
  const T m1 = b < a ? b : a;
  const T m2 = T(2) < c ? T(2) : c;
  const T m = m2 < m1 ? m2 : m1;
  return m > T(0) ? m : T(0);
}

template <typename T>
__device__ __forceinline__ T pick3(int a, T g0, T g1, T g2) {
  return a == 0 ? g0 : (a == 1 ? g1 : g2);
}


// A block of the box staged in shared memory. Cell (x, y, z) of the box
// is row x + nx (y + ny z) - r0 (valid_box); a CTA assembles the
// bx x by x bz cells of its tile (one per thread) from a stage of the
// tile and a halo of hx, hy, hz cells (0 on an axis of extent 1), slot
// (sx, sy, sz) holding box cell (x0 - hx + sx, ...). Column k's
// neighbour of slot s is slot s + ds[k], one step along the column's
// axis. A slot is loaded from its row whenever that row lies in [0, C):
// the neighbour i + offset[k] of a row i is then staged whichever face
// it crosses, so the tile reads exactly what the row-by-row kernel
// read. Only slots outside the tile along at most one axis are staged:
// a cell reads its face neighbours, and a neighbour's gradient along
// that face's axis reads one cell further along it.
struct BoxTile {
  int nx, ny, nz, r0;
  int bx, by, bz, lg_bx, lg_by;
  int hx, hy, hz;
  int sx, sy, sz;
  // The halo slots: on each axis 2 h layers of the tile's cross-section
  // (nh_x + nh_y + nh_z in all), enumerated with shifts only (lg_hx2 =
  // log2(2 hx), and so on).
  int nh_x, nh_y, nh_z, lg_hx2, lg_hy2;
  int ds[kAsmK];
};

// The tile shape of `threads` cells (256: 32 x 8 in 2-D, 16 x 4 x 4 in
// 3-D; 128: 32 x 4, 16 x 2 x 4), narrower on a thin box, smaller (down
// to `min_cells`) on a small one, and the slot step of each column, or
// false when a column with a neighbour offset is not one step along the
// axis of its normal, an axis the halo covers, or its normal has a
// second component (its Green-Gauss weights would reach slots that are
// not staged).
template <typename T>
bool make_box_tile(const AsmCols<T>& c, int nx, int ny, int nz, int halo,
                   BoxTile* bt, int threads = kThreads,
                   int min_cells = 64) {
  BoxTile t{};
  t.nx = nx;
  t.ny = ny;
  t.nz = nz;
  t.bz = nz > 1 ? 4 : 1;
  t.bx = nz > 1 ? 16 : 32;
  while (t.bx > 1 && t.bx / 2 >= nx) t.bx /= 2;
  t.by = threads / (t.bx * t.bz);
  while (t.by > 1 && t.by / 2 >= ny) t.by /= 2;
  // A small box takes smaller tiles, down to min_cells, until its CTAs
  // reach every SM of an H100 (132): each thread's work is one cell.
  auto ctas = [&] {
    return static_cast<long long>((nx + t.bx - 1) / t.bx) *
           ((ny + t.by - 1) / t.by) * ((nz + t.bz - 1) / t.bz);
  };
  while (t.bx * t.by * t.bz > min_cells && ctas() < 132) {
    if (t.bz > 2) {
      t.bz /= 2;
    } else if (t.by > 4) {
      t.by /= 2;
    } else if (t.bx > 16) {
      t.bx /= 2;
    } else if (t.bz > 1) {
      t.bz /= 2;
    } else if (t.by > 1) {
      t.by /= 2;
    } else {
      t.bx /= 2;
    }
  }
  t.lg_bx = 0;
  while ((1 << t.lg_bx) < t.bx) ++t.lg_bx;
  t.lg_by = 0;
  while ((1 << t.lg_by) < t.by) ++t.lg_by;
  t.hx = nx > 1 ? halo : 0;
  t.hy = ny > 1 ? halo : 0;
  t.hz = nz > 1 ? halo : 0;
  t.sx = t.bx + 2 * t.hx;
  t.sy = t.by + 2 * t.hy;
  t.sz = t.bz + 2 * t.hz;
  t.nh_x = 2 * t.hx * t.by * t.bz;
  t.nh_y = 2 * t.hy * t.bx * t.bz;
  t.nh_z = 2 * t.hz * t.bx * t.by;
  t.lg_hx2 = t.hx == 2 ? 2 : 1;
  t.lg_hy2 = t.hy == 2 ? 2 : 1;
  const long long nxy = static_cast<long long>(nx) * ny;
  const int step[3] = {1, t.sx, t.sx * t.sy};
  const bool covered[3] = {t.hx > 0, t.hy > 0, t.hz > 0};
  for (int k = 0; k < c.K; ++k) {
    const long long o = c.offset[k];
    const long long m = o < 0 ? -o : o;
    t.ds[k] = 0;
    if (o == 0) continue;
    const int a = m == 1 ? 0 : (m == nx ? 1 : (m == nxy ? 2 : -1));
    if (a < 0 || a != c.axis[k] || !covered[a]) return false;
    for (int b = 0; b < 3; ++b) {
      if (b != a && c.gw[b][k] != T(0)) return false;
    }
    t.ds[k] = (o < 0 ? -1 : 1) * step[a];
  }
  *bt = t;
  return true;
}

// Halo slot q < nh_x + nh_y + nh_z of the stage: its coordinates in the
// stage, its distance d (1 or 2) from the tile and the axis a it lies
// out along. Consecutive q run along x where the face allows it.
__device__ __forceinline__ void halo_slot(const BoxTile& t, int q, int& x,
                                          int& y, int& z, int& d, int& a) {
  int ls;  // side (bit 0) and layer (bit 1) of the face
  if (q < t.nh_x) {
    ls = q & ((2 * t.hx) - 1);
    const int r = q >> t.lg_hx2;
    y = t.hy + (r & (t.by - 1));
    z = t.hz + (r >> t.lg_by);
    d = (ls >> 1) + 1;
    x = (ls & 1) ? t.hx + t.bx - 1 + d : t.hx - d;
    a = 0;
  } else if ((q -= t.nh_x) < t.nh_y) {
    x = t.hx + (q & (t.bx - 1));
    const int r = q >> t.lg_bx;
    ls = r & ((2 * t.hy) - 1);
    z = t.hz + (r >> t.lg_hy2);
    d = (ls >> 1) + 1;
    y = (ls & 1) ? t.hy + t.by - 1 + d : t.hy - d;
    a = 1;
  } else {
    q -= t.nh_y;
    x = t.hx + (q & (t.bx - 1));
    const int r = q >> t.lg_bx;
    y = t.hy + (r & (t.by - 1));
    ls = r >> t.lg_by;
    d = (ls >> 1) + 1;
    z = (ls & 1) ? t.hz + t.bz - 1 + d : t.hz - d;
    a = 2;
  }
}

// The per-column products of Python numbers the first design formed in
// every thread, formed once by the launcher with the same rounded
// operations: mu A / dist_on, mu A / dist_fo, A rho, and the relaxation
// factor (1 - alpha) / alpha.
template <typename T>
struct MomentumConsts {
  T d_int[kAsmK];
  T d_bnd[kAsmK];
  T arho[kAsmK];
  T relax;
};

template <typename T>
MomentumConsts<T> make_momentum_consts(const AsmCols<T>& c, T rho, T mu,
                                       T alpha) {
  MomentumConsts<T> m{};
  for (int k = 0; k < c.K; ++k) {
    m.d_int[k] = mu * c.area[k] / c.dist_on[k];
    m.d_bnd[k] = mu * c.area[k] / c.dist_fo[k];
    m.arho[k] = c.area[k] * rho;
  }
  m.relax = (T(1) - alpha) / alpha;
  return m;
}

// The launch of a kernel over the tiles of box tile t: its grid, or
// false when a staged row (up to a tile and a halo of 2 past each far
// side of the box) would not fit the kernels' 32-bit row arithmetic, or
// the grid is too tall.
inline bool box_grid(const BoxTile& t, dim3* grid) {
  const long long nx = t.nx, nxy = nx * t.ny;
  if ((t.nz + t.bz + 3) * nxy + (t.by + 3) * nx + t.bx + 3 > 2147483647LL) {
    return false;
  }
  const long long gy = (t.ny + t.by - 1) / t.by, gz = (t.nz + t.bz - 1) / t.bz;
  if (gy > 65535 || gz > 65535) return false;
  *grid = dim3(static_cast<unsigned>((nx + t.bx - 1) / t.bx),
               static_cast<unsigned>(gy), static_cast<unsigned>(gz));
  return true;
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB only
// after an opt-in); returns the CUDA error code.
template <typename Kernel>
int fit_smem(Kernel kernel, long long bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace orc
