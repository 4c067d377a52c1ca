// Shared definitions of the fused assembly kernels (assembly.cu for
// SIMPLE_FC, parity_assembly.cuh for the parity SIMPLE loop): the static
// per-column constants of a uniform box, the face-flux and limiter
// helpers, and the in-kernel Green-Gauss pressure gradient.
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
  // (0 where the normal has no component a); the same weights on the
  // axis of column k (gwk[k], zero rows for columns without a
  // neighbour offset), the weights of the neighbour's gradient that
  // column k reads; and the bit mask of the axes some neighbour column
  // has.
  T gw[3][MAX_K];
  T gwk[MAX_K][MAX_K];
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
  for (int k = 0; k < K; ++k) {
    for (int k2 = 0; k2 < K; ++k2) {
      c.gwk[k][k2] = c.axis[k] >= 0 ? c.gw[c.axis[k]][k2] : T(0);
    }
  }
  return c;
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

// Green-Gauss cell pressure gradient of cell `cell` with flag word `fl`
// and pressure p_c on one axis, given that axis' column weights `w`
// (cols.gw[a], or cols.gwk[k] for column k's axis): orc_tpu's
// `_gg_eval` with Linear face pressures, exactly ck_pressure_gradient.
// The sum runs in column order over the columns with a weight: the mean
// of the two cells on interior faces, the BC value on pressure
// boundaries, the cell's own value on the others. The neighbours' p
// comes from device memory (two hops from the cell being assembled, for
// a neighbour's gradient).
template <typename T>
__device__ __forceinline__ T gg_gradient(const AsmCols<T>& cols,
                                         const T* __restrict__ p,
                                         const T* __restrict__ bc,
                                         long long cell, int fl, T p_c,
                                         const T* w) {
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < kAsmK; ++k) {
    if (k >= cols.K || w[k] == T(0)) continue;
    T p_f;
    if ((fl >> k) & 1) {
      p_f = T(0.5) * (p_c + p[cell + cols.offset[k]]);
    } else {
      p_f = cols.kind[k] == kPressure ? bc[4 * cols.zone[k] + 3] : p_c;
    }
    acc = acc + w[k] * p_f;
  }
  return acc;
}

}  // namespace orc
