// The face-major momentum assembly on Hopper (sm_90a): the face pressure
// and the three momentum systems of the face-major steps (ops/
// interpolation.py `face_pressure` + ops/assembly.py `momentum_system`)
// in one pass over the cells, for the schemes whose u, v and w systems
// share one matrix: UD, CD1 and TVD_DC, under LINEAR or LINEAR_WEIGHTED
// face pressures. orc_tpu has no kernel here (its face-major assembly is
// plain jnp); the plain version is about a hundred eager torch ops over
// [C,K] and [C,K,3] temporaries.
//
// One thread a cell walks the cell's K face slots of the padded [C,K]
// adjacency (cell_faces, cell_neighbors, cell_face_sign, cell_face_mask,
// the diffusion's off-diagonals), reading each slot's row with the
// widest loads its width allows (16 bytes at K = 4 in float32, 8 at
// K = 6, one load a slot where a row is not aligned), its face's data
// (flux, area, interior flag, zone slot, normal, LINEAR_WEIGHTED's
// weight, TVD_DC's owner -> neighbour vector) and its neighbour's p (and
// TVD_DC's velocity, and the neighbour's velocity gradient where the
// neighbour is upwind) through the read-only path. Per slot, as the plain
// ops:
//   F    = sign flux area rho              (mass flow out of the cell)
//   a_nb = min(F, 0) (UD, TVD_DC) or F / 2 (CD1); a_p += -a_nb + F;
//   off  = a_nb + the diffusion's off-diagonal on interior faces;
//   p_f  = p_own (wall, symmetry, velocity inlet), the zone's pressure
//          (pressure inlet and outlet), else 0.5 (p_own + p_nbr) or
//          p_own + (p_nbr - p_own) lw, formed in the face's own
//          orientation (owner, neighbour), so both sides of a face see
//          the same value;
//   s_u -= sign n p_f A; Dirichlet-velocity boundaries add (a_nb - F)
//          v_bc; TVD_DC's deferred correction subtracts F psi(r)/2
//          (phi_D - phi_U) on interior faces, r = 2 grad_U . r_UD /
//          (phi_D - phi_U) - 1, nothing where phi_D == phi_U.
// Then diag = a_p + the diffusion's diagonal, b = s_u + its Dirichlet
// source, the inertia rho V/dt of transient runs (nullable rv_dt,
// vel_n), Patankar relaxation under IMPLICIT, identity rows for padded
// cells, and the Peclet array a_p / the diffusion's diagonal. Outputs:
// diag [C], off as K contiguous [C] planes (the layout mesh_matrix
// takes), b [3,C] and pe [C,3]. The momentum source is the caller's, as
// on the (c,k) kernel path.
//
// Gather only: every output element is written by its own cell's thread,
// no atomics, so the bits do not depend on scheduling. The limiter is a
// template code (tvd_psi in assembly.cuh, LIMITER_CODES), as in rows 3
// and 4. Bound by the gathers, with no shared-memory staging: 0.233 ms at
// the 1024^2 f32 cavity under TVD_DC + UMIST, 52% of its 0.121 ms bound
// (each input read once, each output written once), against 8.2 ms for
// the plain ops, and 0.305 ms (56%) at 128^3 under UD, on an NVIDIA H100
// 80GB HBM3 at 700 W.
#include <cstring>

#include "assembly.cuh"

namespace orc {

// FaceCondition codes (orc_tpu_torch/mesh/zones.py).
constexpr int kCodeWall = 3;
constexpr int kCodePressureInlet = 4;
constexpr int kCodePressureOutlet = 5;
constexpr int kCodeSymmetry = 7;
constexpr int kCodeVelocityInlet = 10;

template <typename T>
struct FmArgs {
  // [C,K] slot tables.
  const int* cell_faces;
  const int* cell_nbrs;
  const T* sign;
  const unsigned char* mask;
  const T* diff_off;
  // [F] face data.
  const T* flux;
  const T* area;
  const unsigned char* interior;
  const int* zone;
  const T* normal;  // [F,3]
  const T* r_on;    // [F,3], TVD_DC only
  const T* lw;      // LINEAR_WEIGHTED only
  // [Z] zone tables.
  const int* zcode;
  const T* zscalar;
  const T* zvector;  // [Z,3]
  // [C] cell data.
  const T* vel;       // [C,3]
  const T* p;
  const T* grad_vel;  // [C,3,3], TVD_DC only
  const T* diff_diag;
  const T* diff_b;    // [C,3]
  const T* rv_dt;     // null in steady runs
  const T* vel_n;     // [C,3], null in steady runs
  T* diag;
  T* off;  // [K,C]
  T* b;    // [3,C]
  T* pe;   // [C,3]
  T rho, relax, alpha;
  long long C;
  int K;
  int weighted, implicit;
};

// The N values of a slot row starting at `row` into `out`, with the
// widest loads that divide the row's bytes (at most 16): rows of a
// contiguous [C,N] table from a 16-byte aligned base start at such a
// boundary.
template <int N, typename V>
__device__ __forceinline__ void load_row(const V* __restrict__ row,
                                         V (&out)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(V));
  constexpr int kW = (kBytes % 16 == 0) ? 16
                     : (kBytes % 8 == 0) ? 8
                     : (kBytes % 4 == 0) ? 4
                     : (kBytes % 2 == 0) ? 2
                                         : 1;
  unsigned char* dst = reinterpret_cast<unsigned char*>(out);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(row);
#pragma unroll
  for (int o = 0; o < kBytes; o += kW) {
    if constexpr (kW == 16) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(src + o));
      memcpy(dst + o, &w, 16);
    } else if constexpr (kW == 8) {
      const unsigned long long w =
          __ldg(reinterpret_cast<const unsigned long long*>(src + o));
      memcpy(dst + o, &w, 8);
    } else if constexpr (kW == 4) {
      const unsigned w = __ldg(reinterpret_cast<const unsigned*>(src + o));
      memcpy(dst + o, &w, 4);
    } else if constexpr (kW == 2) {
      const unsigned short w =
          __ldg(reinterpret_cast<const unsigned short*>(src + o));
      memcpy(dst + o, &w, 2);
    } else {
      dst[o] = __ldg(src + o);
    }
  }
}

// What a cell gathers over its slots.
template <typename T>
struct FmCell {
  long long c;
  T u[3];
  T p;
  T g[9];  // the own velocity gradient (TVD_DC)
  T a_p;
  T pf[3];  // sum of n_out p_f A
  T sd[3];  // sum of the Dirichlet sources (a_nb - F) v_bc
  T dc[3];  // sum of F times the TVD_DC correction
  bool active;
};

template <typename T, int kScheme, int kPsi>
__device__ __forceinline__ void fm_slot(const FmArgs<T>& a, FmCell<T>& st,
                                        int k, int f, int nb, T sg, bool m,
                                        T doff) {
  T* off = a.off + k * a.C + st.c;
  if (!m) {  // a padded slot contributes nothing
    *off = T(0);
    return;
  }
  st.active = true;
  const T area = __ldg(a.area + f);
  const bool interior = __ldg(a.interior + f) != 0;
  const int zs = __ldg(a.zone + f);
  const int code = __ldg(a.zcode + zs);
  const T F = ((sg * __ldg(a.flux + f)) * area) * a.rho;
  const T a_nb = kScheme == kCD1 ? F / T(2) : (F < T(0) ? F : T(0));
  st.a_p = st.a_p + (-a_nb + F);
  *off = interior ? a_nb + doff : T(0);
  // Face pressure, in the face's orientation: the cell is its owner
  // where the sign is +1 (every boundary face).
  const T p_n = __ldg(a.p + nb);
  const T p_own = sg > T(0) ? st.p : p_n;
  const T p_oth = sg > T(0) ? p_n : st.p;
  T p_f;
  if (code == kCodeWall || code == kCodeSymmetry ||
      code == kCodeVelocityInlet) {
    p_f = p_own;
  } else if (code == kCodePressureInlet || code == kCodePressureOutlet) {
    p_f = __ldg(a.zscalar + zs);
  } else if (a.weighted) {
    p_f = p_own + (p_oth - p_own) * __ldg(a.lw + f);
  } else {
    p_f = T(0.5) * (p_own + p_oth);
  }
  const T pfA = p_f * area;
  const T* n = a.normal + 3 * static_cast<long long>(f);
#pragma unroll
  for (int i = 0; i < 3; ++i) st.pf[i] = st.pf[i] + (sg * __ldg(n + i)) * pfA;
  // Dirichlet-velocity boundary advection source.
  if ((code == kCodeWall || code == kCodeVelocityInlet) && !interior) {
    const T s = a_nb - F;
    const T* v = a.zvector + 3 * zs;
#pragma unroll
    for (int i = 0; i < 3; ++i) st.sd[i] = st.sd[i] + s * __ldg(v + i);
  }
  // TVD_DC: the limited increment from the upwind side of the face.
  if (kScheme == kTvdDc && interior) {
    const T* ro = a.r_on + 3 * static_cast<long long>(f);
    const T r0 = sg * __ldg(ro), r1 = sg * __ldg(ro + 1),
            r2 = sg * __ldg(ro + 2);  // cell -> neighbour
    const bool up_c = F > T(0);
    const T* vn = a.vel + 3 * static_cast<long long>(nb);
    T gn[9];
    if (!up_c) {
      const T* gp = a.grad_vel + 9 * static_cast<long long>(nb);
#pragma unroll
      for (int e = 0; e < 9; ++e) gn[e] = __ldg(gp + e);
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const T d_cd = __ldg(vn + q) - st.u[q];
      const T delta = up_c ? d_cd : -d_cd;  // phi_D - phi_U
      const T gdotr =
          up_c ? st.g[3 * q] * r0 + st.g[3 * q + 1] * r1 + st.g[3 * q + 2] * r2
               : gn[3 * q] * (-r0) + gn[3 * q + 1] * (-r1) +
                     gn[3 * q + 2] * (-r2);
      const T safe = delta == T(0) ? T(1) : delta;
      const T rr = T(2) * gdotr / safe - T(1);
      const T corr =
          delta == T(0) ? T(0) : tvd_psi<T, kPsi>(rr) * T(0.5) * delta;
      st.dc[q] = st.dc[q] + F * corr;
    }
  }
}

// KC: the slot count K as a template constant (rows loaded whole), or 0
// for any K (one load a slot).
template <typename T, int kScheme, int kPsi, int KC>
__global__ void __launch_bounds__(kThreads)
    fm_momentum_kernel(const FmArgs<T> a) {
  const long long c =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= a.C) return;
  FmCell<T> st;
  st.c = c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    st.u[i] = __ldg(a.vel + 3 * c + i);
    st.pf[i] = st.sd[i] = st.dc[i] = T(0);
  }
  st.p = __ldg(a.p + c);
  if (kScheme == kTvdDc) {
#pragma unroll
    for (int e = 0; e < 9; ++e) st.g[e] = __ldg(a.grad_vel + 9 * c + e);
  }
  st.a_p = T(0);
  st.active = false;
  if constexpr (KC > 0) {
    int cf[KC], nb[KC];
    T sg[KC], doff[KC];
    unsigned char mk[KC];
    load_row<KC>(a.cell_faces + KC * c, cf);
    load_row<KC>(a.cell_nbrs + KC * c, nb);
    load_row<KC>(a.sign + KC * c, sg);
    load_row<KC>(a.mask + KC * c, mk);
    load_row<KC>(a.diff_off + KC * c, doff);
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      fm_slot<T, kScheme, kPsi>(a, st, k, cf[k], nb[k], sg[k], mk[k] != 0,
                                doff[k]);
    }
  } else {
    for (int k = 0; k < a.K; ++k) {
      const long long j = a.K * c + k;
      fm_slot<T, kScheme, kPsi>(a, st, k, __ldg(a.cell_faces + j),
                                __ldg(a.cell_nbrs + j), __ldg(a.sign + j),
                                __ldg(a.mask + j) != 0, __ldg(a.diff_off + j));
    }
  }
  const T dd = __ldg(a.diff_diag + c);
  T diag = st.a_p + dd;
  T b[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T s_u = -st.pf[i] + st.sd[i];
    if (kScheme == kTvdDc) s_u = s_u + (-st.dc[i]);
    b[i] = s_u + __ldg(a.diff_b + 3 * c + i);
  }
  if (a.rv_dt != nullptr) {  // the same for every thread
    const T rv = __ldg(a.rv_dt + c);
    diag = diag + rv;
#pragma unroll
    for (int i = 0; i < 3; ++i) b[i] = b[i] + rv * __ldg(a.vel_n + 3 * c + i);
  }
  if (a.implicit) {
#pragma unroll
    for (int i = 0; i < 3; ++i) b[i] = b[i] + a.relax * diag * st.u[i];
    diag = diag / a.alpha;
  }
  const bool act = st.active;
  a.diag[c] = act ? diag : T(1);
  const T pe = act ? st.a_p / dd : T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a.b[i * a.C + c] = act ? b[i] : T(0);
    a.pe[3 * c + i] = pe;
  }
}

template <typename T>
using FmKernel = void (*)(FmArgs<T>);

template <typename T, int kScheme, int kPsi>
FmKernel<T> fm_pick_k(int KC) {
  if (KC == 4) return fm_momentum_kernel<T, kScheme, kPsi, 4>;
  if (KC == 6) return fm_momentum_kernel<T, kScheme, kPsi, 6>;
  return fm_momentum_kernel<T, kScheme, kPsi, 0>;
}

// The instance of a (scheme, limiter, slot count) choice; the limiter
// code matters under TVD_DC only.
template <typename T>
FmKernel<T> fm_select(int scheme, int psi, int KC) {
  if (scheme == kUD) return fm_pick_k<T, kUD, 0>(KC);
  if (scheme == kCD1) return fm_pick_k<T, kCD1, 0>(KC);
  if (psi == 0) return fm_pick_k<T, kTvdDc, 0>(KC);
  if (psi == 1) return fm_pick_k<T, kTvdDc, 1>(KC);
  return fm_pick_k<T, kTvdDc, 2>(KC);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <typename T>
int launch_fm_momentum(int scheme, int psi, int K, int weighted,
                       int implicit, const void* const* ptrs, double rho,
                       double relax, double alpha, long long C,
                       cudaStream_t stream) {
  FmArgs<T> a;
  a.cell_faces = static_cast<const int*>(ptrs[0]);
  a.cell_nbrs = static_cast<const int*>(ptrs[1]);
  a.sign = static_cast<const T*>(ptrs[2]);
  a.mask = static_cast<const unsigned char*>(ptrs[3]);
  a.diff_off = static_cast<const T*>(ptrs[4]);
  a.flux = static_cast<const T*>(ptrs[5]);
  a.area = static_cast<const T*>(ptrs[6]);
  a.interior = static_cast<const unsigned char*>(ptrs[7]);
  a.zone = static_cast<const int*>(ptrs[8]);
  a.normal = static_cast<const T*>(ptrs[9]);
  a.r_on = static_cast<const T*>(ptrs[10]);
  a.lw = static_cast<const T*>(ptrs[11]);
  a.zcode = static_cast<const int*>(ptrs[12]);
  a.zscalar = static_cast<const T*>(ptrs[13]);
  a.zvector = static_cast<const T*>(ptrs[14]);
  a.vel = static_cast<const T*>(ptrs[15]);
  a.p = static_cast<const T*>(ptrs[16]);
  a.grad_vel = static_cast<const T*>(ptrs[17]);
  a.diff_diag = static_cast<const T*>(ptrs[18]);
  a.diff_b = static_cast<const T*>(ptrs[19]);
  a.rv_dt = static_cast<const T*>(ptrs[20]);
  a.vel_n = static_cast<const T*>(ptrs[21]);
  a.diag = static_cast<T*>(const_cast<void*>(ptrs[22]));
  a.off = static_cast<T*>(const_cast<void*>(ptrs[23]));
  a.b = static_cast<T*>(const_cast<void*>(ptrs[24]));
  a.pe = static_cast<T*>(const_cast<void*>(ptrs[25]));
  a.rho = static_cast<T>(rho);
  a.relax = static_cast<T>(relax);
  a.alpha = static_cast<T>(alpha);
  a.C = C;
  a.K = K;
  a.weighted = weighted;
  a.implicit = implicit;
  // Whole rows where the slot tables start on 16-byte boundaries.
  bool rows = K == 4 || K == 6;
  for (int t = 0; t < 5; ++t) rows = rows && aligned16(ptrs[t]);
  const FmKernel<T> kernel = fm_select<T>(scheme, psi, rows ? K : 0);
  const long long blocks = (C + kThreads - 1) / kThreads;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace orc

// ptrs: cell_faces, cell_neighbors, cell_face_sign, cell_face_mask,
// diffusion off [C,K]; flux, area, interior, zone slot, normal, r_on, lw
// [F]; zone codes, scalars, vectors [Z]; vel, p, grad_vel, diffusion
// diag and b, rv_dt, vel_n [C]; diag, off, b, pe (outputs).
extern "C" int orc_fm_momentum_assembly(int dtype, int scheme, int psi, int K,
                                        int weighted, int implicit,
                                        const void* const* ptrs, double rho,
                                        double relax, double alpha,
                                        long long C, void* stream) {
  if (K < 1 || C < 1 || C > 2147483647LL * orc::kThreads || scheme < orc::kUD ||
      scheme > orc::kTvdDc || psi < 0 || psi > 2 ||
      (scheme == orc::kTvdDc && (ptrs[10] == nullptr || ptrs[17] == nullptr)) ||
      (weighted && ptrs[11] == nullptr) ||
      ((ptrs[20] == nullptr) != (ptrs[21] == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int t = 0; t < 26; ++t) {
    const bool optional = t == 10 || t == 11 || t == 17 || t == 20 || t == 21;
    if (!optional && ptrs[t] == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == orc::kF32) {
    return orc::launch_fm_momentum<float>(scheme, psi, K, weighted, implicit,
                                          ptrs, rho, relax, alpha, C, s);
  }
  if (dtype == orc::kF64) {
    return orc::launch_fm_momentum<double>(scheme, psi, K, weighted, implicit,
                                           ptrs, rho, relax, alpha, C, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
