// lj/charmm/coul/long forces, energies and virial over the cell grid's
// pair list, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpumd/ops/pallas_charmm.py::_kernel
// (entry charmm_cellgrid_forces_pallas) and, on energy steps, the XLA
// sweep tpumd/ops/cellgrid.py::cellgrid_pair_sums(q=..., special=...) of
// the rhodo_class deck.  The TPU kernel tested the 27-cell stencil at each
// call; here the candidate search runs once per re-bin
// (cellgrid_pairlist.cu) and this kernel sweeps its list, as the LAMMPS
// GPU package runs lj/charmm/coul/long: a full list, the special code in
// the top two bits of each entry, several lanes per atom.
//
// Atoms sit in grid-slot order: x (slots, 3), q, type per slot; pairs
// (slots, K) holds each slot's list entries j | code << 30 and npairs
// its count (ops/cellgrid_pairlist.py).  Every slot i sums, over its
// entries, with d = x_i - x_j at the minimum image of the current box
// (exact: the grid holds L >= 2 cutneigh; d and r2 rounded op by op, no
// contraction, as the plain version rounds them, so both take the same
// pairs inside each cutoff) and r2 < max(cut_coulsq, cut_ljsq):
//   w_lj, w_coul = W[code], the special_bonds weights (W[0] = 1);
//   Coulomb (r2 < cut_coulsq): erfc by the reference's polynomial
//     (src/KSPACE/pair_lj_charmm_coul_long.cpp:143-158, the same constants
//     as tpumd), prefactor = qqrd2e q_i q_j / r,
//     forcecoul = prefactor (erfc + EWALD_F g r e^-(g r)^2)
//                 - (1 - w_coul) prefactor   (the kspace exclusion term:
//                 an excluded pair in range stays in the list),
//     ecoul = prefactor erfc - (1 - w_coul) prefactor;
//   LJ (r2 < cut_ljsq): lj1..lj4 from the (ntypes+1)^2 tables, CHARMM's
//     energy switch between cut_lj_inner and cut_lj, times w_lj;
//   fpair = forcelj / r2 + forcecoul / r2, f_i += d fpair.
// With EFLAG each slot writes its van der Waals and Coulomb energies, with
// VFLAG the six components sum_j fpair d_a d_b; the caller halves their
// sums.  An empty slot has no entries and writes zeros.
//
// The owned-rows variant (ROWS) sweeps only the slots rows[0..nrows), a
// warp each, as B1 and B3/B4 do on a rank's local grid
// (tpumd_torch/parallel/decomp.py): rows are the owned atoms' slots, the
// halo slots' rows (the neighbours' atoms) are not swept and every other
// slot's outputs keep the zeros the caller wrote.  Its image is taken as
// B1 takes it, d = x_i - (x_j + s) with s = L rint((x_i - x_j) / L), so
// that a halo copy across a periodic seam, whose position holds the box
// length already (x_j + L, rounded once), gives the bits of the global
// grid's pair: a local grid's owned rows equal the global grid's ROWS
// launch bit for bit.  Without rows the kernel is the one described above,
// its image d - L rint(d / L).
//
// What bounds it: at the 32k rhodo_class shape (47,104 slots, 32,064
// atoms) a call reads ~2.3e7 list entries (~705 a row), 58 % of them in
// range (~408 a row), each in-range pair an exponential, a square root and
// three divisions: 6.5e6 unordered pairs, ~0.0066 ms of f32 arithmetic at
// the card's peak.  The list's bytes, ~90 MB, are ~0.027 ms at 3.35 TB/s,
// a floor of this design rather than of the work.  The old stencil kernel
// tested 9,936 candidates a slot, 2.8 % in range, and a warp took the
// in-range branch on ~60 % of its steps (3.3 ms a call).
//
// Design: one warp per i slot (kLanes = 32, the fastest of 4, 8, 16 and 32
// lanes per slot on the card: PERF.md).  Lane l of a slot walks entries l,
// l + 32, ..., so the warp reads 128 consecutive bytes of its row at each
// step, and since a row runs through each cell's slots in order, mostly
// consecutive j: the j side (x, q, type, ~1 MB at 47k slots) comes through
// L1/L2 in coalesced loads.  58 % of a lane's entries take the in-range
// branch instead of 2.8 %.
// The lanes' sums meet by warp shuffles (f, both energies, the six virial
// components), and the first lane of the slot writes them.  The lj tables
// sit in shared memory; the special weights are a select on the code.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kBlock = 128;
constexpr unsigned kNeighMask = (1u << 30) - 1u;

constexpr double kEwaldF = 1.12837917;
constexpr double kEwaldP = 0.3275911;
constexpr double kA1 = 0.254829592;
constexpr double kA2 = -0.284496736;
constexpr double kA3 = 1.421413741;
constexpr double kA4 = -1.453152027;
constexpr double kA5 = 1.061405429;

__device__ __forceinline__ float exp_t(float a) { return expf(a); }
__device__ __forceinline__ double exp_t(double a) { return exp(a); }
__device__ __forceinline__ float sqrt_t(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_t(double a) { return sqrt(a); }
__device__ __forceinline__ float rint_t(float a) { return rintf(a); }
__device__ __forceinline__ double rint_t(double a) { return rint(a); }
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
// |d|^2 rounded as the plain version rounds it (no fused multiply-add)
__device__ __forceinline__ float norm2_rn(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                   __fmul_rn(c, c));
}
__device__ __forceinline__ double norm2_rn(double a, double b, double c) {
  return __dadd_rn(__dadd_rn(__dmul_rn(a, a), __dmul_rn(b, b)),
                   __dmul_rn(c, c));
}

// x_i - x_j at the nearest image on an axis of length L: d - L rint(d / L),
// each step rounded as the plain version (minimum_image_c) rounds it
template <typename T>
__device__ __forceinline__ T image_rn(T xi, T xj, T L) {
  const T d = sub_rn(xi, xj);
  return sub_rn(d, mul_rn(L, rint_t(d / L)));
}

// x_i - (x_j + s), s = L rint((x_i - x_j) / L): the owned-rows variant's
// image, each step rounded as the plain version (list_entries) rounds it
template <typename T>
__device__ __forceinline__ T image_d(T xi, T xj, T L) {
  const T s = L * rint_t(sub_rn(xi, xj) / L);
  return sub_rn(xi, add_rn(xj, s));
}

template <bool ROWS, typename T>
__device__ __forceinline__ T image_t(T xi, T xj, T L) {
  return ROWS ? image_d(xi, xj, L) : image_rn(xi, xj, L);
}

// special_bonds weights by code: index 0 (no special) is 1
template <typename T>
struct Weights {
  T lj[4];
  T coul[4];
};

template <typename T>
struct Params {
  T qqrd2e, g_ewald, cut_coulsq, cut_ljsq, cut_lj_innersq, denom_lj;
};

template <typename T>
__device__ __forceinline__ T by_code(const T (&w)[4], unsigned code) {
  return code == 0 ? w[0] : code == 1 ? w[1] : code == 2 ? w[2] : w[3];
}

// the sum of v over the kLanes lanes of a slot, in its first lane
template <typename T>
__device__ __forceinline__ T lanes_sum(T v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, o, kLanes);
  }
  return v;
}

template <typename T, bool EFLAG, bool VFLAG, bool ROWS>
__global__ void __launch_bounds__(kBlock) charmm_pairlist_kernel(
    const T* __restrict__ x, const T* __restrict__ q,
    const int* __restrict__ type, const int* __restrict__ pairs,
    const int* __restrict__ npairs, int K, const T* __restrict__ lengths,
    const T* __restrict__ ljtab, int nt1, T* __restrict__ f,
    T* __restrict__ eslot, T* __restrict__ cslot, T* __restrict__ vslot,
    long long np, const long long* __restrict__ rows, long long nrows,
    Params<T> p, Weights<T> w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slj = reinterpret_cast<T*>(smem_raw);  // 4 * ntab: lj1..lj4
  const int ntab = nt1 * nt1;
  for (int k = threadIdx.x; k < 4 * ntab; k += blockDim.x) slj[k] = ljtab[k];
  __syncthreads();

  // the slot of these lanes: the g-th row's (ROWS), else the g-th slot
  const long long g =
      (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) / kLanes;
  const int lane = threadIdx.x % kLanes;
  const bool active = g < (ROWS ? nrows : np);
  const long long i = ROWS ? (active ? rows[g] : 0) : g;
  const T cutsq = p.cut_coulsq > p.cut_ljsq ? p.cut_coulsq : p.cut_ljsq;

  T fx = T(0), fy = T(0), fz = T(0), ev = T(0), ec = T(0);
  T v0 = T(0), v1 = T(0), v2 = T(0), v3 = T(0), v4 = T(0), v5 = T(0);
  if (active) {
    const T xi = x[3 * i + 0], yi = x[3 * i + 1], zi = x[3 * i + 2];
    const T qi = q[i];
    const int ti = type[i];
    const T Lx = lengths[0], Ly = lengths[1], Lz = lengths[2];
    const int* row = pairs + i * K;
    const int n = npairs[i];
    for (int k = lane; k < n; k += kLanes) {
      const unsigned e = static_cast<unsigned>(row[k]);
      const long long j = e & kNeighMask;
      const unsigned code = e >> 30;
      const T dx = image_t<ROWS>(xi, x[3 * j + 0], Lx);
      const T dy = image_t<ROWS>(yi, x[3 * j + 1], Ly);
      const T dz = image_t<ROWS>(zi, x[3 * j + 2], Lz);
      const T r2 = norm2_rn(dx, dy, dz);
      if (!(r2 < cutsq)) continue;

      const T r2inv = T(1) / r2;
      T fcoul = T(0);
      if (r2 < p.cut_coulsq) {
        const T wc = by_code(w.coul, code);
        const T r = sqrt_t(r2);
        const T grij = p.g_ewald * r;
        const T expm2 = exp_t(-grij * grij);
        const T tp = T(1) / (T(1) + T(kEwaldP) * grij);
        const T erfc =
            tp * (T(kA1) + tp * (T(kA2) + tp * (T(kA3) + tp * (T(kA4) +
                  tp * T(kA5))))) * expm2;
        const T prefactor = p.qqrd2e * qi * q[j] / r;
        fcoul = prefactor * (erfc + T(kEwaldF) * grij * expm2) -
                (T(1) - wc) * prefactor;
        if (EFLAG) ec += prefactor * erfc - (T(1) - wc) * prefactor;
      }
      T forcelj = T(0);
      if (r2 < p.cut_ljsq) {
        const T wl = by_code(w.lj, code);
        const int idx = ti * nt1 + type[j];
        const T r6inv = r2inv * r2inv * r2inv;
        forcelj = r6inv * (slj[idx] * r6inv - slj[ntab + idx]);
        T philj = r6inv * (slj[2 * ntab + idx] * r6inv -
                           slj[3 * ntab + idx]);
        if (r2 > p.cut_lj_innersq) {
          const T tsw = p.cut_ljsq - r2;
          const T switch1 = tsw * tsw *
                            (p.cut_ljsq + T(2) * r2 -
                             T(3) * p.cut_lj_innersq) / p.denom_lj;
          const T switch2 = T(12) * r2 * tsw *
                            (r2 - p.cut_lj_innersq) / p.denom_lj;
          forcelj = forcelj * switch1 + philj * switch2;
          philj = philj * switch1;
        }
        forcelj = forcelj * wl;
        if (EFLAG) ev += philj * wl;
      }
      const T fpair = forcelj * r2inv + fcoul * r2inv;
      fx += dx * fpair;
      fy += dy * fpair;
      fz += dz * fpair;
      if (VFLAG) {
        v0 += fpair * dx * dx;
        v1 += fpair * dy * dy;
        v2 += fpair * dz * dz;
        v3 += fpair * dx * dy;
        v4 += fpair * dx * dz;
        v5 += fpair * dy * dz;
      }
    }
  }

  // every lane of the warp takes part in the shuffles
  fx = lanes_sum(fx);
  fy = lanes_sum(fy);
  fz = lanes_sum(fz);
  if (EFLAG) {
    ev = lanes_sum(ev);
    ec = lanes_sum(ec);
  }
  if (VFLAG) {
    v0 = lanes_sum(v0);
    v1 = lanes_sum(v1);
    v2 = lanes_sum(v2);
    v3 = lanes_sum(v3);
    v4 = lanes_sum(v4);
    v5 = lanes_sum(v5);
  }
  if (!active || lane != 0) return;
  f[3 * i + 0] = fx;
  f[3 * i + 1] = fy;
  f[3 * i + 2] = fz;
  if (EFLAG) {
    eslot[i] = ev;
    cslot[i] = ec;
  }
  if (VFLAG) {
    T* vo = vslot + 6 * i;
    vo[0] = v0; vo[1] = v1; vo[2] = v2; vo[3] = v3; vo[4] = v4; vo[5] = v5;
  }
}

template <typename T, bool EFLAG, bool VFLAG, bool ROWS>
int launch_rows(long long np, const long long* rows, long long nrows,
                const T* x, const T* q, const int* type, const int* pairs,
                const int* npairs, int K, const T* lengths, const T* ljtab,
                int nt1, T* f, T* eslot, T* cslot, T* vslot,
                const Params<T>& p, const Weights<T>& w, cudaStream_t s) {
  auto kernel = charmm_pairlist_kernel<T, EFLAG, VFLAG, ROWS>;
  const size_t smem = 4 * static_cast<size_t>(nt1) * nt1 * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long warps = ROWS ? nrows : np;
  const dim3 grid(
      static_cast<unsigned>((warps * kLanes + kBlock - 1) / kBlock));
  kernel<<<grid, kBlock, smem, s>>>(x, q, type, pairs, npairs, K, lengths,
                                    ljtab, nt1, f, eslot, cslot, vslot, np,
                                    rows, nrows, p, w);
  return static_cast<int>(cudaGetLastError());
}

// the launch of every slot's row, or with rows of those nrows slots'
template <typename T, bool EFLAG, bool VFLAG>
int launch_one(long long np, const long long* rows, long long nrows,
               const T* x, const T* q, const int* type, const int* pairs,
               const int* npairs, int K, const T* lengths, const T* ljtab,
               int nt1, T* f, T* eslot, T* cslot, T* vslot,
               const Params<T>& p, const Weights<T>& w, cudaStream_t s) {
  if (rows != nullptr) {
    return launch_rows<T, EFLAG, VFLAG, true>(np, rows, nrows, x, q, type,
                                              pairs, npairs, K, lengths,
                                              ljtab, nt1, f, eslot, cslot,
                                              vslot, p, w, s);
  }
  return launch_rows<T, EFLAG, VFLAG, false>(np, rows, nrows, x, q, type,
                                             pairs, npairs, K, lengths, ljtab,
                                             nt1, f, eslot, cslot, vslot, p,
                                             w, s);
}

template <typename T>
int launch(const T* x, const T* q, const int* type, const int* pairs,
           const int* npairs, int K, long long np, const long long* rows,
           long long nrows, const T* lengths,
           const T* ljtab, int nt1, T* f, T* eslot, T* cslot, T* vslot,
           double qqrd2e, double g_ewald, double cut_coulsq, double cut_ljsq,
           double cut_lj_innersq, double denom_lj, const double* wts,
           int eflag, int vflag, void* stream) {
  if (np < 1 || K < 1 || nt1 < 2 ||
      (rows != nullptr && (nrows < 1 || nrows > np))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params<T> p{T(qqrd2e), T(g_ewald), T(cut_coulsq), T(cut_ljsq),
                    T(cut_lj_innersq), T(denom_lj)};
  Weights<T> w;
  for (int k = 0; k < 4; ++k) {
    w.lj[k] = T(wts[k]);
    w.coul[k] = T(wts[4 + k]);
  }
  if (eflag && vflag) {
    return launch_one<T, true, true>(np, rows, nrows, x, q, type, pairs,
                                     npairs, K, lengths, ljtab, nt1, f, eslot,
                                     cslot, vslot, p, w, s);
  }
  if (eflag) {
    return launch_one<T, true, false>(np, rows, nrows, x, q, type, pairs,
                                      npairs, K, lengths, ljtab, nt1, f,
                                      eslot, cslot, vslot, p, w, s);
  }
  if (vflag) {
    return launch_one<T, false, true>(np, rows, nrows, x, q, type, pairs,
                                      npairs, K, lengths, ljtab, nt1, f,
                                      eslot, cslot, vslot, p, w, s);
  }
  return launch_one<T, false, false>(np, rows, nrows, x, q, type, pairs,
                                     npairs, K, lengths, ljtab, nt1, f, eslot,
                                     cslot, vslot, p, w, s);
}

}  // namespace

// C interface, bound with ctypes by tpumd_torch/ops/charmm_cellgrid.py.
// wl0..wl3 and wc0..wc3 are the special_bonds weights by code; rows (nrows
// slots, int64) selects the owned-rows variant, nullptr every slot.
// Returns the CUDA error code of the launch (0 on success).
#define TPUMD_CHARMM_ENTRY(NAME, T)                                          \
  extern "C" int NAME(                                                       \
      const T* x, const T* q, const int* type, const int* pairs,             \
      const int* npairs, int K, long long np, const long long* rows,         \
      long long nrows, const T* lengths, const T* ljtab, int nt1, T* f,      \
      T* eslot, T* cslot, T* vslot,                                          \
      double qqrd2e, double g_ewald, double cut_coulsq, double cut_ljsq,     \
      double cut_lj_innersq, double denom_lj, double wl0, double wl1,        \
      double wl2, double wl3, double wc0, double wc1, double wc2,            \
      double wc3, int eflag, int vflag, void* stream) {                      \
    const double wts[8] = {wl0, wl1, wl2, wl3, wc0, wc1, wc2, wc3};         \
    return launch<T>(x, q, type, pairs, npairs, K, np, rows, nrows, lengths, \
                     ljtab, nt1, f, eslot, cslot, vslot, qqrd2e, g_ewald,    \
                     cut_coulsq, cut_ljsq, cut_lj_innersq, denom_lj, wts,    \
                     eflag, vflag, stream);                                  \
  }

TPUMD_CHARMM_ENTRY(tpumd_charmm_pairlist_f32, float)
TPUMD_CHARMM_ENTRY(tpumd_charmm_pairlist_f64, double)
