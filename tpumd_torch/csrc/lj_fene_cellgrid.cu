// LJ (B1) and LJ + FENE bond (B2) forces, energies and virial over the
// cell grid's pair list, on Hopper (sm_90a): one kernel, instantiated
// with bonds for B2 and without for B1, each with its own lanes per atom,
// and B1's special-weighted variant (SPECIAL) for lj/cut beside per-tuple
// bonded styles.
//
// B2 replaces the Pallas TPU kernel tpumd/ops/pallas_lj.py::_kernel_fene
// (entry lj_fene_cellgrid_forces_pallas) and, on energy/virial steps, the
// XLA sweep tpumd/ops/cellgrid.py::cellgrid_pair_sums(bond=...) of the
// chain deck: single-type lj/cut plus one FENE bond type (special_bonds
// fene: the special list is exactly the bond partners at weight 0, so a
// bonded pair takes only the bond force).  B1 replaces ::_kernel (entry
// lj_cellgrid_forces_pallas) and the XLA sweep of in.lj's thermo steps:
// single-type lj/cut alone.  The TPU kernels tested the 27-cell stencil at
// each call (and matched partners by tag); here the candidate search runs
// once per re-bin (cellgrid_pairlist.cu, the bond partners coded 1; in.lj,
// which re-bins every 20 steps unchecked, refreshes its list wherever
// some atom moved more than skin/2 since the list's build) and this
// kernel sweeps its list, the bonds coming from each slot's partner
// slots.
//
// Atoms sit in grid-slot order: x (slots, 3), valid per slot; pairs
// (slots, K) holds each slot's list entries j | code << 30 and npairs its
// count; bslots (slots, nb) the slots of its bond partners (nb <= 2, -1 =
// none), mapped from the partner tags at each re-bin; rows (natoms,) names
// the valid slots (the grid state's tag -> slot map), the only ones swept.
// With d = x_i - (x_j + s), s = L rint((x_i - x_j) / L) (the minimum image
// of the current box, rounded as the stencil rounds x_i - (x_j + L)),
// every valid slot i sums
//   over its code-0 entries with r2 < cutsq (a code-1 entry, a bond
//     partner, weighs 0 as factor_lj does):
//     fpair = r^-6 (lj1 r^-6 - lj2) r^-2;
//   or, in the SPECIAL variant, over every entry with r2 < cutsq, an entry
//     of code c (a 1-2, 1-3 or 1-4 pair) weighed factor_lj = s_c, the
//     special_bonds lj weight (as pair_lj_cut.cpp does; an entry of weight
//     0 adds nothing and is passed over):
//     fpair = s_c r^-6 (lj1 r^-6 - lj2) r^-2,
//     energy s_c (r^-6 (lj3 r^-6 - lj4) - offset);
//   over its partner slots, whatever their distance (bond_fene accepts a
//     bond up to 2 R0, beyond cutneigh):
//     fpair = -k / max(1 - r2/R0^2, 0.1)
//             + [r2 < 2^(1/3) sig^2] 48 eps sr6 (sr6 - 0.5) / r2;
// f_i = sum_j d fpair.  With EFLAG each slot writes its lj energy and its
// bond energy, with VFLAG the six components sum_j fpair d_a d_b over both
// terms; the caller halves their sums.  Empty slots get zeros.
//
// What bounds it: at the 32k chain shape (53,240 slots, 32,000 atoms, K
// 24, ~12.5 list entries a row, ~5 in the 1.12 sigma cutoff, 2 bonds) the
// inputs and outputs, read and written once, are ~2 MB, ~0.6 us at the
// HBM rate; the list adds ~1.8 MB a call, a floor of this design.  At the
// 32k in.lj shape (53,240 slots, K 112, ~78 entries a row, ~55 within
// 2.5 sigma) the work's bytes are ~1.3 MB and its arithmetic ~0.9 M pairs
// x 28 operations, ~0.4 us; the list adds ~10 MB, ~3 us.  The stencil
// designs tested 1,080 candidates a slot, 2-5 % in range.  The SPECIAL
// variant replaces no TPU kernel of its own: tpumd weighs special pairs on
// the grid in its XLA sweep (tpumd/ops/cellgrid.py:326-400, special=,
// from tpumd/models/pair_lj_cut.py:127,156) and its Pallas kernel
// (pallas_lj.py::_kernel) takes none; it is B1 with one table lookup
// more.  At IN_HYB32K's grid shape (32,000 atoms, lj/cut 8.0 A, ~122 list
// entries and ~63 in range an atom) the list is ~15.7 MB a call, a floor
// near 5 us; the arithmetic (~2.0 M pairs) is under 1 us.
//
// Design: LANES lanes per valid atom (kLanes for B2, kLanesLJ for B1,
// chosen on the card by probes/pairlist_lanes.py: PERF.md).  Lane l of an
// atom walks entries l, l + LANES, ... of its row and takes bond l, l +
// LANES, ...; the lanes' sums meet by shuffles within the atom's lanes,
// and its first lane writes them.  The threads also zero the empty slots'
// outputs.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 4;      // lanes per atom of B2 (with bonds)
constexpr int kLanesLJ = 16;   // lanes per atom of B1 (lj/cut alone)
constexpr int kBlock = 128;
constexpr unsigned kNeighMask = (1u << 30) - 1u;

static_assert(kLanes >= 1 && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0,
              "kLanes must be a power of two up to a warp");
static_assert(kLanesLJ >= 1 && kLanesLJ <= 32 &&
                  (kLanesLJ & (kLanesLJ - 1)) == 0,
              "kLanesLJ must be a power of two up to a warp");

__device__ __forceinline__ float log_t(float a) { return logf(a); }
__device__ __forceinline__ double log_t(double a) { return log(a); }
__device__ __forceinline__ float rint_t(float a) { return rintf(a); }
__device__ __forceinline__ double rint_t(double a) { return rint(a); }
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
// |d|^2 rounded as the plain version rounds it (no fused multiply-add),
// so both take the same pairs inside the cutoff
__device__ __forceinline__ float norm2_rn(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                   __fmul_rn(c, c));
}
__device__ __forceinline__ double norm2_rn(double a, double b, double c) {
  return __dadd_rn(__dadd_rn(__dmul_rn(a, a), __dmul_rn(b, b)),
                   __dmul_rn(c, c));
}

// x_i - (x_j + s), s the image correction on an axis of length L, each
// step rounded as the plain version rounds it
template <typename T>
__device__ __forceinline__ T image_d(T xi, T xj, T L) {
  const T s = L * rint_t(sub_rn(xi, xj) / L);
  return sub_rn(xi, add_rn(xj, s));
}

template <typename T>
struct Coeffs {
  T lj1, lj2, lj3, lj4, offset, cutsq, fk, r0sq, feps, fsig2;
  T s1, s2, s3;  // the special_bonds lj weights of codes 1-3 (SPECIAL)
};

template <typename T>
struct Args {
  const T* x;
  const unsigned char* valid;
  const int* pairs;
  const int* npairs;
  const int* bslots;
  const long long* rows;
  const T* lengths;
  T* f;
  T* eslot;
  T* bslot;
  T* vslot;
  long long np, natoms;
  int K, nb;
  Coeffs<T> c;
};

// the sum of v over the LANES lanes of an atom, in each of them
template <int LANES, typename T>
__device__ __forceinline__ T lanes_sum(T v, unsigned mask) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) {
    v += __shfl_xor_sync(mask, v, o, LANES);
  }
  return v;
}

// BONDS: B2 (nb partner slots, the bond energy in bslot); without, B1;
// SPECIAL (B1 only): entries of code 1-3 weighed s1-s3
template <int LANES, bool BONDS, bool SPECIAL, typename T, bool EFLAG,
          bool VFLAG>
__global__ void __launch_bounds__(kBlock) lj_fene_pairlist_kernel(
    const Args<T> a) {
  // the empty slots' outputs, by every thread of the grid in turn
  const long long tid =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * kBlock;
  for (long long s = tid; s < a.np; s += nthreads) {
    if (a.valid[s]) continue;
    a.f[3 * s + 0] = T(0);
    a.f[3 * s + 1] = T(0);
    a.f[3 * s + 2] = T(0);
    if (EFLAG) {
      a.eslot[s] = T(0);
      if (BONDS) a.bslot[s] = T(0);
    }
    if (VFLAG) {
      for (int c = 0; c < 6; ++c) a.vslot[6 * s + c] = T(0);
    }
  }

  const long long g = tid / LANES;    // the atom of these lanes
  if (g >= a.natoms) return;          // the atom's lanes alike
  const int lane = threadIdx.x % LANES;
  const int base = (threadIdx.x & 31) & ~(LANES - 1);
  const unsigned mask = (0xffffffffu >> (32 - LANES)) << base;
  const int nb = BONDS ? a.nb : 0;
  const long long i = a.rows[g];
  const Coeffs<T>& c = a.c;

  const T xi = a.x[3 * i + 0], yi = a.x[3 * i + 1], zi = a.x[3 * i + 2];
  const T Lx = a.lengths[0], Ly = a.lengths[1], Lz = a.lengths[2];
  const T wca2 = T(1.2599210498948732) * c.fsig2;  // (2^(1/6) sigma)^2

  T fx = T(0), fy = T(0), fz = T(0), e = T(0), eb = T(0);
  T v0 = T(0), v1 = T(0), v2 = T(0), v3 = T(0), v4 = T(0), v5 = T(0);
  const int* row = a.pairs + i * a.K;
  const int n = a.npairs[i];
  // lj over the code-0 entries, then the bonds over the partner slots
  for (int k = lane; k < n + nb; k += LANES) {
    long long j;
    T w = T(1);
    const bool bond = BONDS && k >= n;
    if (bond) {
      j = a.bslots[i * a.nb + (k - n)];
      if (j < 0) continue;
    } else {
      const unsigned ent = static_cast<unsigned>(row[k]);
      const unsigned code = ent >> 30;
      if (code) {
        if (!SPECIAL) continue;
        w = code == 1u ? c.s1 : (code == 2u ? c.s2 : c.s3);
        if (w == T(0)) continue;
      }
      j = ent & kNeighMask;
    }
    const T dx = image_d(xi, a.x[3 * j + 0], Lx);
    const T dy = image_d(yi, a.x[3 * j + 1], Ly);
    const T dz = image_d(zi, a.x[3 * j + 2], Lz);
    const T r2 = norm2_rn(dx, dy, dz);
    T fpair;
    if (bond) {
      const T r2inv = T(1) / r2;
      T rlogarg = T(1) - r2 / c.r0sq;
      if (rlogarg < T(0.1)) rlogarg = T(0.1);
      fpair = -c.fk / rlogarg;
      if (EFLAG) eb += T(-0.5) * c.fk * c.r0sq * log_t(rlogarg);
      if (r2 < wca2) {
        const T sr2 = c.fsig2 * r2inv;
        const T sr6 = sr2 * sr2 * sr2;
        fpair += T(48) * c.feps * sr6 * (sr6 - T(0.5)) * r2inv;
        if (EFLAG) eb += T(4) * c.feps * sr6 * (sr6 - T(1)) + c.feps;
      }
    } else {
      if (!(r2 < c.cutsq)) continue;
      const T r2inv = T(1) / r2;
      const T r6inv = r2inv * r2inv * r2inv;
      fpair = r6inv * (c.lj1 * r6inv - c.lj2) * r2inv;
      if (SPECIAL) fpair *= w;
      if (EFLAG) {
        const T epair = r6inv * (c.lj3 * r6inv - c.lj4) - c.offset;
        e += SPECIAL ? epair * w : epair;
      }
    }
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

  fx = lanes_sum<LANES>(fx, mask);
  fy = lanes_sum<LANES>(fy, mask);
  fz = lanes_sum<LANES>(fz, mask);
  if (EFLAG) {
    e = lanes_sum<LANES>(e, mask);
    if (BONDS) eb = lanes_sum<LANES>(eb, mask);
  }
  if (VFLAG) {
    v0 = lanes_sum<LANES>(v0, mask);
    v1 = lanes_sum<LANES>(v1, mask);
    v2 = lanes_sum<LANES>(v2, mask);
    v3 = lanes_sum<LANES>(v3, mask);
    v4 = lanes_sum<LANES>(v4, mask);
    v5 = lanes_sum<LANES>(v5, mask);
  }
  if (lane != 0) return;
  a.f[3 * i + 0] = fx;
  a.f[3 * i + 1] = fy;
  a.f[3 * i + 2] = fz;
  if (EFLAG) {
    a.eslot[i] = e;
    if (BONDS) a.bslot[i] = eb;
  }
  if (VFLAG) {
    T* vo = a.vslot + 6 * i;
    vo[0] = v0; vo[1] = v1; vo[2] = v2; vo[3] = v3; vo[4] = v4; vo[5] = v5;
  }
}

template <int LANES, bool BONDS, bool SPECIAL, typename T, bool EFLAG,
          bool VFLAG>
int launch_one(const Args<T>& a, cudaStream_t s) {
  long long threads = a.natoms * LANES;
  if (threads < 1) threads = 1;
  const dim3 grid(static_cast<unsigned>((threads + kBlock - 1) / kBlock));
  lj_fene_pairlist_kernel<LANES, BONDS, SPECIAL, T, EFLAG, VFLAG>
      <<<grid, kBlock, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int LANES, bool BONDS, bool SPECIAL, typename T>
int launch(const Args<T>& a, int eflag, int vflag, cudaStream_t s) {
  if (a.np < 1 || a.natoms < 0 || a.natoms > a.np || a.K < 1 ||
      (BONDS ? (a.nb < 1 || a.nb > 2) : a.nb != 0) || (BONDS && SPECIAL)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (eflag && vflag) {
    return launch_one<LANES, BONDS, SPECIAL, T, true, true>(a, s);
  }
  if (eflag) return launch_one<LANES, BONDS, SPECIAL, T, true, false>(a, s);
  if (vflag) return launch_one<LANES, BONDS, SPECIAL, T, false, true>(a, s);
  return launch_one<LANES, BONDS, SPECIAL, T, false, false>(a, s);
}

}  // namespace

// C interface, bound with ctypes by tpumd_torch/ops/lj_fene_cellgrid.py
// (B2) and tpumd_torch/ops/lj_cellgrid.py (B1 and B1-special, whose
// entry takes the three weights more).  eslot, bslot may be null
// without eflag, vslot without vflag.  Each returns the CUDA error code of
// the launch (0 on success).
#define TPUMD_LJ_FENE_ENTRY(NAME, T)                                         \
  extern "C" int NAME(                                                       \
      const T* x, const unsigned char* valid, const int* pairs,              \
      const int* npairs, const int* bslots, const long long* rows,           \
      const T* lengths, T* f, T* eslot, T* bslot, T* vslot, long long np,    \
      long long natoms, int K, int nb, double lj1, double lj2, double lj3,   \
      double lj4, double offset, double cutsq, double fk, double r0sq,       \
      double feps, double fsig2, int eflag, int vflag, void* stream) {       \
    const Args<T> a{x, valid, pairs, npairs, bslots, rows, lengths, f,       \
                    eslot, bslot, vslot, np, natoms, K, nb,                  \
                    {T(lj1), T(lj2), T(lj3), T(lj4), T(offset), T(cutsq),    \
                     T(fk), T(r0sq), T(feps), T(fsig2), T(0), T(0), T(0)}};  \
    return launch<kLanes, true, false, T>(a, eflag, vflag,                   \
                                          static_cast<cudaStream_t>(stream)); \
  }

#define TPUMD_LJ_ENTRY(NAME, T)                                              \
  extern "C" int NAME(                                                       \
      const T* x, const unsigned char* valid, const int* pairs,              \
      const int* npairs, const long long* rows, const T* lengths, T* f,      \
      T* eslot, T* vslot, long long np, long long natoms, int K,             \
      double lj1, double lj2, double lj3, double lj4, double offset,         \
      double cutsq, int eflag, int vflag, void* stream) {                    \
    const Args<T> a{x, valid, pairs, npairs, nullptr, rows, lengths, f,      \
                    eslot, nullptr, vslot, np, natoms, K, 0,                 \
                    {T(lj1), T(lj2), T(lj3), T(lj4), T(offset), T(cutsq),    \
                     T(0), T(1), T(0), T(1), T(0), T(0), T(0)}};             \
    return launch<kLanesLJ, false, false, T>(                                \
        a, eflag, vflag, static_cast<cudaStream_t>(stream));                 \
  }

#define TPUMD_LJ_SPECIAL_ENTRY(NAME, T)                                      \
  extern "C" int NAME(                                                       \
      const T* x, const unsigned char* valid, const int* pairs,              \
      const int* npairs, const long long* rows, const T* lengths, T* f,      \
      T* eslot, T* vslot, long long np, long long natoms, int K,             \
      double lj1, double lj2, double lj3, double lj4, double offset,         \
      double cutsq, double s1, double s2, double s3, int eflag, int vflag,   \
      void* stream) {                                                        \
    const Args<T> a{x, valid, pairs, npairs, nullptr, rows, lengths, f,      \
                    eslot, nullptr, vslot, np, natoms, K, 0,                 \
                    {T(lj1), T(lj2), T(lj3), T(lj4), T(offset), T(cutsq),    \
                     T(0), T(1), T(0), T(1), T(s1), T(s2), T(s3)}};          \
    return launch<kLanesLJ, false, true, T>(                                 \
        a, eflag, vflag, static_cast<cudaStream_t>(stream));                 \
  }

TPUMD_LJ_FENE_ENTRY(tpumd_lj_fene_cellgrid_f32, float)
TPUMD_LJ_FENE_ENTRY(tpumd_lj_fene_cellgrid_f64, double)
TPUMD_LJ_ENTRY(tpumd_lj_cellgrid_f32, float)
TPUMD_LJ_ENTRY(tpumd_lj_cellgrid_f64, double)
TPUMD_LJ_SPECIAL_ENTRY(tpumd_lj_special_cellgrid_f32, float)
TPUMD_LJ_SPECIAL_ENTRY(tpumd_lj_special_cellgrid_f64, double)
