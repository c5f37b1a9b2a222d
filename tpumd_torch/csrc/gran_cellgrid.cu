// gran/hooke/history forces, torques and compact contact history over the
// cell grid's pair list, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpumd/ops/pallas_gran.py::_kernel (entry
// gran_cellgrid_forces_pallas) and, where that kernel does not run
// (shearupdate off, f64, any cap), the XLA sweep
// tpumd/ops/cellgrid_gran.py::gran_compact_sums of the chute deck.  The
// TPU kernel tested the 27-cell stencil at each call; here the candidate
// search runs once per re-bin (cellgrid_pairlist.cu, with the
// neigh_modify exclude pairs dropped) and this kernel sweeps its list.
//
// Spheres sit in grid-slot order: x, v and omega (slots, 3), radius, rmass
// (1 in empty slots), gmask, valid and tag per slot, and each slot's
// compact history: stags (slots, KH) partner tags (0 = empty) and shear
// (slots, KH, 3).  pairs (slots, K) holds each slot's list entries
// j | code << 30 in stencil order and npairs its count; rows (natoms,)
// names the valid slots (the grid state's tag -> slot map), the only ones
// swept.  Every valid slot i walks its row in order; an entry j is in
// contact when r2 < (r_i + r_j)^2, d = x_i - (x_j + s), s = L rint((x_i -
// x_j) / L) on the periodic axes and 0 on the others (the minimum image of
// the current box, rounded as the stencil rounds x_i - (x_j + L), |d|^2
// without contraction, as the plain version computes both).  Then, as
// PairGranHookeHistory::compute (src/GRANULAR/pair_gran_hooke_history.cpp
// :169-380) and tpumd:
//   meff = m_i m_j / (m_i + m_j), or the other's mass when one is frozen
//     (FREEZE: gmask & freeze_bit);
//   ccel = kn (r_i + r_j - r) / r - meff gamman (v_r . d) / r2, clamped at 0
//     with LIMIT_DAMPING;
//   vtr = the tangential relative velocity at the contact, rotation
//     included;
//   shear = the i slot's history entry whose tag is tag_j (0 when none);
//     with SHEARUPDATE it advances by vtr dt and loses its normal part;
//   fs = -(kt shear + meff gammat vtr), rescaled to xmu |ccel r| when
//     longer (the shear then rescaled to match where it is non-zero, and
//     the force zeroed where it is zero);
//   f_i += d ccel + fs,  torque_i -= r_i (d x fs) / r.
// With SHEARUPDATE the slot's k-th contact along its row writes its
// partner tag and shear into entry k of the new tables (entries from the
// contact count on are zeroed); the row runs in stencil order, so the
// ranks are the stencil sweep's, and a contact of rank KH or more still
// adds its force but loses its history, as in tpumd.  Without it the new
// tables are not written: the caller keeps the old ones.  Empty slots get
// zero forces, torques and (with SHEARUPDATE) history.
//
// What bounds it: at the 32k chute shape (54,432 slots, 32,000 spheres, K
// 16, ~11 list entries a row, ~3.9 contacts a sphere) the inputs and the
// history tables, read and written once, are ~25 MB, ~7.5 us at the HBM
// rate; the contacts' arithmetic (~1.3e5 contacts x ~160 operations) is
// far less.  The list (~1.4 MB) adds little.  The stencil design tested
// 756 candidates a slot, one thread per slot, 41 % of them empty.
//
// Design: kLanes lanes per valid atom (chosen on the card by
// probes/pairlist_lanes.py: PERF.md).  The lanes of an atom read its old
// history tags once, into registers, and walk its row kLanes entries a
// step; a ballot over the atom's lanes gives the step's contacts and
// __popc of the lanes below each contact's rank after the atom's running
// count.  A contact finds its old shear among the registers and reads only
// that entry.  The lanes' forces and torques meet by shuffles within the
// atom's lanes.  The threads also zero the empty slots' outputs, so the
// wrapper allocates nothing it must clear.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 8;      // lanes per atom
constexpr int kBlock = 128;
constexpr int kKH = 12;        // history entries per slot (cellgrid_gran.KH)
constexpr unsigned kNeighMask = (1u << 30) - 1u;

static_assert(kLanes >= 1 && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0,
              "kLanes must be a power of two up to a warp");

__device__ __forceinline__ float sqrt_t(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_t(double a) { return sqrt(a); }
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }
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
// |d|^2 rounded as the plain version rounds it (three products, two sums,
// no fused multiply-add), so both find the same contacts
__device__ __forceinline__ float norm2_rn(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                   __fmul_rn(c, c));
}
__device__ __forceinline__ double norm2_rn(double a, double b, double c) {
  return __dadd_rn(__dadd_rn(__dmul_rn(a, a), __dmul_rn(b, b)),
                   __dmul_rn(c, c));
}

// x_i - (x_j + s), s the image correction on a periodic axis of length L
// or none, each step rounded as the plain version rounds it
template <typename T>
__device__ __forceinline__ T image_d(T xi, T xj, int periodic, T L) {
  T s = T(0);
  if (periodic) s = L * rint_t(sub_rn(xi, xj) / L);
  return sub_rn(xi, add_rn(xj, s));
}

template <typename T>
struct Args {
  const T* x;
  const T* v;
  const T* omega;
  const T* radius;
  const T* rmass;
  const int* gmask;
  const unsigned char* valid;
  const int* tag;
  const int* stags_old;
  const T* shear_old;
  const int* pairs;
  const int* npairs;
  const long long* rows;
  const T* lengths;
  T* f;
  T* torque;
  int* stags_new;
  T* shear_new;
  long long np, natoms;
  int K;
  int px, py, pz;           // periodic flags
  T kn, kt, gamman, gammat, xmu, dt;
  int freeze_bit;
  int limit_damping, shearupdate;
};

template <typename T, bool SHEARUPDATE>
__device__ __forceinline__ void zero_slot(const Args<T>& a, long long s) {
  for (int c = 0; c < 3; ++c) {
    a.f[3 * s + c] = T(0);
    a.torque[3 * s + c] = T(0);
  }
  if (SHEARUPDATE) {
    for (int kk = 0; kk < kKH; ++kk) {
      a.stags_new[s * kKH + kk] = 0;
      for (int c = 0; c < 3; ++c) a.shear_new[3 * (s * kKH + kk) + c] = T(0);
    }
  }
}

// the sum of v over the kLanes lanes of an atom, in each of them
template <typename T>
__device__ __forceinline__ T lanes_sum(T v, unsigned mask) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    v += __shfl_xor_sync(mask, v, o, kLanes);
  }
  return v;
}

template <typename T, bool SHEARUPDATE, bool FREEZE, bool LIMIT_DAMPING>
__global__ void __launch_bounds__(kBlock) gran_pairlist_kernel(
    const Args<T> a) {
  // the empty slots' outputs, by every thread of the grid in turn
  const long long tid =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * kBlock;
  for (long long s = tid; s < a.np; s += nthreads) {
    if (!a.valid[s]) zero_slot<T, SHEARUPDATE>(a, s);
  }

  const long long g = tid / kLanes;   // the atom of these lanes
  if (g >= a.natoms) return;          // the atom's lanes alike
  const int lane = threadIdx.x % kLanes;
  const int base = (threadIdx.x & 31) & ~(kLanes - 1);
  const unsigned mask = (0xffffffffu >> (32 - kLanes)) << base;
  const long long i = a.rows[g];

  const T xi = a.x[3 * i + 0], yi = a.x[3 * i + 1], zi = a.x[3 * i + 2];
  const T vxi = a.v[3 * i + 0], vyi = a.v[3 * i + 1], vzi = a.v[3 * i + 2];
  const T oxi = a.omega[3 * i + 0], oyi = a.omega[3 * i + 1],
          ozi = a.omega[3 * i + 2];
  const T radi = a.radius[i], rmi = a.rmass[i];
  const int gmi = FREEZE ? a.gmask[i] : 0;
  const T Lx = a.lengths[0], Ly = a.lengths[1], Lz = a.lengths[2];
  const long long hbase = i * kKH;
  int old[kKH];   // the slot's old history tags, read once
#pragma unroll
  for (int kk = 0; kk < kKH; ++kk) old[kk] = a.stags_old[hbase + kk];

  T fx = T(0), fy = T(0), fz = T(0), tx = T(0), ty = T(0), tz = T(0);
  int count = 0;   // contacts met so far along the row
  const int* row = a.pairs + i * a.K;
  const int n = a.npairs[i];
  for (int k0 = 0; k0 < n; k0 += kLanes) {
    const int k = k0 + lane;
    long long j = 0;
    T dx = T(0), dy = T(0), dz = T(0), rsq = T(0), radj = T(0);
    bool contact = false;
    if (k < n) {
      j = static_cast<unsigned>(row[k]) & kNeighMask;
      dx = image_d(xi, a.x[3 * j + 0], a.px, Lx);
      dy = image_d(yi, a.x[3 * j + 1], a.py, Ly);
      dz = image_d(zi, a.x[3 * j + 2], a.pz, Lz);
      rsq = norm2_rn(dx, dy, dz);
      radj = a.radius[j];
      const T radsum = radi + radj;
      contact = rsq < radsum * radsum;
    }
    const unsigned m = __ballot_sync(mask, contact) >> base;
    if (contact) {
      const T radsum = radi + radj;
      const T r = sqrt_t(rsq);
      const T rinv = T(1) / r;
      const T rsqinv = T(1) / rsq;

      // relative velocity, its normal and tangential parts, and the
      // relative rotational velocity
      const T vr1 = vxi - a.v[3 * j + 0];
      const T vr2 = vyi - a.v[3 * j + 1];
      const T vr3 = vzi - a.v[3 * j + 2];
      const T vnnr = vr1 * dx + vr2 * dy + vr3 * dz;
      const T vt1 = vr1 - dx * (vnnr * rsqinv);
      const T vt2 = vr2 - dy * (vnnr * rsqinv);
      const T vt3 = vr3 - dz * (vnnr * rsqinv);
      const T wr1 = (radi * oxi + radj * a.omega[3 * j + 0]) * rinv;
      const T wr2 = (radi * oyi + radj * a.omega[3 * j + 1]) * rinv;
      const T wr3 = (radi * ozi + radj * a.omega[3 * j + 2]) * rinv;

      // effective mass; a frozen sphere counts as infinitely heavy
      const T mj = a.rmass[j];
      T meff = rmi * mj / (rmi + mj);
      if (FREEZE) {
        const int gmj = a.gmask[j];
        if (gmi & a.freeze_bit) meff = mj;
        if (gmj & a.freeze_bit) meff = rmi;
      }

      const T damp = meff * a.gamman * vnnr * rsqinv;
      T ccel = a.kn * (radsum - r) * rinv - damp;
      if (LIMIT_DAMPING) ccel = ccel > T(0) ? ccel : T(0);

      const T vtr1 = vt1 + (dy * wr3 - dz * wr2);
      const T vtr2 = vt2 + (dz * wr1 - dx * wr3);
      const T vtr3 = vt3 + (dx * wr2 - dy * wr1);

      // old shear: the i slot's entry holding this partner's tag (a row
      // names each partner once, so at most one entry matches)
      const int tj = a.tag[j];
      int hit = -1;
#pragma unroll
      for (int kk = 0; kk < kKH; ++kk) {
        if (old[kk] > 0 && old[kk] == tj) hit = kk;
      }
      T sh1 = T(0), sh2 = T(0), sh3 = T(0);
      if (hit >= 0) {
        const T* so = a.shear_old + 3 * (hbase + hit);
        sh1 = so[0];
        sh2 = so[1];
        sh3 = so[2];
      }
      if (SHEARUPDATE) {
        sh1 += vtr1 * a.dt;
        sh2 += vtr2 * a.dt;
        sh3 += vtr3 * a.dt;
      }
      const T shrmag = sqrt_t(sh1 * sh1 + sh2 * sh2 + sh3 * sh3);
      if (SHEARUPDATE) {
        const T rsht = (sh1 * dx + sh2 * dy + sh3 * dz) * rsqinv;
        sh1 -= dx * rsht;
        sh2 -= dy * rsht;
        sh3 -= dz * rsht;
      }

      // tangential force: shear spring and tangential damping,
      // rescaled to the Coulomb limit when slipping
      const T gt = meff * a.gammat;
      T fs1 = -(a.kt * sh1 + gt * vtr1);
      T fs2 = -(a.kt * sh2 + gt * vtr2);
      T fs3 = -(a.kt * sh3 + gt * vtr3);
      const T fs = sqrt_t(fs1 * fs1 + fs2 * fs2 + fs3 * fs3);
      const T fn = a.xmu * abs_t(ccel * r);
      if (fs > fn) {
        const T ratio = fn / (fs > T(0) ? fs : T(1));
        if (shrmag != T(0)) {
          if (SHEARUPDATE) {
            const bool kt0 = a.kt == T(0);
            const T d1 = kt0 ? T(0) : gt * vtr1 / a.kt;
            const T d2 = kt0 ? T(0) : gt * vtr2 / a.kt;
            const T d3 = kt0 ? T(0) : gt * vtr3 / a.kt;
            sh1 = ratio * (sh1 + d1) - d1;
            sh2 = ratio * (sh2 + d2) - d2;
            sh3 = ratio * (sh3 + d3) - d3;
          }
          fs1 *= ratio;
          fs2 *= ratio;
          fs3 *= ratio;
        } else {
          fs1 = fs2 = fs3 = T(0);
        }
      }

      fx += dx * ccel + fs1;
      fy += dy * ccel + fs2;
      fz += dz * ccel + fs3;
      const T tor1 = (dy * fs3 - dz * fs2) * rinv;
      const T tor2 = (dz * fs1 - dx * fs3) * rinv;
      const T tor3 = (dx * fs2 - dy * fs1) * rinv;
      tx -= radi * tor1;
      ty -= radi * tor2;
      tz -= radi * tor3;

      if (SHEARUPDATE) {
        const int rank = count + __popc(m & ((1u << lane) - 1u));
        if (rank < kKH) {
          a.stags_new[hbase + rank] = tj;
          T* sn = a.shear_new + 3 * (hbase + rank);
          sn[0] = sh1;
          sn[1] = sh2;
          sn[2] = sh3;
        }
      }
    }
    count += __popc(m);
  }

  fx = lanes_sum(fx, mask);
  fy = lanes_sum(fy, mask);
  fz = lanes_sum(fz, mask);
  tx = lanes_sum(tx, mask);
  ty = lanes_sum(ty, mask);
  tz = lanes_sum(tz, mask);
  if (lane == 0) {
    a.f[3 * i + 0] = fx;
    a.f[3 * i + 1] = fy;
    a.f[3 * i + 2] = fz;
    a.torque[3 * i + 0] = tx;
    a.torque[3 * i + 1] = ty;
    a.torque[3 * i + 2] = tz;
  }
  if (SHEARUPDATE) {
    for (int kk = (count < kKH ? count : kKH) + lane; kk < kKH;
         kk += kLanes) {
      a.stags_new[hbase + kk] = 0;
      T* sn = a.shear_new + 3 * (hbase + kk);
      sn[0] = T(0);
      sn[1] = T(0);
      sn[2] = T(0);
    }
  }
}

template <typename T, bool S, bool F, bool L>
int launch_one(const Args<T>& a, cudaStream_t s) {
  // one group of kLanes threads per atom, and at least enough threads to
  // zero the empty slots in a few passes
  long long threads = a.natoms * kLanes;
  if (threads < 1) threads = 1;
  const dim3 grid(static_cast<unsigned>((threads + kBlock - 1) / kBlock));
  gran_pairlist_kernel<T, S, F, L><<<grid, kBlock, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool S, bool F>
int pick_limit(const Args<T>& a, cudaStream_t s) {
  return a.limit_damping ? launch_one<T, S, F, true>(a, s)
                         : launch_one<T, S, F, false>(a, s);
}

template <typename T, bool S>
int pick_freeze(const Args<T>& a, cudaStream_t s) {
  return a.freeze_bit ? pick_limit<T, S, true>(a, s)
                      : pick_limit<T, S, false>(a, s);
}

template <typename T>
int launch(const Args<T>& a, cudaStream_t s) {
  if (a.np < 1 || a.natoms < 0 || a.natoms > a.np || a.K < 1 ||
      (a.freeze_bit && a.gmask == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return a.shearupdate ? pick_freeze<T, true>(a, s)
                       : pick_freeze<T, false>(a, s);
}

}  // namespace

// C interface, bound with ctypes by tpumd_torch/ops/gran_cellgrid.py.
// periodic: px, py, pz; gmask may be null without a freeze bit.
// stags_new and shear_new are written only with shearupdate.  Returns the
// CUDA error code of the launch (0 on success).
#define TPUMD_GRAN_ENTRY(NAME, T)                                            \
  extern "C" int NAME(                                                       \
      const T* x, const T* v, const T* omega, const T* radius,               \
      const T* rmass, const int* gmask, const unsigned char* valid,          \
      const int* tag, const int* stags_old, const T* shear_old,              \
      const int* pairs, const int* npairs, const long long* rows,            \
      const T* lengths, T* f, T* torque, int* stags_new, T* shear_new,       \
      long long np, long long natoms, int K, int px, int py, int pz,         \
      double kn, double kt, double gamman, double gammat, double xmu,        \
      double dt, int freeze_bit, int limit_damping, int shearupdate,         \
      void* stream) {                                                        \
    const Args<T> a{x, v, omega, radius, rmass, gmask, valid, tag,           \
                    stags_old, shear_old, pairs, npairs, rows, lengths, f,   \
                    torque, stags_new, shear_new, np, natoms, K, px, py, pz, \
                    T(kn), T(kt), T(gamman), T(gammat), T(xmu), T(dt),       \
                    freeze_bit, limit_damping, shearupdate};                 \
    return launch<T>(a, static_cast<cudaStream_t>(stream));                  \
  }

TPUMD_GRAN_ENTRY(tpumd_gran_cellgrid_f32, float)
TPUMD_GRAN_ENTRY(tpumd_gran_cellgrid_f64, double)
