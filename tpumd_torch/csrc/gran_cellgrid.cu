// gran/hooke/history cell-grid forces, torques and compact contact history
// on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpumd/ops/pallas_gran.py::_kernel (entry
// gran_cellgrid_forces_pallas) and, where that kernel does not run
// (shearupdate off, f64, any cap), the XLA sweep
// tpumd/ops/cellgrid_gran.py::gran_compact_sums of the chute deck.
//
// Spheres sit in a (nz, ny, nx, cap) grid of fixed-capacity cells; x, v and
// omega are slot-ordered (slots, 3) arrays, radius, rmass (1 in empty
// slots), gmask, valid and tag are per slot, and each slot carries its
// compact history: stags (slots, KH) partner tags (0 = empty) and shear
// (slots, KH, 3).  Every valid slot i visits its candidates in tpumd's
// order: the z offsets in turn, then the y offsets, the x offsets and the j
// slots.  A periodic axis takes all three offsets, its wrap correction
// computed from the cell index (x_j + L where c+o >= n, - L where c+o < 0);
// a non-periodic axis takes none and drops the offsets that alias mod n
// (n = 2: -1, 0; n = 1: 0).  The self slot is skipped at offset (0,0,0)
// only.  A candidate j is in contact when valid, not excluded by a pair of
// group bits (EXCLUDE), and r2 < (r_i + r_j)^2, d = x_i - x_j.  Then, as
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
// With SHEARUPDATE the slot's k-th contact in visiting order writes its
// partner tag and shear into entry k of the new tables (entries from the
// contact count on are zeroed); a contact of rank KH or more still adds its
// force but loses its history, as in tpumd.  Without it the new tables are
// not written: the caller keeps the old ones.
//
// What bounds it: at the 32k chute shape (grid 18x9x12, cap 28) there are
// 54,432 slots and 27 * 28 = 756 candidates per slot, 4.1e7 candidate tests
// per call, of which ~0.5 % touch.  The inputs and the history tables are
// read and written once (~25 MB, ~7.5 us at the HBM rate); the candidate
// loop, a dozen operations per candidate from shared memory, takes the rest
// (0.165 ms measured on the H100).
//
// Design (B1's, tpumd_torch/csrc/lj_cellgrid.cu): one block per cell, one
// thread per i slot (cap rounded up to a warp).  For each neighbour cell
// the block stages coordinates with the wrap applied, velocity, angular
// velocity, radius, mass, group bits, tag and validity in shared memory;
// every thread then runs the candidate loop from shared memory.  A thread
// reads its own old history from global memory only at a contact, and
// writes only its own slot's new history, so no two threads touch the same
// words and no atomics are needed.

#include <cuda_runtime.h>

namespace {

constexpr int kKH = 12;        // history entries per slot (cellgrid_gran.KH)
constexpr int kMaxExcl = 4;    // neigh_modify exclude group pairs

__device__ __forceinline__ float sqrt_t(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_t(double a) { return sqrt(a); }
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }
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
  const T* lengths;
  T* f;
  T* torque;
  int* stags_new;
  T* shear_new;
  int nx, ny, nz, cap;
  int px, py, pz;           // periodic flags
  T kn, kt, gamman, gammat, xmu, dt;
  int freeze_bit;
  int nexcl;
  int eb1[kMaxExcl], eb2[kMaxExcl];
  int limit_damping, shearupdate;
};

// the stencil's offsets along one axis: [lo, hi]
__device__ __forceinline__ void axis_range(int n, int periodic, int* lo,
                                           int* hi) {
  *lo = -1;
  *hi = 1;
  if (!periodic && n < 3) {
    *hi = 0;
    if (n == 1) *lo = 0;
  }
}

// neighbour cell index along one axis and its wrap correction
template <typename T>
__device__ __forceinline__ int wrap(int c, int o, int n, int periodic, T L,
                                    T* shift) {
  int j = c + o;
  *shift = T(0);
  if (j >= n) {
    j -= n;
    if (periodic) *shift = L;
  } else if (j < 0) {
    j += n;
    if (periodic) *shift = -L;
  }
  return j;
}

template <typename T, bool SHEARUPDATE, bool FREEZE, bool EXCLUDE,
          bool LIMIT_DAMPING>
__global__ void gran_cellgrid_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cap = a.cap;
  T* sx = reinterpret_cast<T*>(smem_raw);  // cap each, 11 arrays
  T* sy = sx + cap;
  T* sz = sy + cap;
  T* svx = sz + cap;
  T* svy = svx + cap;
  T* svz = svy + cap;
  T* sox = svz + cap;
  T* soy = sox + cap;
  T* soz = soy + cap;
  T* srad = soz + cap;
  T* srm = srad + cap;
  int* sgm = reinterpret_cast<int*>(srm + cap);  // cap each, 3 arrays
  int* stag = sgm + cap;
  int* sval = stag + cap;

  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const int cell = blockIdx.x;
  const int cx = cell % nx;
  const int cy = (cell / nx) % ny;
  const int cz = cell / (nx * ny);
  const int t = threadIdx.x;
  const long long islot = static_cast<long long>(cell) * cap + t;
  const bool active = t < cap;
  const bool ivalid = active && a.valid[islot] != 0;

  T xi = T(0), yi = T(0), zi = T(0), vxi = T(0), vyi = T(0), vzi = T(0);
  T oxi = T(0), oyi = T(0), ozi = T(0), radi = T(0), rmi = T(1);
  int gmi = 0;
  if (active) {
    xi = a.x[3 * islot + 0];
    yi = a.x[3 * islot + 1];
    zi = a.x[3 * islot + 2];
    vxi = a.v[3 * islot + 0];
    vyi = a.v[3 * islot + 1];
    vzi = a.v[3 * islot + 2];
    oxi = a.omega[3 * islot + 0];
    oyi = a.omega[3 * islot + 1];
    ozi = a.omega[3 * islot + 2];
    radi = a.radius[islot];
    rmi = a.rmass[islot];
    if (FREEZE || EXCLUDE) gmi = a.gmask[islot];
  }
  const T Lx = a.lengths[0], Ly = a.lengths[1], Lz = a.lengths[2];
  const long long hbase = islot * kKH;

  T fx = T(0), fy = T(0), fz = T(0), tx = T(0), ty = T(0), tz = T(0);
  int count = 0;   // contacts met so far: the next history entry

  int zlo, zhi, ylo, yhi, xlo, xhi;
  axis_range(nz, a.pz, &zlo, &zhi);
  axis_range(ny, a.py, &ylo, &yhi);
  axis_range(nx, a.px, &xlo, &xhi);
  for (int oz = zlo; oz <= zhi; ++oz) {
    T shz;
    const int jz = wrap(cz, oz, nz, a.pz, Lz, &shz);
    for (int oy = ylo; oy <= yhi; ++oy) {
      T shy;
      const int jy = wrap(cy, oy, ny, a.py, Ly, &shy);
      for (int ox = xlo; ox <= xhi; ++ox) {
        T shx;
        const int jx = wrap(cx, ox, nx, a.px, Lx, &shx);
        const long long jbase =
            (static_cast<long long>(jz * ny + jy) * nx + jx) * cap;

        __syncthreads();  // the previous cell's tile is consumed
        for (int k = t; k < cap; k += blockDim.x) {
          const long long js = jbase + k;
          sx[k] = a.x[3 * js + 0] + shx;
          sy[k] = a.x[3 * js + 1] + shy;
          sz[k] = a.x[3 * js + 2] + shz;
          svx[k] = a.v[3 * js + 0];
          svy[k] = a.v[3 * js + 1];
          svz[k] = a.v[3 * js + 2];
          sox[k] = a.omega[3 * js + 0];
          soy[k] = a.omega[3 * js + 1];
          soz[k] = a.omega[3 * js + 2];
          srad[k] = a.radius[js];
          srm[k] = a.rmass[js];
          sgm[k] = (FREEZE || EXCLUDE) ? a.gmask[js] : 0;
          stag[k] = a.tag[js];
          sval[k] = a.valid[js];
        }
        __syncthreads();

        if (!ivalid) continue;
        const int self = (ox == 0 && oy == 0 && oz == 0) ? t : -1;
        for (int k = 0; k < cap; ++k) {
          if (!sval[k] || k == self) continue;
          const T dx = xi - sx[k];
          const T dy = yi - sy[k];
          const T dz = zi - sz[k];
          const T rsq = norm2_rn(dx, dy, dz);
          const T radj = srad[k];
          const T radsum = radi + radj;
          if (!(rsq < radsum * radsum)) continue;
          const int gmj = sgm[k];
          if (EXCLUDE) {
            bool excluded = false;
            for (int e = 0; e < a.nexcl; ++e) {
              const int b1 = a.eb1[e], b2 = a.eb2[e];
              excluded |= ((gmi & b1) && (gmj & b2)) ||
                          ((gmi & b2) && (gmj & b1));
            }
            if (excluded) continue;
          }

          const T r = sqrt_t(rsq);
          const T rinv = T(1) / r;
          const T rsqinv = T(1) / rsq;

          // relative velocity, its normal and tangential parts, and the
          // relative rotational velocity
          const T vr1 = vxi - svx[k];
          const T vr2 = vyi - svy[k];
          const T vr3 = vzi - svz[k];
          const T vnnr = vr1 * dx + vr2 * dy + vr3 * dz;
          const T vt1 = vr1 - dx * (vnnr * rsqinv);
          const T vt2 = vr2 - dy * (vnnr * rsqinv);
          const T vt3 = vr3 - dz * (vnnr * rsqinv);
          const T wr1 = (radi * oxi + radj * sox[k]) * rinv;
          const T wr2 = (radi * oyi + radj * soy[k]) * rinv;
          const T wr3 = (radi * ozi + radj * soz[k]) * rinv;

          // effective mass; a frozen sphere counts as infinitely heavy
          const T mj = srm[k];
          T meff = rmi * mj / (rmi + mj);
          if (FREEZE) {
            if (gmi & a.freeze_bit) meff = mj;
            if (gmj & a.freeze_bit) meff = rmi;
          }

          const T damp = meff * a.gamman * vnnr * rsqinv;
          T ccel = a.kn * (radsum - r) * rinv - damp;
          if (LIMIT_DAMPING) ccel = ccel > T(0) ? ccel : T(0);

          const T vtr1 = vt1 + (dy * wr3 - dz * wr2);
          const T vtr2 = vt2 + (dz * wr1 - dx * wr3);
          const T vtr3 = vt3 + (dx * wr2 - dy * wr1);

          // old shear: the i slot's entry holding this partner's tag
          const int tj = stag[k];
          T sh1 = T(0), sh2 = T(0), sh3 = T(0);
          for (int kk = 0; kk < kKH; ++kk) {
            const int st = a.stags_old[hbase + kk];
            if (st > 0 && st == tj) {
              const T* so = a.shear_old + 3 * (hbase + kk);
              sh1 += so[0];
              sh2 += so[1];
              sh3 += so[2];
            }
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
            if (count < kKH) {
              a.stags_new[hbase + count] = tj;
              T* sn = a.shear_new + 3 * (hbase + count);
              sn[0] = sh1;
              sn[1] = sh2;
              sn[2] = sh3;
            }
            ++count;
          }
        }
      }
    }
  }

  if (!active) return;
  a.f[3 * islot + 0] = fx;
  a.f[3 * islot + 1] = fy;
  a.f[3 * islot + 2] = fz;
  a.torque[3 * islot + 0] = tx;
  a.torque[3 * islot + 1] = ty;
  a.torque[3 * islot + 2] = tz;
  if (SHEARUPDATE) {
    for (int kk = count < kKH ? count : kKH; kk < kKH; ++kk) {
      a.stags_new[hbase + kk] = 0;
      T* sn = a.shear_new + 3 * (hbase + kk);
      sn[0] = T(0);
      sn[1] = T(0);
      sn[2] = T(0);
    }
  }
}

template <typename T, bool S, bool F, bool E, bool L>
int launch_one(const Args<T>& a, cudaStream_t s) {
  const dim3 grid(a.nx * a.ny * a.nz);
  const dim3 block(((a.cap + 31) / 32) * 32);
  const size_t smem = static_cast<size_t>(a.cap) * (11 * sizeof(T) +
                                                    3 * sizeof(int));
  auto kernel = gran_cellgrid_kernel<T, S, F, E, L>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, block, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool S, bool F, bool E>
int pick_limit(const Args<T>& a, cudaStream_t s) {
  return a.limit_damping ? launch_one<T, S, F, E, true>(a, s)
                         : launch_one<T, S, F, E, false>(a, s);
}

template <typename T, bool S, bool F>
int pick_exclude(const Args<T>& a, cudaStream_t s) {
  return a.nexcl ? pick_limit<T, S, F, true>(a, s)
                 : pick_limit<T, S, F, false>(a, s);
}

template <typename T, bool S>
int pick_freeze(const Args<T>& a, cudaStream_t s) {
  return a.freeze_bit ? pick_exclude<T, S, true>(a, s)
                      : pick_exclude<T, S, false>(a, s);
}

template <typename T>
int launch(const Args<T>& a, cudaStream_t s) {
  if (a.nx < 1 || a.ny < 1 || a.nz < 1 || a.cap < 1 || a.cap > 1024 ||
      a.nexcl < 0 || a.nexcl > kMaxExcl) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return a.shearupdate ? pick_freeze<T, true>(a, s)
                       : pick_freeze<T, false>(a, s);
}

}  // namespace

// C interface, bound with ctypes by tpumd_torch/ops/gran_cellgrid.py.
// periodic: px, py, pz; excl: nexcl (b1, b2) group-bit pairs, flattened.
// stags_new and shear_new are written only with shearupdate.  Returns the
// CUDA error code of the launch (0 on success).
#define TPUMD_GRAN_ENTRY(NAME, T)                                            \
  extern "C" int NAME(                                                       \
      const T* x, const T* v, const T* omega, const T* radius,               \
      const T* rmass, const int* gmask, const unsigned char* valid,          \
      const int* tag, const int* stags_old, const T* shear_old,              \
      const T* lengths, T* f, T* torque, int* stags_new, T* shear_new,       \
      int nx, int ny, int nz, int cap, int px, int py, int pz, double kn,    \
      double kt, double gamman, double gammat, double xmu, double dt,        \
      int freeze_bit, int nexcl, const int* excl, int limit_damping,         \
      int shearupdate, void* stream) {                                       \
    if (nexcl < 0 || nexcl > kMaxExcl) {                                     \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    }                                                                        \
    Args<T> a{x, v, omega, radius, rmass, gmask, valid, tag, stags_old,      \
              shear_old, lengths, f, torque, stags_new, shear_new, nx, ny,   \
              nz, cap, px, py, pz, T(kn), T(kt), T(gamman), T(gammat),       \
              T(xmu), T(dt), freeze_bit, nexcl, {0}, {0}, limit_damping,     \
              shearupdate};                                                  \
    for (int e = 0; e < nexcl; ++e) {                                        \
      a.eb1[e] = excl[2 * e];                                                \
      a.eb2[e] = excl[2 * e + 1];                                            \
    }                                                                        \
    return launch<T>(a, static_cast<cudaStream_t>(stream));                  \
  }

TPUMD_GRAN_ENTRY(tpumd_gran_cellgrid_f32, float)
TPUMD_GRAN_ENTRY(tpumd_gran_cellgrid_f64, double)
