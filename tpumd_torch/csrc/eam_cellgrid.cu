// Single-element EAM on the cell grid on Hopper (sm_90a): the density pass
// and the force pass, both sweeps of the grid's pair list, two kernels
// launched one after the other on one stream.
//
// Replace the Pallas TPU kernels tpumd/ops/pallas_eam.py::_rho_kernel
// (entry eam_rho_pallas) and ::_force_kernel (entry eam_force_pallas), the
// one-hot matmul that evaluated F'(rho) between them
// (tpumd/models/pair_eam.py:211-219), and, on energy/virial steps, the XLA
// sweep of PairEAM.compute_cellgrid.  Where the TPU kernels evaluated
// Chebyshev fits of the radial functions (~3e-5 relative error), these
// read the exact spline tables of PairEAM::interpolate, as LAMMPS
// PairEAM::compute does.
//
// Atoms sit in a (nz, ny, nx, cap) grid of fixed-capacity cells; x is the
// slot-ordered (nz*ny*nx*cap, 3) array and valid marks real atoms.  Both
// passes walk the entries of i's row of the pair list (pairs, npairs;
// cellgrid_pairlist.cu, at cutneigh, built at every re-bin and refreshed
// where the schedule could leave it stale, so it holds every pair the
// stencil finds in range), with d = x_i - (x_j + s), s = L rint((x_i -
// x_j) / L) the minimum image rounded op by op as the stencil rounds x_i -
// (x_j + L), and sum over the entries with r2 < cutsq:
//   pass 1: rho_i = sum_j rho(r), then F'(rho_i) and, with EFLAG, F(rho_i)
//           + F'(rho_i) (rho_i - rhomax) when rho_i > rhomax;
//   pass 2: f_i = sum_j d fpair, fpair = -((F'_i + F'_j) rho'(r) +
//           phi'(r)) / r, phi = z2(r) / r, phi' = z2'(r) / r - phi / r;
//           with EFLAG the per-slot sum of phi, with VFLAG the six
//           components of sum_j fpair d_a d_b (the caller halves both).
// Empty slots get 0 in every output.
// A spline row is found as tpumd's _r_index does (pair_eam.py:425-430):
// p = r / dr + 1, m = int(p) clamped to [1, n-1], p = min(p - m, 1); the
// value is ((c3 p + c4) p + c5) p + c6, the derivative (c0 p + c1) p + c2.
// One element only: (F'_i + F'_j) rho'(r) equals LAMMPS's
// F'_i rho'_ji + F'_j rho'_ij only when one density function serves both.
//
// What bounds them: at the 32k in.eam shape (grid 12x12x12, cap 32) there
// are 55,296 slots; about 43 neighbours of an fcc site lie inside the
// 4.95 A cutoff.  The least work, those pairs' arithmetic and each input
// and output moved once (1.2-1.6 MB in f32), takes under a microsecond on
// an H100: pass 1 is bound by its bytes, pass 2 by its operations.  The
// list rows hold ~75 entries (cutneigh 5.95 A, K 108), ~57 % of them in
// range; reading the list, ~9.6 MB a pass, takes ~3 us at the HBM rate, a
// floor of this design.  PERF.md has the times and the bounds.
//
// Design of both passes (lanes per atom chosen on the card by
// probes/pairlist_lanes.py: PERF.md): kLanesRho or kLanesEAM lanes per
// valid atom, reached through rows (the valid slots), lane l walking
// entries l, l + lanes, ... of the atom's row, the lanes' sums meeting by
// shuffles; blocks stride over the atoms, as many as the card holds at
// once, and their threads also zero the empty slots' outputs.  Each block
// first stages in shared memory the table columns a pair reads, so an
// in-range pair reads its coefficients from there and not by dependent
// global loads: pass 1 rhor's four value columns, (nr + 1) x 4 values (8 KB
// in f32 at nr = 500); pass 2 rho' (rhor's three derivative columns) and
// all seven of z2r, (nr + 1) x 10 values (20 KB in f32, 40 KB in f64).
// Tables too large for a block's shared memory are read from global
// memory.  In pass 1 one lane of the atom then reads frho's row (once an
// atom, through the read-only cache) and writes F'(rho_i); in pass 2 F'_j
// is read once per entry.  Pass 1 writes F' of every slot before pass 2
// reads any: two launches on one stream, no grid-wide sync.

#include <cuda_runtime.h>

#include "device_limits.cuh"

namespace {

template <typename T>
__device__ __forceinline__ void spline_row(T v, T rdelta, int n, int& m,
                                           T& p) {
  p = v * rdelta + T(1);
  // clamp before the conversion, so no value beyond int's range converts;
  // min(int(p), n - 1) == int(min(p, n - 1)) since n - 1 is an integer
  m = static_cast<int>(p < T(n - 1) ? p : T(n - 1));
  m = m < 1 ? 1 : m;
  p = p - T(m);
  p = p < T(1) ? p : T(1);
}

template <typename T>
__device__ __forceinline__ T spline_value(const T* __restrict__ tab, int m,
                                          T p) {
  const T* c = tab + 7 * m;
  return ((__ldg(c + 3) * p + __ldg(c + 4)) * p + __ldg(c + 5)) * p +
         __ldg(c + 6);
}

template <typename T>
__device__ __forceinline__ T spline_derivative(const T* __restrict__ tab,
                                               int m, T p) {
  const T* c = tab + 7 * m;
  return (__ldg(c + 0) * p + __ldg(c + 1)) * p + __ldg(c + 2);
}

constexpr int kLanesRho = 4;     // lanes per atom of the density pass
constexpr int kLanesEAM = 4;     // lanes per atom of the force pass
constexpr int kBlock = 512;
constexpr int kRhoCols = 4;      // rho (rhor's value columns)
constexpr int kTabCols = 10;     // rho' (3 columns), then z2r (7)
constexpr unsigned kNeighMask = (1u << 30) - 1u;

static_assert(kLanesRho >= 1 && kLanesRho <= 32 &&
                  (kLanesRho & (kLanesRho - 1)) == 0,
              "kLanesRho must be a power of two up to a warp");
static_assert(kLanesEAM >= 1 && kLanesEAM <= 32 &&
                  (kLanesEAM & (kLanesEAM - 1)) == 0,
              "kLanesEAM must be a power of two up to a warp");

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

// the sum of v over the LANES lanes of an atom, in each of them
template <int LANES, typename T>
__device__ __forceinline__ T lanes_sum(T v, unsigned mask) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) {
    v += __shfl_xor_sync(mask, v, o, LANES);
  }
  return v;
}

// the lanes of a warp that serve one atom with this thread
template <int LANES>
__device__ __forceinline__ unsigned atom_mask() {
  const int base = (threadIdx.x & 31) & ~(LANES - 1);
  return (0xffffffffu >> (32 - LANES)) << base;
}

// the table columns cols of rows (nr + 1) into shared memory, col c of
// row m from tab[7 m + first + c] (or from tab2 past split)
template <typename T>
__device__ __forceinline__ void stage_table(T* dst, const T* tab,
                                            const T* tab2, int first,
                                            int split, int cols, int nr) {
  for (int k = threadIdx.x; k < (nr + 1) * cols; k += blockDim.x) {
    const int m = k / cols, col = k % cols;
    dst[k] = col < split ? tab[7 * m + first + col]
                         : tab2[7 * m + col - split];
  }
  __syncthreads();
}

template <typename T>
struct RhoArgs {
  const T* x;
  const unsigned char* valid;
  const int* pairs;
  const int* npairs;
  const long long* rows;
  const T* lengths;
  const T* rhor;
  const T* frho;
  T* rho;
  T* fp;
  T* eslot;
  long long np, natoms;
  int K, nr, nrho;
  T rdr, rdrho, rhomax, cutsq;
};

// SMEM: rhor's value columns staged in shared memory (else read from
// global memory)
template <int LANES, bool SMEM, typename T, bool EFLAG>
__global__ void __launch_bounds__(kBlock) eam_rho_pairlist_kernel(
    const RhoArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tab = reinterpret_cast<T*>(smem_raw);  // (nr + 1) rows of kRhoCols
  if (SMEM) stage_table(tab, a.rhor, a.rhor, 3, kRhoCols, kRhoCols, a.nr);
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long s = tid; s < a.np; s += nthreads) {
    if (a.valid[s]) continue;
    a.rho[s] = T(0);
    a.fp[s] = T(0);
    if (EFLAG) a.eslot[s] = T(0);
  }

  const int lane = threadIdx.x % LANES;
  const unsigned mask = atom_mask<LANES>();
  const T Lx = a.lengths[0], Ly = a.lengths[1], Lz = a.lengths[2];
  for (long long g = tid / LANES; g < a.natoms; g += nthreads / LANES) {
    const long long i = a.rows[g];
    const T xi = a.x[3 * i + 0], yi = a.x[3 * i + 1], zi = a.x[3 * i + 2];
    T rho = T(0);
    const int* row = a.pairs + i * a.K;
    const int n = a.npairs[i];
    for (int k = lane; k < n; k += LANES) {
      const long long j = static_cast<unsigned>(row[k]) & kNeighMask;
      const T dx = image_d(xi, a.x[3 * j + 0], Lx);
      const T dy = image_d(yi, a.x[3 * j + 1], Ly);
      const T dz = image_d(zi, a.x[3 * j + 2], Lz);
      const T r2 = norm2_rn(dx, dy, dz);
      if (!(r2 < a.cutsq)) continue;
      int m;
      T p;
      spline_row(sqrt(r2), a.rdr, a.nr, m, p);
      if (SMEM) {
        const T* c = tab + kRhoCols * m;
        rho += ((c[0] * p + c[1]) * p + c[2]) * p + c[3];
      } else {
        rho += spline_value(a.rhor, m, p);
      }
    }
    rho = lanes_sum<LANES>(rho, mask);
    if (lane != 0) continue;
    int m;
    T p;
    spline_row(rho, a.rdrho, a.nrho, m, p);
    const T fp = spline_derivative(a.frho, m, p);
    a.rho[i] = rho;
    a.fp[i] = fp;
    if (EFLAG) {
      T e = spline_value(a.frho, m, p);
      if (rho > a.rhomax) e += fp * (rho - a.rhomax);
      a.eslot[i] = e;
    }
  }
}

template <typename T>
struct ForceArgs {
  const T* x;
  const unsigned char* valid;
  const T* fp;
  const int* pairs;
  const int* npairs;
  const long long* rows;
  const T* lengths;
  const T* rhor;
  const T* z2r;
  T* f;
  T* eslot;
  T* vslot;
  long long np, natoms;
  int K, nr;
  T rdr, cutsq;
};

// SMEM: the tables staged in shared memory (else read from global memory)
template <int LANES, bool SMEM, typename T, bool EFLAG, bool VFLAG>
__global__ void __launch_bounds__(kBlock) eam_force_pairlist_kernel(
    const ForceArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tab = reinterpret_cast<T*>(smem_raw);  // (nr + 1) rows of kTabCols
  if (SMEM) stage_table(tab, a.rhor, a.z2r, 0, 3, kTabCols, a.nr);
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long s = tid; s < a.np; s += nthreads) {
    if (a.valid[s]) continue;
    a.f[3 * s + 0] = T(0);
    a.f[3 * s + 1] = T(0);
    a.f[3 * s + 2] = T(0);
    if (EFLAG) a.eslot[s] = T(0);
    if (VFLAG) {
      for (int c = 0; c < 6; ++c) a.vslot[6 * s + c] = T(0);
    }
  }

  const int lane = threadIdx.x % LANES;
  const unsigned mask = atom_mask<LANES>();
  const T Lx = a.lengths[0], Ly = a.lengths[1], Lz = a.lengths[2];
  for (long long g = tid / LANES; g < a.natoms; g += nthreads / LANES) {
    const long long i = a.rows[g];
    const T xi = a.x[3 * i + 0], yi = a.x[3 * i + 1], zi = a.x[3 * i + 2];
    const T fpi = a.fp[i];
    T fx = T(0), fy = T(0), fz = T(0), e = T(0);
    T v0 = T(0), v1 = T(0), v2 = T(0), v3 = T(0), v4 = T(0), v5 = T(0);
    const int* row = a.pairs + i * a.K;
    const int n = a.npairs[i];
    for (int k = lane; k < n; k += LANES) {
      const long long j = static_cast<unsigned>(row[k]) & kNeighMask;
      const T dx = image_d(xi, a.x[3 * j + 0], Lx);
      const T dy = image_d(yi, a.x[3 * j + 1], Ly);
      const T dz = image_d(zi, a.x[3 * j + 2], Lz);
      const T r2 = norm2_rn(dx, dy, dz);
      if (!(r2 < a.cutsq)) continue;
      const T fpj = a.fp[j];
      const T r = sqrt(r2);
      int m;
      T p;
      spline_row(r, a.rdr, a.nr, m, p);
      T rhop, z2, z2p;
      if (SMEM) {
        const T* c = tab + kTabCols * m;
        rhop = (c[0] * p + c[1]) * p + c[2];
        z2p = (c[3] * p + c[4]) * p + c[5];
        z2 = ((c[6] * p + c[7]) * p + c[8]) * p + c[9];
      } else {
        rhop = spline_derivative(a.rhor, m, p);
        z2 = spline_value(a.z2r, m, p);
        z2p = spline_derivative(a.z2r, m, p);
      }
      const T recip = T(1) / r;
      const T phi = z2 * recip;
      const T phip = z2p * recip - phi * recip;
      const T psip = (fpi + fpj) * rhop + phip;
      const T fpair = -psip * recip;
      fx += dx * fpair;
      fy += dy * fpair;
      fz += dz * fpair;
      if (EFLAG) e += phi;
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
    if (EFLAG) e = lanes_sum<LANES>(e, mask);
    if (VFLAG) {
      v0 = lanes_sum<LANES>(v0, mask);
      v1 = lanes_sum<LANES>(v1, mask);
      v2 = lanes_sum<LANES>(v2, mask);
      v3 = lanes_sum<LANES>(v3, mask);
      v4 = lanes_sum<LANES>(v4, mask);
      v5 = lanes_sum<LANES>(v5, mask);
    }
    if (lane != 0) continue;
    a.f[3 * i + 0] = fx;
    a.f[3 * i + 1] = fy;
    a.f[3 * i + 2] = fz;
    if (EFLAG) a.eslot[i] = e;
    if (VFLAG) {
      T* vo = a.vslot + 6 * i;
      vo[0] = v0; vo[1] = v1; vo[2] = v2; vo[3] = v3; vo[4] = v4; vo[5] = v5;
    }
  }
}

// Launch kernel on as many blocks as the card holds at once (or fewer,
// where the atoms' lanes take fewer), each staging its tables once: the
// card's count, found once per kernel, device and shared size (the
// launches run at every step, and the queries cost host time).
template <auto kernel, typename Args>
int launch_resident(const Args& a, long long threads, size_t smem, int dev,
                    cudaStream_t s) {
  static int resident = 0, on_dev = -1;
  static size_t for_smem = 0;
  if (dev != on_dev || smem != for_smem) {
    cudaError_t err;
    int nsm, per_sm;
    if ((smem > 48 * 1024 &&
         (err = cudaFuncSetAttribute(
              kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
              static_cast<int>(smem))) != cudaSuccess) ||
        (err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kBlock, smem)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    resident = per_sm * nsm;
    on_dev = dev;
    for_smem = smem;
  }
  long long blocks = (threads + kBlock - 1) / kBlock;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), kBlock, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool SMEM, typename T>
int launch_rho_flags(const RhoArgs<T>& a, size_t smem, int dev, int eflag,
                     cudaStream_t s) {
  const long long threads = a.natoms * kLanesRho;
  if (eflag) {
    return launch_resident<eam_rho_pairlist_kernel<kLanesRho, SMEM, T, true>>(
        a, threads, smem, dev, s);
  }
  return launch_resident<eam_rho_pairlist_kernel<kLanesRho, SMEM, T, false>>(
      a, threads, smem, dev, s);
}

template <typename T>
int launch_rho(const RhoArgs<T>& a, int eflag, void* stream) {
  if (a.np < 1 || a.natoms < 0 || a.natoms > a.np || a.K < 1 || a.nr < 2 ||
      a.nrho < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev, optin;
  const cudaError_t err = device_optin(&dev, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(a.nr + 1) * kRhoCols * sizeof(T);
  if (smem <= static_cast<size_t>(optin)) {
    return launch_rho_flags<true, T>(a, smem, dev, eflag, s);
  }
  return launch_rho_flags<false, T>(a, 0, dev, eflag, s);
}

template <bool SMEM, typename T, bool EFLAG, bool VFLAG>
int launch_force_one(const ForceArgs<T>& a, size_t smem, int dev,
                     cudaStream_t s) {
  return launch_resident<
      eam_force_pairlist_kernel<kLanesEAM, SMEM, T, EFLAG, VFLAG>>(
      a, a.natoms * kLanesEAM, smem, dev, s);
}

template <bool SMEM, typename T>
int launch_force_flags(const ForceArgs<T>& a, size_t smem, int dev,
                       int eflag, int vflag, cudaStream_t s) {
  if (eflag && vflag) {
    return launch_force_one<SMEM, T, true, true>(a, smem, dev, s);
  }
  if (eflag) return launch_force_one<SMEM, T, true, false>(a, smem, dev, s);
  if (vflag) return launch_force_one<SMEM, T, false, true>(a, smem, dev, s);
  return launch_force_one<SMEM, T, false, false>(a, smem, dev, s);
}

template <typename T>
int launch_force(const ForceArgs<T>& a, int eflag, int vflag, void* stream) {
  if (a.np < 1 || a.natoms < 0 || a.natoms > a.np || a.K < 1 || a.nr < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev, optin;
  const cudaError_t err = device_optin(&dev, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(a.nr + 1) * kTabCols * sizeof(T);
  if (smem <= static_cast<size_t>(optin)) {
    return launch_force_flags<true, T>(a, smem, dev, eflag, vflag, s);
  }
  return launch_force_flags<false, T>(a, 0, dev, eflag, vflag, s);
}

}  // namespace

// C interface, bound with ctypes by tpumd_torch/ops/eam_cellgrid.py.  Each
// returns the CUDA error code of its launch (0 on success); eslot and
// vslot may be null where the flag is off.
#define TPUMD_EAM_RHO_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const T* x, const unsigned char* valid,                \
                      const int* pairs, const int* npairs,                   \
                      const long long* rows, const T* lengths,               \
                      const T* rhor, const T* frho, T* rho, T* fp, T* eslot, \
                      long long np, long long natoms, int K, int nr,         \
                      int nrho, double rdr, double rdrho, double rhomax,     \
                      double cutsq, int eflag, void* stream) {               \
    const RhoArgs<T> a{x,      valid,  pairs,   npairs,    rows,   lengths,  \
                       rhor,   frho,   rho,     fp,        eslot,  np,       \
                       natoms, K,      nr,      nrho,      T(rdr), T(rdrho), \
                       T(rhomax), T(cutsq)};                                 \
    return launch_rho<T>(a, eflag, stream);                                  \
  }

TPUMD_EAM_RHO_ENTRY(tpumd_eam_rho_cellgrid_f32, float)
TPUMD_EAM_RHO_ENTRY(tpumd_eam_rho_cellgrid_f64, double)

#define TPUMD_EAM_FORCE_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const T* x, const unsigned char* valid, const T* fp,   \
                      const int* pairs, const int* npairs,                   \
                      const long long* rows, const T* lengths,               \
                      const T* rhor, const T* z2r, T* f, T* eslot, T* vslot, \
                      long long np, long long natoms, int K, int nr,         \
                      double rdr, double cutsq, int eflag, int vflag,        \
                      void* stream) {                                        \
    const ForceArgs<T> a{x,     valid, fp,     pairs,  npairs, rows,         \
                         lengths, rhor, z2r,  f,      eslot,  vslot,         \
                         np,    natoms, K,     nr,     T(rdr), T(cutsq)};    \
    return launch_force<T>(a, eflag, vflag, stream);                         \
  }

TPUMD_EAM_FORCE_ENTRY(tpumd_eam_force_cellgrid_f32, float)
TPUMD_EAM_FORCE_ENTRY(tpumd_eam_force_cellgrid_f64, double)
