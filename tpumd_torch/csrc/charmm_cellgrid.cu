// lj/charmm/coul/long cell-grid forces, energies and virial on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel tpumd/ops/pallas_charmm.py::_kernel (entry
// charmm_cellgrid_forces_pallas) and, on energy steps, the XLA sweep
// tpumd/ops/cellgrid.py::cellgrid_pair_sums(q=..., special=...) of the
// rhodo_class deck.
//
// Atoms sit in a (nz, ny, nx, cap) grid of fixed-capacity cells; x is the
// slot-ordered (nz*ny*nx*cap, 3) array, valid marks real atoms, q, type and
// tag are per slot, and stags / scodes (slots, S) hold each slot's special
// neighbours (tags, 0 = none) and their codes 1/2/3 (1-2, 1-3, 1-4).  Every
// valid slot i sums, over the 27 stencil cells, for valid j != i (self
// skipped only at offset (0,0,0)) with r2 < max(cut_coulsq, cut_ljsq),
// d = x_i - x_j:
//   w_lj, w_coul = 1 + sum over i's special entries s with tag_s == tag_j of
//                  (W[code_s] - 1), W the special_bonds weights;
//   Coulomb (r2 < cut_coulsq): erfc by the reference's polynomial
//     (src/KSPACE/pair_lj_charmm_coul_long.cpp:143-158, the same constants
//     as tpumd), prefactor = qqrd2e q_i q_j / r,
//     forcecoul = prefactor (erfc + EWALD_F g r e^-(g r)^2)
//                 - (1 - w_coul) prefactor   (the kspace exclusion term:
//                 an excluded pair in range is still visited),
//     ecoul = prefactor erfc - (1 - w_coul) prefactor;
//   LJ (r2 < cut_ljsq): lj1..lj4 from the (ntypes+1)^2 tables, CHARMM's
//     energy switch between cut_lj_inner and cut_lj, times w_lj;
//   fpair = forcelj / r2 + forcecoul / r2, f_i += d fpair.
// With EFLAG each slot writes its van der Waals and Coulomb energies, with
// VFLAG the six components sum_j fpair d_a d_b; the caller halves their
// sums.  Both terms vanish beyond their cutoffs, so where an axis has fewer
// than 3 cells and a partner is met at two images, only the image in range
// (there is one: every config guards L >= 2 cutneigh) contributes.  The
// periodic wrap comes from the cell index: the neighbour cell is (c+o) mod
// n, and x_j gets +L where c+o >= n and -L where c+o < 0.
//
// What bounds it: at the 32k rhodo_class shape (grid 4x4x8, cap ~368) there
// are ~47k slots and 27 * cap ~ 9,900 candidates per slot, ~3e8 candidate
// tests per call, of which ~4 % are in range (~400 neighbours per atom);
// each in-range pair costs an exponential, a square root, two divisions and
// the walk over the i slot's ~18 special entries.  The inputs are ~47k
// slots of ~120 bytes, read a few times from L2, so the kernel is bound by
// the ALU work of the candidate loop and the in-range arithmetic, not by
// memory.
//
// Design (B1's, tpumd_torch/csrc/lj_cellgrid.cu): one block per cell, one
// thread per i slot (cap rounded up to a warp).  At this cap the 27
// neighbour cells do not fit in shared memory together, so the block stages
// one cell at a time: coordinates with the wrap correction, charge, type
// (0 for an empty slot) and tag.  The lj tables (a table read replaces the
// TPU's select chain over types) and each i slot's special list, packed as
// (tag << 2 | code) in a [S][cap] array so that a warp reads consecutive
// words, stay in shared memory for the whole sweep.  The special walk runs
// only for pairs in range.  Splitting the stencil over more threads per
// slot (one block per SM at 32k), pair lists, and wgmma/TMA are later work.

#include <cuda_runtime.h>

namespace {

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

template <typename T, bool EFLAG, bool VFLAG>
__global__ void charmm_cellgrid_kernel(
    const T* __restrict__ x, const T* __restrict__ q,
    const int* __restrict__ type, const unsigned char* __restrict__ valid,
    const int* __restrict__ tag, const int* __restrict__ stags,
    const int* __restrict__ scodes, int S, const T* __restrict__ lengths,
    const T* __restrict__ ljtab, int nt1, T* __restrict__ f,
    T* __restrict__ eslot, T* __restrict__ cslot, T* __restrict__ vslot,
    int nx, int ny, int nz, int cap, Params<T> p, Weights<T> w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ntab = nt1 * nt1;
  T* sx = reinterpret_cast<T*>(smem_raw);  // cap each: x, y, z, q
  T* sy = sx + cap;
  T* sz = sy + cap;
  T* sq = sz + cap;
  T* slj = sq + cap;                               // 4 * ntab: lj1..lj4
  int* stype = reinterpret_cast<int*>(slj + 4 * ntab);  // cap; 0 = empty
  int* stag = stype + cap;                         // cap
  int* ispec = stag + cap;                         // S * cap: tag<<2|code

  const int cell = blockIdx.x;
  const int cx = cell % nx;
  const int cy = (cell / nx) % ny;
  const int cz = cell / (nx * ny);
  const int t = threadIdx.x;
  const long long islot = static_cast<long long>(cell) * cap + t;
  const bool active = t < cap;
  const bool ivalid = active && valid[islot] != 0;

  for (int k = t; k < 4 * ntab; k += blockDim.x) slj[k] = ljtab[k];
  T xi = T(0), yi = T(0), zi = T(0), qi = T(0);
  int ti = 0;
  if (active) {
    xi = x[3 * islot + 0];
    yi = x[3 * islot + 1];
    zi = x[3 * islot + 2];
    qi = q[islot];
    ti = type[islot];
    for (int s = 0; s < S; ++s) {
      const int st = stags[islot * S + s];
      ispec[s * cap + t] = st > 0 ? (st << 2) | (scodes[islot * S + s] & 3)
                                  : 0;
    }
  }
  const T Lx = lengths[0], Ly = lengths[1], Lz = lengths[2];
  const T cutsq = p.cut_coulsq > p.cut_ljsq ? p.cut_coulsq : p.cut_ljsq;

  T fx = T(0), fy = T(0), fz = T(0), ev = T(0), ec = T(0);
  T v0 = T(0), v1 = T(0), v2 = T(0), v3 = T(0), v4 = T(0), v5 = T(0);

  for (int oz = -1; oz <= 1; ++oz) {
    int jz = cz + oz;
    T shz = T(0);
    if (jz >= nz) { jz -= nz; shz = Lz; } else if (jz < 0) { jz += nz; shz = -Lz; }
    for (int oy = -1; oy <= 1; ++oy) {
      int jy = cy + oy;
      T shy = T(0);
      if (jy >= ny) { jy -= ny; shy = Ly; } else if (jy < 0) { jy += ny; shy = -Ly; }
      for (int ox = -1; ox <= 1; ++ox) {
        int jx = cx + ox;
        T shx = T(0);
        if (jx >= nx) { jx -= nx; shx = Lx; } else if (jx < 0) { jx += nx; shx = -Lx; }
        const long long jbase =
            (static_cast<long long>(jz * ny + jy) * nx + jx) * cap;

        __syncthreads();  // the previous cell's tile is consumed
        for (int k = t; k < cap; k += blockDim.x) {
          const long long js = jbase + k;
          sx[k] = x[3 * js + 0] + shx;
          sy[k] = x[3 * js + 1] + shy;
          sz[k] = x[3 * js + 2] + shz;
          sq[k] = q[js];
          stype[k] = valid[js] ? type[js] : 0;
          stag[k] = tag[js];
        }
        __syncthreads();

        if (!ivalid) continue;
        const int self = (ox == 0 && oy == 0 && oz == 0) ? t : -1;
        for (int k = 0; k < cap; ++k) {
          const int tj = stype[k];
          if (tj == 0 || k == self) continue;
          const T dx = xi - sx[k];
          const T dy = yi - sy[k];
          const T dz = zi - sz[k];
          const T r2 = dx * dx + dy * dy + dz * dz;
          if (!(r2 < cutsq)) continue;

          // special weights: the i slot's entries naming this j
          const int gj = stag[k];
          T wl = T(1), wc = T(1);
          for (int s = 0; s < S; ++s) {
            const int e = ispec[s * cap + t];
            if ((e >> 2) == gj) {
              wl += w.lj[e & 3] - T(1);
              wc += w.coul[e & 3] - T(1);
            }
          }

          const T r2inv = T(1) / r2;
          T fcoul = T(0);
          if (r2 < p.cut_coulsq) {
            const T r = sqrt_t(r2);
            const T grij = p.g_ewald * r;
            const T expm2 = exp_t(-grij * grij);
            const T tp = T(1) / (T(1) + T(kEwaldP) * grij);
            const T erfc =
                tp * (T(kA1) + tp * (T(kA2) + tp * (T(kA3) + tp * (T(kA4) +
                      tp * T(kA5))))) * expm2;
            const T prefactor = p.qqrd2e * qi * sq[k] / r;
            fcoul = prefactor * (erfc + T(kEwaldF) * grij * expm2) -
                    (T(1) - wc) * prefactor;
            if (EFLAG) ec += prefactor * erfc - (T(1) - wc) * prefactor;
          }
          T forcelj = T(0);
          if (r2 < p.cut_ljsq) {
            const int idx = ti * nt1 + tj;
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
    }
  }

  if (!active) return;
  f[3 * islot + 0] = fx;
  f[3 * islot + 1] = fy;
  f[3 * islot + 2] = fz;
  if (EFLAG) {
    eslot[islot] = ev;
    cslot[islot] = ec;
  }
  if (VFLAG) {
    T* vo = vslot + 6 * islot;
    vo[0] = v0; vo[1] = v1; vo[2] = v2; vo[3] = v3; vo[4] = v4; vo[5] = v5;
  }
}

template <typename T, bool EFLAG, bool VFLAG>
int launch_one(dim3 grid, dim3 block, size_t smem, cudaStream_t s,
               const T* x, const T* q, const int* type,
               const unsigned char* valid, const int* tag, const int* stags,
               const int* scodes, int S, const T* lengths, const T* ljtab,
               int nt1, T* f, T* eslot, T* cslot, T* vslot, int nx, int ny,
               int nz, int cap, const Params<T>& p, const Weights<T>& w) {
  auto kernel = charmm_cellgrid_kernel<T, EFLAG, VFLAG>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, block, smem, s>>>(x, q, type, valid, tag, stags, scodes, S,
                                   lengths, ljtab, nt1, f, eslot, cslot,
                                   vslot, nx, ny, nz, cap, p, w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* x, const T* q, const int* type,
           const unsigned char* valid, const int* tag, const int* stags,
           const int* scodes, int S, const T* lengths, const T* ljtab,
           int nt1, T* f, T* eslot, T* cslot, T* vslot, int nx, int ny,
           int nz, int cap, double qqrd2e, double g_ewald, double cut_coulsq,
           double cut_ljsq, double cut_lj_innersq, double denom_lj,
           const double* wts, int eflag, int vflag, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || cap < 1 || cap > 1024 || S < 1 ||
      nt1 < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(nx * ny * nz);
  const dim3 block(((cap + 31) / 32) * 32);
  const size_t smem =
      (4 * static_cast<size_t>(cap) + 4 * static_cast<size_t>(nt1) * nt1) *
          sizeof(T) +
      (2 + static_cast<size_t>(S)) * cap * sizeof(int);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params<T> p{T(qqrd2e), T(g_ewald), T(cut_coulsq), T(cut_ljsq),
                    T(cut_lj_innersq), T(denom_lj)};
  Weights<T> w;
  for (int k = 0; k < 4; ++k) {
    w.lj[k] = T(wts[k]);
    w.coul[k] = T(wts[4 + k]);
  }
  if (eflag && vflag) {
    return launch_one<T, true, true>(grid, block, smem, s, x, q, type, valid,
                                     tag, stags, scodes, S, lengths, ljtab,
                                     nt1, f, eslot, cslot, vslot, nx, ny, nz,
                                     cap, p, w);
  }
  if (eflag) {
    return launch_one<T, true, false>(grid, block, smem, s, x, q, type,
                                      valid, tag, stags, scodes, S, lengths,
                                      ljtab, nt1, f, eslot, cslot, vslot, nx,
                                      ny, nz, cap, p, w);
  }
  if (vflag) {
    return launch_one<T, false, true>(grid, block, smem, s, x, q, type,
                                      valid, tag, stags, scodes, S, lengths,
                                      ljtab, nt1, f, eslot, cslot, vslot, nx,
                                      ny, nz, cap, p, w);
  }
  return launch_one<T, false, false>(grid, block, smem, s, x, q, type, valid,
                                     tag, stags, scodes, S, lengths, ljtab,
                                     nt1, f, eslot, cslot, vslot, nx, ny, nz,
                                     cap, p, w);
}

}  // namespace

// C interface, bound with ctypes by tpumd_torch/ops/charmm_cellgrid.py.
// wl0..wl3 and wc0..wc3 are the special_bonds weights by code.  Returns
// the CUDA error code of the launch (0 on success).
#define TPUMD_CHARMM_ENTRY(NAME, T)                                          \
  extern "C" int NAME(                                                       \
      const T* x, const T* q, const int* type, const unsigned char* valid,   \
      const int* tag, const int* stags, const int* scodes, int S,            \
      const T* lengths, const T* ljtab, int nt1, T* f, T* eslot, T* cslot,   \
      T* vslot, int nx, int ny, int nz, int cap, double qqrd2e,              \
      double g_ewald, double cut_coulsq, double cut_ljsq,                    \
      double cut_lj_innersq, double denom_lj, double wl0, double wl1,        \
      double wl2, double wl3, double wc0, double wc1, double wc2,            \
      double wc3, int eflag, int vflag, void* stream) {                      \
    const double wts[8] = {wl0, wl1, wl2, wl3, wc0, wc1, wc2, wc3};         \
    return launch<T>(x, q, type, valid, tag, stags, scodes, S, lengths,      \
                     ljtab, nt1, f, eslot, cslot, vslot, nx, ny, nz, cap,    \
                     qqrd2e, g_ewald, cut_coulsq, cut_ljsq, cut_lj_innersq,  \
                     denom_lj, wts, eflag, vflag, stream);                   \
  }

TPUMD_CHARMM_ENTRY(tpumd_charmm_cellgrid_f32, float)
TPUMD_CHARMM_ENTRY(tpumd_charmm_cellgrid_f64, double)
