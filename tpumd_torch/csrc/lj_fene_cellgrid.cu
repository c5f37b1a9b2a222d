// LJ + FENE bond cell-grid forces, energies and virial on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpumd/ops/pallas_lj.py::_kernel_fene
// (entry lj_fene_cellgrid_forces_pallas) and, on energy/virial steps, the
// XLA sweep tpumd/ops/cellgrid.py::cellgrid_pair_sums(bond=...) of the
// chain deck: single-type lj/cut plus one FENE bond type whose partners
// are matched in-kernel by tag (special_bonds fene: the special list is
// exactly the bond partners at weight 0, so a bonded pair takes only the
// bond force).
//
// Atoms sit in a (nz, ny, nx, cap) grid of fixed-capacity cells; x is the
// slot-ordered (nz*ny*nx*cap, 3) array, valid marks real atoms, tag holds
// each slot's atom ID and btag (slots, nb) its bond-partner IDs (nb <= 2,
// 0 = none).  Every valid slot i sums, over the 27 stencil cells, for
// valid j != i (self skipped only at offset (0,0,0)), d = x_i - x_j:
//   tag_j in btag_i:  fpair = -k / max(1 - r2/R0^2, 0.1)
//                           + [r2 < 2^(1/3) sig^2] 48 eps sr6 (sr6 - 0.5) / r2,
//                     no cutoff test;
//   otherwise:        fpair = r^-6 (lj1 r^-6 - lj2) r^-2 where r2 < cutsq.
// f_i = sum_j d fpair.  With EFLAG each slot writes its lj energy and its
// bond energy, with VFLAG the six components sum_j fpair d_a d_b over both
// terms; the caller halves their sums.  When an axis has fewer than 3
// cells a partner is met at several periodic images, and the bond counts
// only at the minimum image (|d_a| <= L_a / 2 on every axis); at the other
// images the pair is an ordinary lj candidate, outside the cutoff.  The
// periodic wrap comes from the cell index: the neighbour cell is (c+o) mod
// n, and x_j gets +L where c+o >= n and -L where c+o < 0.
//
// What bounds it: at the 32k chain shape (grid 11x11x11, cap 40) there are
// 53,240 slots and 27 * 40 = 1,080 candidates per slot, 57.5 M candidate
// pairs per call, of which about 2 % lie inside the 1.12 sigma cutoff or
// are bonded.  The inputs are 53,240 * 25 bytes (f32), read once per block
// from L2, so the kernel is bound by the ALU work of the candidate loop
// (distance, cutoff and tag tests), not by memory; the work the result
// needs (the in-range pairs) is far smaller, so the candidate count is
// what a faster kernel must cut.
//
// Design (B1's, tpumd_torch/csrc/lj_cellgrid.cu): one block per cell, one
// thread per i slot (cap rounded up to a warp), the slot's two partner tags
// in registers.  For each of the 27 neighbour cells the block stages the
// cell's coordinates, with the wrap correction applied, its validity and
// its tags in shared memory; every thread then runs the candidate loop from
// shared memory (a broadcast read).  Validity and self are tested before
// any division, so empty slots (at x = 0) never divide; the tag test picks
// the branch, and only in-cutoff lj pairs and bonded pairs reach the
// arithmetic.  Fewer candidates (smaller cells, pair lists) are later work.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float log_t(float a) { return logf(a); }
__device__ __forceinline__ double log_t(double a) { return log(a); }
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }

template <typename T, bool EFLAG, bool VFLAG>
__global__ void lj_fene_cellgrid_kernel(
    const T* __restrict__ x, const unsigned char* __restrict__ valid,
    const int* __restrict__ tag, const int* __restrict__ btag, int nb,
    const T* __restrict__ lengths, T* __restrict__ f, T* __restrict__ eslot,
    T* __restrict__ bslot, T* __restrict__ vslot, int nx, int ny, int nz,
    int cap, T lj1, T lj2, T lj3, T lj4, T offset, T cutsq, T fk, T r0sq,
    T feps, T fsig2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sj = reinterpret_cast<T*>(smem_raw);          // cap rows (x, y, z, valid)
  int* stag = reinterpret_cast<int*>(sj + 4 * cap);  // cap tags

  const int cell = blockIdx.x;
  const int cx = cell % nx;
  const int cy = (cell / nx) % ny;
  const int cz = cell / (nx * ny);
  const int t = threadIdx.x;
  const long long islot = static_cast<long long>(cell) * cap + t;
  const bool active = t < cap;
  const bool ivalid = active && valid[islot] != 0;

  T xi = T(0), yi = T(0), zi = T(0);
  // partner tags; -1 (never a tag) where the slot has no partner
  int b0 = -1, b1 = -1;
  if (active) {
    xi = x[3 * islot + 0];
    yi = x[3 * islot + 1];
    zi = x[3 * islot + 2];
    const int p0 = btag[islot * nb];
    const int p1 = nb > 1 ? btag[islot * nb + 1] : 0;
    b0 = p0 > 0 ? p0 : -1;
    b1 = p1 > 0 ? p1 : -1;
  }
  const T Lx = lengths[0], Ly = lengths[1], Lz = lengths[2];
  const T hLx = T(0.5) * Lx, hLy = T(0.5) * Ly, hLz = T(0.5) * Lz;
  const bool min_image_guard = nx < 3 || ny < 3 || nz < 3;
  const T wca2 = T(1.2599210498948732) * fsig2;  // (2^(1/6) sigma)^2

  T fx = T(0), fy = T(0), fz = T(0), e = T(0), eb = T(0);
  T v0 = T(0), v1 = T(0), v2 = T(0), v3 = T(0), v4 = T(0), v5 = T(0);

  for (int oz = -1; oz <= 1; ++oz) {
    int jz = cz + oz;
    T sz = T(0);
    if (jz >= nz) { jz -= nz; sz = Lz; } else if (jz < 0) { jz += nz; sz = -Lz; }
    for (int oy = -1; oy <= 1; ++oy) {
      int jy = cy + oy;
      T sy = T(0);
      if (jy >= ny) { jy -= ny; sy = Ly; } else if (jy < 0) { jy += ny; sy = -Ly; }
      for (int ox = -1; ox <= 1; ++ox) {
        int jx = cx + ox;
        T sx = T(0);
        if (jx >= nx) { jx -= nx; sx = Lx; } else if (jx < 0) { jx += nx; sx = -Lx; }
        const long long jbase =
            (static_cast<long long>(jz * ny + jy) * nx + jx) * cap;

        __syncthreads();  // the previous cell's tile is consumed
        for (int k = t; k < cap; k += blockDim.x) {
          const long long js = jbase + k;
          sj[4 * k + 0] = x[3 * js + 0] + sx;
          sj[4 * k + 1] = x[3 * js + 1] + sy;
          sj[4 * k + 2] = x[3 * js + 2] + sz;
          sj[4 * k + 3] = valid[js] ? T(1) : T(0);
          stag[k] = tag[js];
        }
        __syncthreads();

        if (!ivalid) continue;
        const int self = (ox == 0 && oy == 0 && oz == 0) ? t : -1;
        for (int k = 0; k < cap; ++k) {
          if (sj[4 * k + 3] == T(0) || k == self) continue;
          const T dx = xi - sj[4 * k + 0];
          const T dy = yi - sj[4 * k + 1];
          const T dz = zi - sj[4 * k + 2];
          const T r2 = dx * dx + dy * dy + dz * dz;
          const int tj = stag[k];
          bool bonded = tj == b0 || tj == b1;
          if (bonded && min_image_guard) {
            bonded = abs_t(dx) <= hLx && abs_t(dy) <= hLy && abs_t(dz) <= hLz;
          }
          T fpair;
          if (bonded) {
            const T r2inv = T(1) / r2;
            T rlogarg = T(1) - r2 / r0sq;
            if (rlogarg < T(0.1)) rlogarg = T(0.1);
            fpair = -fk / rlogarg;
            if (EFLAG) eb += T(-0.5) * fk * r0sq * log_t(rlogarg);
            if (r2 < wca2) {
              const T sr2 = fsig2 * r2inv;
              const T sr6 = sr2 * sr2 * sr2;
              fpair += T(48) * feps * sr6 * (sr6 - T(0.5)) * r2inv;
              if (EFLAG) eb += T(4) * feps * sr6 * (sr6 - T(1)) + feps;
            }
          } else {
            if (!(r2 < cutsq)) continue;
            const T r2inv = T(1) / r2;
            const T r6inv = r2inv * r2inv * r2inv;
            fpair = r6inv * (lj1 * r6inv - lj2) * r2inv;
            if (EFLAG) e += r6inv * (lj3 * r6inv - lj4) - offset;
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
      }
    }
  }

  if (!active) return;
  f[3 * islot + 0] = fx;
  f[3 * islot + 1] = fy;
  f[3 * islot + 2] = fz;
  if (EFLAG) {
    eslot[islot] = e;
    bslot[islot] = eb;
  }
  if (VFLAG) {
    T* vo = vslot + 6 * islot;
    vo[0] = v0; vo[1] = v1; vo[2] = v2; vo[3] = v3; vo[4] = v4; vo[5] = v5;
  }
}

template <typename T, bool EFLAG, bool VFLAG>
void launch_one(dim3 grid, dim3 block, size_t smem, cudaStream_t s,
                const T* x, const unsigned char* valid, const int* tag,
                const int* btag, int nb, const T* lengths, T* f, T* eslot,
                T* bslot, T* vslot, int nx, int ny, int nz, int cap,
                const T* c) {
  lj_fene_cellgrid_kernel<T, EFLAG, VFLAG><<<grid, block, smem, s>>>(
      x, valid, tag, btag, nb, lengths, f, eslot, bslot, vslot, nx, ny, nz,
      cap, c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], c[9]);
}

template <typename T>
int launch(const T* x, const unsigned char* valid, const int* tag,
           const int* btag, int nb, const T* lengths, T* f, T* eslot,
           T* bslot, T* vslot, int nx, int ny, int nz, int cap, double lj1,
           double lj2, double lj3, double lj4, double offset, double cutsq,
           double fk, double r0sq, double feps, double fsig2, int eflag,
           int vflag, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || cap < 1 || cap > 1024 || nb < 1 ||
      nb > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(nx * ny * nz);
  const dim3 block(((cap + 31) / 32) * 32);
  const size_t smem = 4 * static_cast<size_t>(cap) * sizeof(T) +
                      static_cast<size_t>(cap) * sizeof(int);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T c[10] = {T(lj1), T(lj2), T(lj3),  T(lj4), T(offset),
                   T(cutsq), T(fk), T(r0sq), T(feps), T(fsig2)};
  if (eflag && vflag) {
    launch_one<T, true, true>(grid, block, smem, s, x, valid, tag, btag, nb,
                              lengths, f, eslot, bslot, vslot, nx, ny, nz,
                              cap, c);
  } else if (eflag) {
    launch_one<T, true, false>(grid, block, smem, s, x, valid, tag, btag, nb,
                               lengths, f, eslot, bslot, vslot, nx, ny, nz,
                               cap, c);
  } else if (vflag) {
    launch_one<T, false, true>(grid, block, smem, s, x, valid, tag, btag, nb,
                               lengths, f, eslot, bslot, vslot, nx, ny, nz,
                               cap, c);
  } else {
    launch_one<T, false, false>(grid, block, smem, s, x, valid, tag, btag,
                                nb, lengths, f, eslot, bslot, vslot, nx, ny,
                                nz, cap, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes by tpumd_torch/ops/lj_fene_cellgrid.py.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int tpumd_lj_fene_cellgrid_f32(
    const float* x, const unsigned char* valid, const int* tag,
    const int* btag, int nb, const float* lengths, float* f, float* eslot,
    float* bslot, float* vslot, int nx, int ny, int nz, int cap, double lj1,
    double lj2, double lj3, double lj4, double offset, double cutsq,
    double fk, double r0sq, double feps, double fsig2, int eflag, int vflag,
    void* stream) {
  return launch<float>(x, valid, tag, btag, nb, lengths, f, eslot, bslot,
                       vslot, nx, ny, nz, cap, lj1, lj2, lj3, lj4, offset,
                       cutsq, fk, r0sq, feps, fsig2, eflag, vflag, stream);
}

extern "C" int tpumd_lj_fene_cellgrid_f64(
    const double* x, const unsigned char* valid, const int* tag,
    const int* btag, int nb, const double* lengths, double* f,
    double* eslot, double* bslot, double* vslot, int nx, int ny, int nz,
    int cap, double lj1, double lj2, double lj3, double lj4, double offset,
    double cutsq, double fk, double r0sq, double feps, double fsig2,
    int eflag, int vflag, void* stream) {
  return launch<double>(x, valid, tag, btag, nb, lengths, f, eslot, bslot,
                        vslot, nx, ny, nz, cap, lj1, lj2, lj3, lj4, offset,
                        cutsq, fk, r0sq, feps, fsig2, eflag, vflag, stream);
}
