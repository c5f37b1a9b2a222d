// LJ cell-grid forces, energy and virial on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpumd/ops/pallas_lj.py::_kernel (entry
// lj_cellgrid_forces_pallas) and, on energy/virial steps, the XLA sweep
// tpumd/ops/cellgrid.py::cellgrid_pair_sums for single-type lj/cut.
//
// Atoms sit in a (nz, ny, nx, cap) grid of fixed-capacity cells; x is the
// slot-ordered (nz*ny*nx*cap, 3) array and valid marks real atoms.  Every
// valid slot i sums, over the 27 stencil cells (all three offsets on every
// axis, also when an axis has 1 or 2 cells):
//   f_i = sum_j d_ij * fpair(r2_ij),  d = x_i - x_j,
//   fpair = r^-6 (lj1 r^-6 - lj2) r^-2,
// over valid j != i (the self slot is skipped only at offset (0,0,0)) with
// r2 < cutsq.  No Newton's-third-law scatter, no atomics.  The periodic
// wrap is computed from the cell index: the neighbour cell is (c+o) mod n,
// and x_j gets +L where c+o >= n and -L where c+o < 0.  With EFLAG each
// slot also writes e_i = sum_j r^-6 (lj3 r^-6 - lj4) - offset, with VFLAG
// the six components sum_j fpair d_a d_b; the caller halves their sums.
//
// What bounds it: at the 32k in.lj shape (grid 11x11x11, cap 40) there are
// 53,240 slots and 27 * 40 = 1,080 candidates per slot, 57.5 M candidate
// pairs per call, of which about 1 in 10 is inside the cutoff.  The inputs
// are 53,240 * 13 bytes (f32), read once per block from L2, so the kernel
// is bound by the ALU work of the candidate loop, not by memory.
//
// Design: one block per cell, one thread per i slot (cap rounded up to a
// warp).  For each of the 27 neighbour cells the block stages the cell's
// coordinates, with the wrap correction applied, and its validity in
// shared memory, then every thread runs the candidate loop from shared
// memory (a broadcast read: all threads read the same j).  Masks are tested
// before the division, so empty slots (at x = 0) never divide.  Threads past
// cap idle (24 of 64 at cap 40); splitting the stencil across more threads
// per slot, and wgmma/TMA, are later work.

#include <cuda_runtime.h>

namespace {

template <typename T, bool EFLAG, bool VFLAG>
__global__ void lj_cellgrid_kernel(const T* __restrict__ x,
                                   const unsigned char* __restrict__ valid,
                                   const T* __restrict__ lengths,
                                   T* __restrict__ f, T* __restrict__ eslot,
                                   T* __restrict__ vslot, int nx, int ny,
                                   int nz, int cap, T lj1, T lj2, T lj3,
                                   T lj4, T offset, T cutsq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sj = reinterpret_cast<T*>(smem_raw);  // cap rows of (x, y, z, valid)

  const int cell = blockIdx.x;
  const int cx = cell % nx;
  const int cy = (cell / nx) % ny;
  const int cz = cell / (nx * ny);
  const int t = threadIdx.x;
  const long long islot = static_cast<long long>(cell) * cap + t;
  const bool active = t < cap;
  const bool ivalid = active && valid[islot] != 0;

  T xi = T(0), yi = T(0), zi = T(0);
  if (active) {
    xi = x[3 * islot + 0];
    yi = x[3 * islot + 1];
    zi = x[3 * islot + 2];
  }
  const T Lx = lengths[0], Ly = lengths[1], Lz = lengths[2];

  T fx = T(0), fy = T(0), fz = T(0), e = T(0);
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
          if (!(r2 < cutsq)) continue;
          const T r2inv = T(1) / r2;
          const T r6inv = r2inv * r2inv * r2inv;
          const T fpair = r6inv * (lj1 * r6inv - lj2) * r2inv;
          fx += dx * fpair;
          fy += dy * fpair;
          fz += dz * fpair;
          if (EFLAG) e += r6inv * (lj3 * r6inv - lj4) - offset;
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
  if (EFLAG) eslot[islot] = e;
  if (VFLAG) {
    T* vo = vslot + 6 * islot;
    vo[0] = v0; vo[1] = v1; vo[2] = v2; vo[3] = v3; vo[4] = v4; vo[5] = v5;
  }
}

template <typename T>
int launch(const T* x, const unsigned char* valid, const T* lengths, T* f,
           T* eslot, T* vslot, int nx, int ny, int nz, int cap, double lj1,
           double lj2, double lj3, double lj4, double offset, double cutsq,
           int eflag, int vflag, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || cap < 1 || cap > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(nx * ny * nz);
  const dim3 block(((cap + 31) / 32) * 32);
  const size_t smem = 4 * static_cast<size_t>(cap) * sizeof(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T c1 = T(lj1), c2 = T(lj2), c3 = T(lj3), c4 = T(lj4);
  const T off = T(offset), cut2 = T(cutsq);
  if (eflag && vflag) {
    lj_cellgrid_kernel<T, true, true><<<grid, block, smem, s>>>(
        x, valid, lengths, f, eslot, vslot, nx, ny, nz, cap, c1, c2, c3, c4,
        off, cut2);
  } else if (eflag) {
    lj_cellgrid_kernel<T, true, false><<<grid, block, smem, s>>>(
        x, valid, lengths, f, eslot, vslot, nx, ny, nz, cap, c1, c2, c3, c4,
        off, cut2);
  } else if (vflag) {
    lj_cellgrid_kernel<T, false, true><<<grid, block, smem, s>>>(
        x, valid, lengths, f, eslot, vslot, nx, ny, nz, cap, c1, c2, c3, c4,
        off, cut2);
  } else {
    lj_cellgrid_kernel<T, false, false><<<grid, block, smem, s>>>(
        x, valid, lengths, f, eslot, vslot, nx, ny, nz, cap, c1, c2, c3, c4,
        off, cut2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes by tpumd_torch/ops/lj_cellgrid.py.  Returns
// the CUDA error code of the launch (0 on success).
extern "C" int tpumd_lj_cellgrid_f32(const float* x, const unsigned char* valid,
                                     const float* lengths, float* f,
                                     float* eslot, float* vslot, int nx,
                                     int ny, int nz, int cap, double lj1,
                                     double lj2, double lj3, double lj4,
                                     double offset, double cutsq, int eflag,
                                     int vflag, void* stream) {
  return launch<float>(x, valid, lengths, f, eslot, vslot, nx, ny, nz, cap,
                       lj1, lj2, lj3, lj4, offset, cutsq, eflag, vflag,
                       stream);
}

extern "C" int tpumd_lj_cellgrid_f64(const double* x,
                                     const unsigned char* valid,
                                     const double* lengths, double* f,
                                     double* eslot, double* vslot, int nx,
                                     int ny, int nz, int cap, double lj1,
                                     double lj2, double lj3, double lj4,
                                     double offset, double cutsq, int eflag,
                                     int vflag, void* stream) {
  return launch<double>(x, valid, lengths, f, eslot, vslot, nx, ny, nz, cap,
                        lj1, lj2, lj3, lj4, offset, cutsq, eflag, vflag,
                        stream);
}
