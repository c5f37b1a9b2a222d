// Single-element EAM on the cell grid on Hopper (sm_90a): the density pass
// and the force pass, two kernels launched one after the other on one
// stream.
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
// slot-ordered (nz*ny*nx*cap, 3) array and valid marks real atoms.  Over the
// 27 stencil cells (all three offsets on every axis, also when an axis has 1
// or 2 cells, with the periodic wrap computed from the cell index), each
// valid slot i sums over valid j != i with r2 < cutsq:
//   pass 1: rho_i = sum_j rho(r), then F'(rho_i) and, with EFLAG,
//           F(rho_i) + F'(rho_i) (rho_i - rhomax) when rho_i > rhomax;
//   pass 2: f_i = sum_j d * fpair, fpair = -((F'_i + F'_j) rho'(r) + phi'(r))
//           / r, phi = z2(r) / r, phi' = z2'(r) / r - phi / r; with EFLAG
//           the per-slot sum of phi, with VFLAG the six components of
//           sum_j fpair d_a d_b (the caller halves both).
// A spline row is found as tpumd's _r_index does (pair_eam.py:425-430):
// p = r / dr + 1, m = int(p) clamped to [1, n-1], p = min(p - m, 1); the
// value is ((c3 p + c4) p + c5) p + c6, the derivative (c0 p + c1) p + c2.
// One element only: (F'_i + F'_j) rho'(r) equals LAMMPS's
// F'_i rho'_ji + F'_j rho'_ij only when one density function serves both.
//
// What bounds it: at the 32k in.eam shape (grid 12x12x12, cap 32) there are
// 55,296 slots and 27 * 32 = 864 candidates per slot, 47.8 M candidate pairs
// per pass, of which about 3 % lie inside the 4.95 A cutoff (42 neighbours
// of an fcc site).  The least work, those pairs' arithmetic and each input
// and output moved once (1.2-1.6 MB in f32), takes under a microsecond on
// an H100: pass 1 is bound by its bytes, pass 2 by its operations.  The
// kernels take far longer, in the candidate loop: every valid slot tests
// all 864 candidates, and a cell's warp takes the in-range path (square
// root, 4 or 7 dependent table reads) for every lane whenever one lane
// needs it.  PERF.md has the times, the bounds and the share of loop
// iterations that take that path.
//
// Design (B1's): one block per cell, one thread per i slot (cap rounded up
// to a warp).  For each of the 27 neighbour cells the block stages the
// cell's coordinates with the wrap correction, its validity and, in pass 2,
// its F' in shared memory; every thread then runs the candidate loop from
// shared memory (all threads read the same j).  Masks are tested before
// the square root and the division, so empty slots (at x = 0, F' = 0) never
// reach them.  The spline tables stay in device memory and are read through
// the read-only cache: a row per in-range pair, 4 (pass 1) or 7 (pass 2)
// coefficients.  Pass 1 writes F' of every slot before pass 2 reads any: two
// launches on one stream, no grid-wide sync.  Staging the tables in shared
// memory, splitting the stencil over more threads per slot, and one
// unordered-pair sweep are later work.

#include <cuda_runtime.h>

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

// The neighbour cell at offset o along an axis of n cells from cell c: its
// index and the coordinate shift of its periodic image.
template <typename T>
__device__ __forceinline__ int wrap_cell(int c, int o, int n, T L, T& s) {
  int j = c + o;
  s = T(0);
  if (j >= n) { j -= n; s = L; } else if (j < 0) { j += n; s = -L; }
  return j;
}

template <typename T, bool EFLAG>
__global__ void eam_rho_kernel(const T* __restrict__ x,
                               const unsigned char* __restrict__ valid,
                               const T* __restrict__ lengths,
                               const T* __restrict__ rhor,
                               const T* __restrict__ frho,
                               T* __restrict__ rho_out, T* __restrict__ fp_out,
                               T* __restrict__ eslot, int nx, int ny, int nz,
                               int cap, int nr, int nrho, T rdr, T rdrho,
                               T rhomax, T cutsq) {
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

  T rho = T(0);
  for (int oz = -1; oz <= 1; ++oz) {
    T sz;
    const int jz = wrap_cell(cz, oz, nz, Lz, sz);
    for (int oy = -1; oy <= 1; ++oy) {
      T sy;
      const int jy = wrap_cell(cy, oy, ny, Ly, sy);
      for (int ox = -1; ox <= 1; ++ox) {
        T sx;
        const int jx = wrap_cell(cx, ox, nx, Lx, sx);
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
          int m;
          T p;
          spline_row(sqrt(r2), rdr, nr, m, p);
          rho += spline_value(rhor, m, p);
        }
      }
    }
  }

  if (!active) return;
  T fp = T(0), e = T(0);
  if (ivalid) {
    int m;
    T p;
    spline_row(rho, rdrho, nrho, m, p);
    fp = spline_derivative(frho, m, p);
    if (EFLAG) {
      e = spline_value(frho, m, p);
      if (rho > rhomax) e += fp * (rho - rhomax);
    }
  }
  rho_out[islot] = rho;
  fp_out[islot] = fp;
  if (EFLAG) eslot[islot] = e;
}

template <typename T, bool EFLAG, bool VFLAG>
__global__ void eam_force_kernel(const T* __restrict__ x,
                                 const unsigned char* __restrict__ valid,
                                 const T* __restrict__ fp,
                                 const T* __restrict__ lengths,
                                 const T* __restrict__ rhor,
                                 const T* __restrict__ z2r,
                                 T* __restrict__ f, T* __restrict__ eslot,
                                 T* __restrict__ vslot, int nx, int ny, int nz,
                                 int cap, int nr, T rdr, T cutsq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // cap rows of (x, y, z, valid, F')
  T* sj = reinterpret_cast<T*>(smem_raw);

  const int cell = blockIdx.x;
  const int cx = cell % nx;
  const int cy = (cell / nx) % ny;
  const int cz = cell / (nx * ny);
  const int t = threadIdx.x;
  const long long islot = static_cast<long long>(cell) * cap + t;
  const bool active = t < cap;
  const bool ivalid = active && valid[islot] != 0;

  T xi = T(0), yi = T(0), zi = T(0), fpi = T(0);
  if (active) {
    xi = x[3 * islot + 0];
    yi = x[3 * islot + 1];
    zi = x[3 * islot + 2];
    fpi = fp[islot];
  }
  const T Lx = lengths[0], Ly = lengths[1], Lz = lengths[2];

  T fx = T(0), fy = T(0), fz = T(0), e = T(0);
  T v0 = T(0), v1 = T(0), v2 = T(0), v3 = T(0), v4 = T(0), v5 = T(0);

  for (int oz = -1; oz <= 1; ++oz) {
    T sz;
    const int jz = wrap_cell(cz, oz, nz, Lz, sz);
    for (int oy = -1; oy <= 1; ++oy) {
      T sy;
      const int jy = wrap_cell(cy, oy, ny, Ly, sy);
      for (int ox = -1; ox <= 1; ++ox) {
        T sx;
        const int jx = wrap_cell(cx, ox, nx, Lx, sx);
        const long long jbase =
            (static_cast<long long>(jz * ny + jy) * nx + jx) * cap;

        __syncthreads();  // the previous cell's tile is consumed
        for (int k = t; k < cap; k += blockDim.x) {
          const long long js = jbase + k;
          sj[5 * k + 0] = x[3 * js + 0] + sx;
          sj[5 * k + 1] = x[3 * js + 1] + sy;
          sj[5 * k + 2] = x[3 * js + 2] + sz;
          sj[5 * k + 3] = valid[js] ? T(1) : T(0);
          sj[5 * k + 4] = fp[js];
        }
        __syncthreads();

        if (!ivalid) continue;
        const int self = (ox == 0 && oy == 0 && oz == 0) ? t : -1;
        for (int k = 0; k < cap; ++k) {
          if (sj[5 * k + 3] == T(0) || k == self) continue;
          const T dx = xi - sj[5 * k + 0];
          const T dy = yi - sj[5 * k + 1];
          const T dz = zi - sj[5 * k + 2];
          const T r2 = dx * dx + dy * dy + dz * dz;
          if (!(r2 < cutsq)) continue;
          const T r = sqrt(r2);
          int m;
          T p;
          spline_row(r, rdr, nr, m, p);
          const T rhop = spline_derivative(rhor, m, p);
          const T z2 = spline_value(z2r, m, p);
          const T z2p = spline_derivative(z2r, m, p);
          const T recip = T(1) / r;
          const T phi = z2 * recip;
          const T phip = z2p * recip - phi * recip;
          const T psip = (fpi + sj[5 * k + 4]) * rhop + phip;
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

bool bad_shape(int nx, int ny, int nz, int cap, int n1, int n2) {
  return nx < 1 || ny < 1 || nz < 1 || cap < 1 || cap > 1024 || n1 < 2 ||
         n2 < 2;
}

template <typename T>
int launch_rho(const T* x, const unsigned char* valid, const T* lengths,
               const T* rhor, const T* frho, T* rho, T* fp, T* eslot, int nx,
               int ny, int nz, int cap, int nr, int nrho, double rdr,
               double rdrho, double rhomax, double cutsq, int eflag,
               void* stream) {
  if (bad_shape(nx, ny, nz, cap, nr, nrho)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(nx * ny * nz);
  const dim3 block(((cap + 31) / 32) * 32);
  const size_t smem = 4 * static_cast<size_t>(cap) * sizeof(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (eflag) {
    eam_rho_kernel<T, true><<<grid, block, smem, s>>>(
        x, valid, lengths, rhor, frho, rho, fp, eslot, nx, ny, nz, cap, nr,
        nrho, T(rdr), T(rdrho), T(rhomax), T(cutsq));
  } else {
    eam_rho_kernel<T, false><<<grid, block, smem, s>>>(
        x, valid, lengths, rhor, frho, rho, fp, eslot, nx, ny, nz, cap, nr,
        nrho, T(rdr), T(rdrho), T(rhomax), T(cutsq));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_force(const T* x, const unsigned char* valid, const T* fp,
                 const T* lengths, const T* rhor, const T* z2r, T* f,
                 T* eslot, T* vslot, int nx, int ny, int nz, int cap, int nr,
                 double rdr, double cutsq, int eflag, int vflag,
                 void* stream) {
  if (bad_shape(nx, ny, nz, cap, nr, nr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(nx * ny * nz);
  const dim3 block(((cap + 31) / 32) * 32);
  const size_t smem = 5 * static_cast<size_t>(cap) * sizeof(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T c_rdr = T(rdr), c_cutsq = T(cutsq);
  if (eflag && vflag) {
    eam_force_kernel<T, true, true><<<grid, block, smem, s>>>(
        x, valid, fp, lengths, rhor, z2r, f, eslot, vslot, nx, ny, nz, cap,
        nr, c_rdr, c_cutsq);
  } else if (eflag) {
    eam_force_kernel<T, true, false><<<grid, block, smem, s>>>(
        x, valid, fp, lengths, rhor, z2r, f, eslot, vslot, nx, ny, nz, cap,
        nr, c_rdr, c_cutsq);
  } else if (vflag) {
    eam_force_kernel<T, false, true><<<grid, block, smem, s>>>(
        x, valid, fp, lengths, rhor, z2r, f, eslot, vslot, nx, ny, nz, cap,
        nr, c_rdr, c_cutsq);
  } else {
    eam_force_kernel<T, false, false><<<grid, block, smem, s>>>(
        x, valid, fp, lengths, rhor, z2r, f, eslot, vslot, nx, ny, nz, cap,
        nr, c_rdr, c_cutsq);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes by tpumd_torch/ops/eam_cellgrid.py.  Each
// returns the CUDA error code of its launch (0 on success).
extern "C" int tpumd_eam_rho_cellgrid_f32(
    const float* x, const unsigned char* valid, const float* lengths,
    const float* rhor, const float* frho, float* rho, float* fp, float* eslot,
    int nx, int ny, int nz, int cap, int nr, int nrho, double rdr,
    double rdrho, double rhomax, double cutsq, int eflag, void* stream) {
  return launch_rho<float>(x, valid, lengths, rhor, frho, rho, fp, eslot, nx,
                           ny, nz, cap, nr, nrho, rdr, rdrho, rhomax, cutsq,
                           eflag, stream);
}

extern "C" int tpumd_eam_rho_cellgrid_f64(
    const double* x, const unsigned char* valid, const double* lengths,
    const double* rhor, const double* frho, double* rho, double* fp,
    double* eslot, int nx, int ny, int nz, int cap, int nr, int nrho,
    double rdr, double rdrho, double rhomax, double cutsq, int eflag,
    void* stream) {
  return launch_rho<double>(x, valid, lengths, rhor, frho, rho, fp, eslot, nx,
                            ny, nz, cap, nr, nrho, rdr, rdrho, rhomax, cutsq,
                            eflag, stream);
}

extern "C" int tpumd_eam_force_cellgrid_f32(
    const float* x, const unsigned char* valid, const float* fp,
    const float* lengths, const float* rhor, const float* z2r, float* f,
    float* eslot, float* vslot, int nx, int ny, int nz, int cap, int nr,
    double rdr, double cutsq, int eflag, int vflag, void* stream) {
  return launch_force<float>(x, valid, fp, lengths, rhor, z2r, f, eslot,
                             vslot, nx, ny, nz, cap, nr, rdr, cutsq, eflag,
                             vflag, stream);
}

extern "C" int tpumd_eam_force_cellgrid_f64(
    const double* x, const unsigned char* valid, const double* fp,
    const double* lengths, const double* rhor, const double* z2r, double* f,
    double* eslot, double* vslot, int nx, int ny, int nz, int cap, int nr,
    double rdr, double cutsq, int eflag, int vflag, void* stream) {
  return launch_force<double>(x, valid, fp, lengths, rhor, z2r, f, eslot,
                              vslot, nx, ny, nz, cap, nr, rdr, cutsq, eflag,
                              vflag, stream);
}
