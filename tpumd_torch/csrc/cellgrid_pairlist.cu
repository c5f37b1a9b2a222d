// The cell grid's pair list at cutneigh, built at every re-bin, on Hopper
// (sm_90a).
//
// Takes the candidate search out of the Pallas TPU kernel
// tpumd/ops/pallas_charmm.py::_kernel (B5, entry
// charmm_cellgrid_forces_pallas), which tested every slot of the 27-cell
// stencil at each force evaluation; here that search runs once per
// re-bin, and the force kernel (charmm_cellgrid.cu) sweeps the list.  It
// serves any style on a periodic grid.
//
// Atoms sit in a (nz, ny, nx, cap) grid of fixed-capacity cells; x is the
// slot-ordered (nz*ny*nx*cap, 3) array, valid marks real atoms, and
// sslots / scodes (slots, S) hold each slot's special partners, as the
// slots that hold their tags (-1 = none; the wrapper maps the tags), and
// their codes 1-3; extent (cells,) is each cell's last valid slot + 1.
// For every slot i the row pairs[i][0 .. K) takes every valid j != i (self
// skipped only at offset (0,0,0)) with r2 < cutneigh^2, in stencil order
// (z, y, x offsets, then slot), as j | code << 30 (LAMMPS's SBBITS
// packing), code the largest code among i's special entries naming j; the
// rest of the row is i's own slot (code 0).  npairs[i] = min(count, K);
// stat[0] takes the longest count (atomicMax), stat[1] = 1 where a row
// overflowed.
// The periodic wrap comes from the cell index as in B1-B6, and d and r2
// are rounded op by op (no contraction), as the plain version computes
// them, so both find the same pairs.  Where an axis has fewer than 3 cells
// a partner is met at two images; L >= 2 cutneigh leaves one in range.
//
// What bounds it: at the 32k rhodo_class shape (grid 4x4x8, cap 368,
// 47,104 slots, ~250 atoms a cell) each valid slot tests 27 x ~250 ~ 6,750
// candidates, ~2.2e8 distance tests a build, of which ~10 % land in the
// list (~705 a row).  The output is the list itself, 47,104 x K ~ 960
// words (~181 MB), which at 3.35 TB/s is ~0.054 ms; the distance tests, ~10
// operations each, take ~0.03 ms at the f32 peak but ~40 instructions a
// warp per 32 candidates in this design.  It runs once per re-bin (55 per
// 500 steps on rhodo_class), against the force kernel's ~1,100 launches.
//
// Design: one warp per i slot.  The warp walks the 27 stencil cells as B5
// did, 32 consecutive j slots at a time (one coalesced 384-byte read of
// x) up to the cell's extent (a re-bin fills each cell from its first
// slot: ~250 of cap 368 at 32k, 8 chunks a cell instead of 12), tests r2 <
// cutneigh^2 on each lane, and appends the hits in order: __ballot_sync
// gives the chunk's hit mask, __popc of the lanes below
// gives each hit's place, and the warp's running count the row's end.
// The codes cost a ballot per chunk with hits, not a walk per hit: i's S
// special slots sit in shared memory, one per lane, and a ballot of those
// that fall in the chunk's 32 slots (usually none) leaves a few entries
// to hand their code to the lane holding that slot.  The padding is
// written by the whole warp, 32 words a step.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
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

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
cellgrid_pairlist_kernel(const T* __restrict__ x,
                         const unsigned char* __restrict__ valid,
                         const int* __restrict__ sslots,
                         const int* __restrict__ scodes, int S,
                         const int* __restrict__ extent,
                         const T* __restrict__ lengths, int* __restrict__ pairs,
                         int* __restrict__ npairs, int* __restrict__ stat,
                         int nx, int ny, int nz, int cap, int K, T cutsq) {
  extern __shared__ int spec[];  // per warp: S slots, then S codes
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long np = static_cast<long long>(nx) * ny * nz * cap;
  const long long i =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (i >= np) return;  // the whole warp: i depends on the warp only
  int* wslot = spec + 2 * S * warp;
  int* wcode = wslot + S;
  for (int s = lane; s < S; s += 32) {
    wslot[s] = sslots[i * S + s];
    wcode[s] = scodes[i * S + s];
  }
  __syncwarp();

  int* row = pairs + i * K;
  int count = 0;
  if (valid[i]) {
    const int cell = static_cast<int>(i / cap);
    const int t = static_cast<int>(i % cap);
    const int cx = cell % nx;
    const int cy = (cell / nx) % ny;
    const int cz = cell / (nx * ny);
    const T xi = x[3 * i + 0], yi = x[3 * i + 1], zi = x[3 * i + 2];
    const T Lx = lengths[0], Ly = lengths[1], Lz = lengths[2];
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
          const int jcell = (jz * ny + jy) * nx + jx;
          const long long jbase = static_cast<long long>(jcell) * cap;
          const int jn = extent[jcell];
          const int self = (ox == 0 && oy == 0 && oz == 0) ? t : -1;
          for (int k0 = 0; k0 < jn; k0 += 32) {
            const int k = k0 + lane;
            const long long js = jbase + k;
            bool hit = false;
            if (k < jn && k != self && valid[js]) {
              const T dx = sub_rn(xi, add_rn(x[3 * js + 0], shx));
              const T dy = sub_rn(yi, add_rn(x[3 * js + 1], shy));
              const T dz = sub_rn(zi, add_rn(x[3 * js + 2], shz));
              const T r2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)),
                                  mul_rn(dz, dz));
              hit = r2 < cutsq;
            }
            const unsigned m = __ballot_sync(0xffffffffu, hit);
            if (m == 0u) continue;
            // the special entries whose partner sits in this chunk of 32
            // slots: found by one ballot per 32 entries, then each hands
            // its code to the lane that holds its slot
            int code = 0;
            const long long lo = jbase + k0;
            for (int w = 0; w < S; w += 32) {
              const int s = w + lane;
              const long long ss = s < S ? wslot[s] : -1;
              unsigned in = __ballot_sync(0xffffffffu, ss >= lo &&
                                                           ss < lo + 32);
              while (in) {
                const int b = w + __ffs(in) - 1;
                in &= in - 1u;
                if (hit && wslot[b] == js && wcode[b] > code) {
                  code = wcode[b];
                }
              }
            }
            const int pos = count + __popc(m & ((1u << lane) - 1u));
            if (hit && pos < K) {
              row[pos] = static_cast<int>(static_cast<unsigned>(js) |
                                          (static_cast<unsigned>(code)
                                           << 30));
            }
            count += __popc(m);
          }
        }
      }
    }
  }
  for (int k = count + lane; k < K; k += 32) row[k] = static_cast<int>(i);
  if (lane == 0) {
    npairs[i] = count < K ? count : K;
    atomicMax(stat, count);
    if (count > K) stat[1] = 1;
  }
}

template <typename T>
int launch(const T* x, const unsigned char* valid, const int* sslots,
           const int* scodes, int S, const int* extent, const T* lengths,
           int* pairs, int* npairs, int* stat, int nx, int ny, int nz,
           int cap, int K, double cutsq, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || cap < 1 || K < 1 || S < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long np = static_cast<long long>(nx) * ny * nz * cap;
  const dim3 grid(static_cast<unsigned>((np + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  const dim3 block(32 * kWarpsPerBlock);
  const size_t smem = 2 * static_cast<size_t>(S) * kWarpsPerBlock *
                      sizeof(int);
  auto kernel = cellgrid_pairlist_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      x, valid, sslots, scodes, S, extent, lengths, pairs, npairs, stat, nx,
      ny, nz, cap, K, T(cutsq));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes by tpumd_torch/ops/cellgrid_pairlist.py.
// sslots / scodes may be null when S = 0.  Returns the CUDA error code of
// the launch (0 on success).
#define TPUMD_PAIRLIST_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const T* x, const unsigned char* valid,               \
                      const int* sslots, const int* scodes, int S,          \
                      const int* extent, const T* lengths, int* pairs,      \
                      int* npairs, int* stat, int nx, int ny, int nz,       \
                      int cap, int K, double cutsq, void* stream) {         \
    return launch<T>(x, valid, sslots, scodes, S, extent, lengths, pairs,    \
                     npairs, stat, nx, ny, nz, cap, K, cutsq, stream);       \
  }

TPUMD_PAIRLIST_ENTRY(tpumd_cellgrid_pairlist_f32, float)
TPUMD_PAIRLIST_ENTRY(tpumd_cellgrid_pairlist_f64, double)
