// The cell grid's pair list at cutneigh, built at every re-bin, on Hopper
// (sm_90a).
//
// Takes the candidate search out of the Pallas TPU kernels
// tpumd/ops/pallas_charmm.py::_kernel (B5), tpumd/ops/pallas_gran.py::
// _kernel (B6) and tpumd/ops/pallas_lj.py::_kernel_fene (B2), which tested
// every slot of the 27-cell stencil at each force evaluation; here that
// search runs once per re-bin, and the force kernels (charmm_cellgrid.cu,
// gran_cellgrid.cu, lj_fene_cellgrid.cu) sweep the list.  It serves any
// grid the stencil takes: periodic or not on each axis.
//
// Atoms sit in a (nz, ny, nx, cap) grid of fixed-capacity cells; x is the
// slot-ordered (nz*ny*nx*cap, 3) array, valid marks real atoms, and
// sslots / scodes (slots, S) hold each slot's special partners, as the
// slots that hold their tags (-1 = none; the wrapper maps the tags), and
// their codes 1-3; extent (cells,) is each cell's last valid slot + 1.
// For every slot i the row pairs[i][0 .. K) takes every valid j != i (self
// skipped only at offset (0,0,0)) with r2 < cutneigh^2 that no group-bit
// pair (b1, b2) excludes (gmask_i & b1 and gmask_j & b2, or the other way
// round: dropped, as LAMMPS's Neighbor drops an excluded pair), in stencil
// order (z, y, x offsets, then slot), as j | code << 30 (LAMMPS's SBBITS
// packing), code the largest code among i's special entries naming j; the
// rest of the row is i's own slot (code 0).  npairs[i] = min(count, K);
// stat[0] takes the longest count (atomicMax), stat[1] = 1 where a row
// overflowed.
// A periodic axis takes all three offsets, its wrap correction computed
// from the cell index (x_j + L where c+o >= n, - L where c+o < 0); a
// non-periodic axis takes none and drops the offsets that alias mod n
// (n = 2: -1, 0; n = 1: 0), as ops/cellgrid.py::_offs does.  d and r2 are
// rounded op by op (no contraction), as the plain version computes them,
// so both find the same pairs.  Where a periodic axis has fewer than 3
// cells a partner is met at two images; L >= 2 cutneigh leaves one in
// range.
//
// What bounds it: at the 32k rhodo_class shape (grid 4x4x8, cap 368,
// 47,104 slots, ~250 atoms a cell) each valid slot tests 27 x ~250 ~ 6,750
// candidates, ~2.2e8 distance tests a build, of which ~10 % land in the
// list (~705 a row).  The output is the list itself, 47,104 x K ~ 960
// words (~181 MB), which at 3.35 TB/s is ~0.054 ms; the distance tests, ~10
// operations each, take ~0.03 ms at the f32 peak but ~40 instructions a
// warp per 32 candidates in this design.  It runs once per re-bin (55 per
// 500 steps on rhodo_class), against the force kernel's ~1,100 launches.
// At the chain and chute shapes (53,240 and 54,432 slots, 24 and 16 atoms
// a cell, K 24 and 16) a row is 27 chunks of 32 candidates, most lanes of
// each idle.
//
// Design: one warp per i slot.  The warp walks the 27 stencil cells as B5
// did, 32 consecutive j slots at a time (one coalesced 384-byte read of x)
// up to the cell's extent (a re-bin fills each cell from its first
// slot: ~250 of cap 368 at 32k, 8 chunks a cell instead of 12), tests r2 <
// cutneigh^2 and the exclusions on each lane, and appends the hits in
// order: __ballot_sync gives the chunk's hit mask, __popc of the lanes
// below gives each hit's place, and the warp's running count the row's
// end.
// The codes cost a ballot per chunk with hits, not a walk per hit: i's S
// special slots sit in shared memory, one per lane, and a ballot of those
// that fall in the chunk's 32 slots (usually none) leaves a few entries
// to hand their code to the lane holding that slot.  The padding is
// written by the whole warp, 32 words a step.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxExcl = 4;    // neigh_modify exclude group pairs

// the group-bit pairs whose pairs the list drops
struct Exclusions {
  int n;
  int b1[kMaxExcl], b2[kMaxExcl];
};

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

// PERIODIC: every axis periodic (the offsets -1..1 on each, known at
// compile time); EXCLUDE: some group-bit pairs to drop
template <typename T, bool PERIODIC, bool EXCLUDE>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
cellgrid_pairlist_kernel(const T* __restrict__ x,
                         const unsigned char* __restrict__ valid,
                         const int* __restrict__ sslots,
                         const int* __restrict__ scodes, int S,
                         const int* __restrict__ extent,
                         const T* __restrict__ lengths,
                         const int* __restrict__ gmask, const Exclusions ex,
                         int* __restrict__ pairs, int* __restrict__ npairs,
                         int* __restrict__ stat, int nx, int ny, int nz,
                         int cap, int px, int py, int pz, int K, T cutsq) {
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
    const int gi = EXCLUDE ? gmask[i] : 0;
    if (PERIODIC) px = py = pz = 1;
    int zlo, zhi, ylo, yhi, xlo, xhi;
    axis_range(nz, pz, &zlo, &zhi);
    axis_range(ny, py, &ylo, &yhi);
    axis_range(nx, px, &xlo, &xhi);
    for (int oz = zlo; oz <= zhi; ++oz) {
      T shz;
      const int jz = wrap(cz, oz, nz, pz, Lz, &shz);
      for (int oy = ylo; oy <= yhi; ++oy) {
        T shy;
        const int jy = wrap(cy, oy, ny, py, Ly, &shy);
        for (int ox = xlo; ox <= xhi; ++ox) {
          T shx;
          const int jx = wrap(cx, ox, nx, px, Lx, &shx);
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
              if (EXCLUDE && hit) {
                const int gj = gmask[js];
                for (int e = 0; e < ex.n; ++e) {
                  hit &= !(((gi & ex.b1[e]) && (gj & ex.b2[e])) ||
                           ((gi & ex.b2[e]) && (gj & ex.b1[e])));
                }
              }
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
           const int* gmask, const Exclusions& ex, int* pairs, int* npairs,
           int* stat, int nx, int ny, int nz, int cap, int px, int py,
           int pz, int K, double cutsq, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || cap < 1 || K < 1 || S < 0 ||
      (ex.n && gmask == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long np = static_cast<long long>(nx) * ny * nz * cap;
  const bool periodic = px && py && pz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((np + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  const dim3 block(32 * kWarpsPerBlock);
  const size_t smem = 2 * static_cast<size_t>(S) * kWarpsPerBlock *
                      sizeof(int);
  auto kernel = periodic ? (ex.n ? cellgrid_pairlist_kernel<T, true, true>
                                 : cellgrid_pairlist_kernel<T, true, false>)
                         : (ex.n ? cellgrid_pairlist_kernel<T, false, true>
                                 : cellgrid_pairlist_kernel<T, false, false>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, block, smem, s>>>(
      x, valid, sslots, scodes, S, extent, lengths, gmask, ex, pairs, npairs,
      stat, nx, ny, nz, cap, px, py, pz, K, T(cutsq));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes by tpumd_torch/ops/cellgrid_pairlist.py.
// sslots / scodes may be null when S = 0, gmask when nexcl = 0; periodic:
// px, py, pz; excl: nexcl (b1, b2) group-bit pairs, flattened, in host
// memory.  Returns the CUDA error code of the launch (0 on success).
#define TPUMD_PAIRLIST_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const T* x, const unsigned char* valid,               \
                      const int* sslots, const int* scodes, int S,          \
                      const int* extent, const T* lengths,                  \
                      const int* gmask, int nexcl, const int* excl,         \
                      int* pairs, int* npairs, int* stat, int nx, int ny,   \
                      int nz, int cap, int px, int py, int pz, int K,       \
                      double cutsq, void* stream) {                         \
    if (nexcl < 0 || nexcl > kMaxExcl) {                                     \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    }                                                                        \
    Exclusions ex{nexcl, {0}, {0}};                                          \
    for (int e = 0; e < nexcl; ++e) {                                        \
      ex.b1[e] = excl[2 * e];                                                \
      ex.b2[e] = excl[2 * e + 1];                                            \
    }                                                                        \
    return launch<T>(x, valid, sslots, scodes, S, extent, lengths, gmask,    \
                     ex, pairs, npairs, stat, nx, ny, nz, cap, px, py, pz,   \
                     K, cutsq, stream);                                      \
  }

TPUMD_PAIRLIST_ENTRY(tpumd_cellgrid_pairlist_f32, float)
TPUMD_PAIRLIST_ENTRY(tpumd_cellgrid_pairlist_f64, double)
