// The cell grid's pair list at cutneigh, built at every re-bin and
// refreshed between re-bins where it could be stale, on Hopper (sm_90a).
//
// Takes the candidate search out of the Pallas TPU kernels
// tpumd/ops/pallas_lj.py::_kernel (B1) and ::_kernel_fene (B2),
// tpumd/ops/pallas_eam.py::_force_kernel (B4),
// tpumd/ops/pallas_charmm.py::_kernel (B5) and tpumd/ops/pallas_gran.py::
// _kernel (B6), which tested every slot of the 27-cell stencil at each
// force evaluation; here that search runs once per re-bin, or per refresh,
// and the force kernels (lj_fene_cellgrid.cu for B1 and B2,
// eam_cellgrid.cu, charmm_cellgrid.cu, gran_cellgrid.cu) sweep the list.
// It serves any grid the stencil takes: periodic or not on each axis.
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
// overflowed; xhold, where given, takes x and boxhold the box corners lo
// and hi: the positions the list is held to until its next build.
//
// The refresh (pairlist_moved_kernel and cellgrid_pairlist_gated_kernel,
// two launches from one call, at each force evaluation where the schedule
// leaves the list unchecked: check no, the steps before the delay, every >
// 1) keeps the list complete, so a list sweep sums the same pairs as the
// stencil: where some valid atom moved more than skin/2 (less the box's
// move, under a fix that moves the box) since the list's build, it
// rebuilds every row in place from the standing bins.  A pair within the
// cutoff now was within cutoff + skin = cutneigh of the stencil's
// candidates then.  The decision stays on the card: the first launch
// writes the call's stamp to stat[3] where some atom moved too far, and
// the second builds only where stat[3] holds the stamp, counting the
// refresh in stat[2].
//
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
// written by the whole warp, 32 words a step.  The refresh's build
// launches as many blocks as the card holds at once, its warps striding
// over the slots; where no atom moved too far the refresh reads x and
// xhold once (~1.3 MB at the 32k in.lj shape) and its build's blocks
// return after one read of stat[3].  (One cooperative launch, the flag, a
// grid-wide sync and the build, took as long a step and 2 us more on the
// card: PERF.md.)

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMovedBlock = 256;   // threads of the refresh's first launch
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
__device__ __forceinline__ float rint_t(float a) { return rintf(a); }
__device__ __forceinline__ double rint_t(double a) { return rint(a); }

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

template <typename T>
struct BuildArgs {
  const T* x;
  const unsigned char* valid;
  const int* sslots;
  const int* scodes;
  int S;
  const int* extent;
  const T* lengths;
  const T* lo;           // the box corners, read where boxhold is written
  const T* hi;
  const int* gmask;
  Exclusions ex;
  int* pairs;
  int* npairs;
  int* stat;             // longest row, overflow, refreshes, gate stamp
  T* xhold;              // null, or x copied at the build (slots, 3)
  T* boxhold;            // null, or lo and hi copied at the build (6)
  int nx, ny, nz, cap, px, py, pz, K;
  T cutsq;
};

// the box corners of the build, by the first threads of block 0
template <typename T>
__device__ __forceinline__ void hold_box(const BuildArgs<T>& a) {
  if (a.boxhold != nullptr && blockIdx.x == 0 && threadIdx.x < 3) {
    a.boxhold[threadIdx.x] = a.lo[threadIdx.x];
    a.boxhold[3 + threadIdx.x] = a.hi[threadIdx.x];
  }
}

// Slot i's row, by the 32 lanes of one warp; wslot / wcode are the warp's
// shared memory for i's special entries.  PERIODIC: every axis periodic
// (the offsets -1..1 on each, known at compile time); EXCLUDE: some
// group-bit pairs to drop.
template <typename T, bool PERIODIC, bool EXCLUDE>
__device__ __forceinline__ void build_row(const BuildArgs<T>& a, long long i,
                                          int lane, int* wslot, int* wcode) {
  const int S = a.S;
  for (int s = lane; s < S; s += 32) {
    wslot[s] = a.sslots[i * S + s];
    wcode[s] = a.scodes[i * S + s];
  }
  __syncwarp();

  const int nx = a.nx, ny = a.ny, nz = a.nz, cap = a.cap, K = a.K;
  int* row = a.pairs + i * K;
  int count = 0;
  if (a.valid[i]) {
    const T* x = a.x;
    const int cell = static_cast<int>(i / cap);
    const int t = static_cast<int>(i % cap);
    const int cx = cell % nx;
    const int cy = (cell / nx) % ny;
    const int cz = cell / (nx * ny);
    const T xi = x[3 * i + 0], yi = x[3 * i + 1], zi = x[3 * i + 2];
    const T Lx = a.lengths[0], Ly = a.lengths[1], Lz = a.lengths[2];
    const int gi = EXCLUDE ? a.gmask[i] : 0;
    int px = a.px, py = a.py, pz = a.pz;
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
          const int jn = a.extent[jcell];
          const int self = (ox == 0 && oy == 0 && oz == 0) ? t : -1;
          for (int k0 = 0; k0 < jn; k0 += 32) {
            const int k = k0 + lane;
            const long long js = jbase + k;
            bool hit = false;
            if (k < jn && k != self && a.valid[js]) {
              const T dx = sub_rn(xi, add_rn(x[3 * js + 0], shx));
              const T dy = sub_rn(yi, add_rn(x[3 * js + 1], shy));
              const T dz = sub_rn(zi, add_rn(x[3 * js + 2], shz));
              const T r2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)),
                                  mul_rn(dz, dz));
              hit = r2 < a.cutsq;
              if (EXCLUDE && hit) {
                const int gj = a.gmask[js];
                for (int e = 0; e < a.ex.n; ++e) {
                  hit &= !(((gi & a.ex.b1[e]) && (gj & a.ex.b2[e])) ||
                           ((gi & a.ex.b2[e]) && (gj & a.ex.b1[e])));
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
    a.npairs[i] = count < K ? count : K;
    atomicMax(a.stat, count);
    if (count > K) a.stat[1] = 1;
  }
  if (a.xhold != nullptr && lane < 3) a.xhold[3 * i + lane] = a.x[3 * i + lane];
  __syncwarp();  // the warp's next row reuses wslot / wcode
}

// The build at a re-bin: one warp per slot.
template <typename T, bool PERIODIC, bool EXCLUDE>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
cellgrid_pairlist_kernel(const BuildArgs<T> a) {
  extern __shared__ int spec[];  // per warp: S slots, then S codes
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long np = static_cast<long long>(a.nx) * a.ny * a.nz * a.cap;
  const long long i =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  hold_box(a);
  if (i >= np) return;  // the whole warp: i depends on the warp only
  build_row<T, PERIODIC, EXCLUDE>(a, i, lane, spec + 2 * a.S * warp,
                                  spec + 2 * a.S * warp + a.S);
}

// Whether some valid atom of this thread's slots (striding over the grid)
// moved more than delta since the list's build (xhold; delta = skin/2,
// with BOXTERM less half the box corners' move since boxhold, as
// ops/cellgrid.py::displacement_exceeded computes it).
template <typename T, bool PERIODIC, bool BOXTERM>
__device__ __forceinline__ bool moved_since_build(const BuildArgs<T>& a,
                                                  T skin) {
  const long long np = static_cast<long long>(a.nx) * a.ny * a.nz * a.cap;
  const T Lx = a.lengths[0], Ly = a.lengths[1], Lz = a.lengths[2];
  T delta = T(0.5) * skin;
  if (BOXTERM) {
    T dl = T(0), dh = T(0);
    for (int c = 0; c < 3; ++c) {
      const T l = a.lo[c] - a.boxhold[c], h = a.hi[c] - a.boxhold[3 + c];
      dl += l * l;
      dh += h * h;
    }
    delta = T(0.5) * (skin - (sqrt(dl) + sqrt(dh)));
    if (delta < T(0)) delta = T(0);
  }
  const T lim = delta * delta;
  const bool mx = PERIODIC || a.px, my = PERIODIC || a.py,
             mz = PERIODIC || a.pz;
  bool moved = false;
  for (long long s = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       s < np; s += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (!a.valid[s]) continue;
    T dx = a.x[3 * s + 0] - a.xhold[3 * s + 0];
    T dy = a.x[3 * s + 1] - a.xhold[3 * s + 1];
    T dz = a.x[3 * s + 2] - a.xhold[3 * s + 2];
    if (mx) dx -= Lx * rint_t(dx / Lx);
    if (my) dy -= Ly * rint_t(dy / Ly);
    if (mz) dz -= Lz * rint_t(dz / Lz);
    moved |= dx * dx + dy * dy + dz * dz > lim;
  }
  return moved;
}

// The rebuild of every row by the warps of a grid striding over the
// slots, counted as a refresh in stat[2].
template <typename T, bool PERIODIC, bool EXCLUDE>
__device__ __forceinline__ void refresh_rows(const BuildArgs<T>& a,
                                             int* spec) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long np = static_cast<long long>(a.nx) * a.ny * a.nz * a.cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) a.stat[2] += 1;
  hold_box(a);
  for (long long i = static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
                     warp;
       i < np; i += static_cast<long long>(gridDim.x) * kWarpsPerBlock) {
    build_row<T, PERIODIC, EXCLUDE>(a, i, lane, spec + 2 * a.S * warp,
                                    spec + 2 * a.S * warp + a.S);
  }
}

// The refresh, two launches: the first writes the launch pair's stamp to
// stat[3] where some atom moved too far (moved_since_build), the second
// rebuilds every row where stat[3] holds it and otherwise returns at once
// (no reset is needed: each refresh brings a new stamp).
template <typename T, bool PERIODIC, bool BOXTERM>
__global__ void __launch_bounds__(kMovedBlock)
pairlist_moved_kernel(const BuildArgs<T> a, T skin, int stamp) {
  const bool moved = moved_since_build<T, PERIODIC, BOXTERM>(a, skin);
  if (__syncthreads_or(moved) && threadIdx.x == 0) a.stat[3] = stamp;
}

template <typename T, bool PERIODIC, bool EXCLUDE>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
cellgrid_pairlist_gated_kernel(const BuildArgs<T> a, int stamp) {
  extern __shared__ int spec[];
  if (a.stat[3] != stamp) return;  // the whole block: one word
  refresh_rows<T, PERIODIC, EXCLUDE>(a, spec);
}

// the dynamic shared memory of a launch; raises the kernel's limit where
// it passes the default 48 KB
template <typename K>
cudaError_t shared_bytes(K kernel, int S, size_t* smem) {
  *smem = 2 * static_cast<size_t>(S) * kWarpsPerBlock * sizeof(int);
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <typename T>
int launch(const BuildArgs<T>& a, void* stream) {
  if (a.nx < 1 || a.ny < 1 || a.nz < 1 || a.cap < 1 || a.K < 1 || a.S < 0 ||
      (a.ex.n && a.gmask == nullptr) ||
      (a.boxhold != nullptr && (a.lo == nullptr || a.hi == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long np = static_cast<long long>(a.nx) * a.ny * a.nz * a.cap;
  const bool periodic = a.px && a.py && a.pz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((np + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  const dim3 block(32 * kWarpsPerBlock);
  auto kernel = periodic ? (a.ex.n ? cellgrid_pairlist_kernel<T, true, true>
                                   : cellgrid_pairlist_kernel<T, true, false>)
                         : (a.ex.n ? cellgrid_pairlist_kernel<T, false, true>
                                   : cellgrid_pairlist_kernel<T, false, false>);
  size_t smem;
  const cudaError_t err = shared_bytes(kernel, a.S, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, block, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PERIODIC, bool EXCLUDE, bool BOXTERM>
int launch_refresh_one(const BuildArgs<T>& a, T skin, int stamp,
                       cudaStream_t s) {
  auto gated = cellgrid_pairlist_gated_kernel<T, PERIODIC, EXCLUDE>;
  size_t smem;
  cudaError_t err = shared_bytes(gated, a.S, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the gated build: as many blocks as the card holds at once, found once
  // per instantiation, device and shared size
  static int resident = 0, on_dev = -1;
  static size_t for_smem = 0;
  int dev;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (dev != on_dev || smem != for_smem) {
    int nsm, per_sm;
    if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, gated, 32 * kWarpsPerBlock, smem)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    resident = per_sm * nsm;
    on_dev = dev;
    for_smem = smem;
  }
  const long long np = static_cast<long long>(a.nx) * a.ny * a.nz * a.cap;
  long long blocks = (np + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long moved_blocks = (np + kMovedBlock - 1) / kMovedBlock;
  pairlist_moved_kernel<T, PERIODIC, BOXTERM>
      <<<static_cast<unsigned>(moved_blocks), kMovedBlock, 0, s>>>(a, skin,
                                                                  stamp);
  if ((err = cudaGetLastError()) != cudaSuccess) {
    return static_cast<int>(err);
  }
  gated<<<static_cast<unsigned>(blocks), 32 * kWarpsPerBlock, smem, s>>>(
      a, stamp);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_refresh(const BuildArgs<T>& a, double skin, int stamp,
                   int boxterm, void* stream) {
  if (a.nx < 1 || a.ny < 1 || a.nz < 1 || a.cap < 1 || a.K < 1 || a.S < 0 ||
      (a.ex.n && a.gmask == nullptr) || a.xhold == nullptr ||
      (boxterm && (a.boxhold == nullptr || a.lo == nullptr ||
                   a.hi == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool periodic = a.px && a.py && a.pz;
  const T sk = T(skin);
#define TPUMD_REFRESH(P, E, B)                                               \
  if (periodic == P && (a.ex.n != 0) == E && (boxterm != 0) == B)           \
    return launch_refresh_one<T, P, E, B>(a, sk, stamp, s);
  TPUMD_REFRESH(true, false, false)
  TPUMD_REFRESH(true, false, true)
  TPUMD_REFRESH(true, true, false)
  TPUMD_REFRESH(true, true, true)
  TPUMD_REFRESH(false, false, false)
  TPUMD_REFRESH(false, false, true)
  TPUMD_REFRESH(false, true, false)
  TPUMD_REFRESH(false, true, true)
#undef TPUMD_REFRESH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The refresh's arguments that stay fixed between re-bins, kept on the
// host by tpumd_cellgrid_pairlist_refresh_prepare_* so that a step's call
// passes only what changes (a call of the entry with every argument costs
// the host ~10 us in ctypes alone, once a step).
template <typename T>
struct Refresh {
  BuildArgs<T> a;
  double skin;
  int boxterm;
};

template <typename T>
int refresh_run(void* handle, const T* x, const T* lengths, const T* lo,
                const T* hi, int stamp, void* stream) {
  if (handle == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Refresh<T>& r = *static_cast<const Refresh<T>*>(handle);
  BuildArgs<T> a = r.a;
  a.x = x;
  a.lengths = lengths;
  a.lo = lo;
  a.hi = hi;
  return launch_refresh<T>(a, r.skin, stamp, r.boxterm, stream);
}

}  // namespace

// C interface, bound with ctypes by tpumd_torch/ops/cellgrid_pairlist.py.
// sslots / scodes may be null when S = 0, gmask when nexcl = 0, xhold
// and boxhold (with lo, hi) for a build that keeps no hold; periodic:
// px, py, pz; excl: nexcl (b1, b2) group-bit pairs, flattened, in host
// memory.  The build entry returns the CUDA error code of its launch (0
// on success); skin, stamp and boxterm are the refresh's.  The prepare
// entry takes the same arguments and keeps those of the refresh that stay
// fixed between re-bins (everything but x, lengths, lo, hi, stamp and the
// stream), returning a handle (null on bad input) for the refresh entry,
// which launches the refresh on the positions, the box and the stamp given
// (the trigger takes the box's move where boxterm was set), and for the
// release entry, which frees it.
#define TPUMD_PAIRLIST_ARGS(T)                                               \
  const T *x, const unsigned char *valid, const int *sslots,                \
      const int *scodes, int S, const int *extent, const T *lengths,        \
      const T *lo, const T *hi, const int *gmask, int nexcl,                \
      const int *excl, int *pairs, int *npairs, int *stat, T *xhold,        \
      T *boxhold, int nx, int ny, int nz, int cap, int px, int py, int pz,  \
      int K, double cutsq, double skin, int stamp, int boxterm, void *stream

#define TPUMD_PAIRLIST_BUILD_ARGS(T)                                         \
  BuildArgs<T> a{x,     valid,   sslots, scodes, S,      extent, lengths,    \
                 lo,    hi,      gmask,  {nexcl, {0}, {0}},                  \
                 pairs, npairs,  stat,   xhold,  boxhold, nx,    ny,         \
                 nz,    cap,     px,     py,     pz,      K,     T(cutsq)};   \
  for (int e = 0; e < nexcl; ++e) {                                          \
    a.ex.b1[e] = excl[2 * e];                                                \
    a.ex.b2[e] = excl[2 * e + 1];                                            \
  }

#define TPUMD_PAIRLIST_ENTRIES(SUFFIX, T)                                    \
  extern "C" int tpumd_cellgrid_pairlist_##SUFFIX(TPUMD_PAIRLIST_ARGS(T)) { \
    if (nexcl < 0 || nexcl > kMaxExcl) {                                     \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    }                                                                        \
    TPUMD_PAIRLIST_BUILD_ARGS(T)                                             \
    return launch<T>(a, stream);                                             \
  }                                                                          \
  extern "C" void* tpumd_cellgrid_pairlist_refresh_prepare_##SUFFIX(        \
      TPUMD_PAIRLIST_ARGS(T)) {                                              \
    if (nexcl < 0 || nexcl > kMaxExcl || xhold == nullptr ||                 \
        (boxterm && boxhold == nullptr)) {                                   \
      return nullptr;                                                        \
    }                                                                        \
    TPUMD_PAIRLIST_BUILD_ARGS(T)                                             \
    return new Refresh<T>{a, skin, boxterm};                                 \
  }                                                                          \
  extern "C" int tpumd_cellgrid_pairlist_refresh_##SUFFIX(                   \
      void* handle, const T* x, const T* lengths, const T* lo, const T* hi,  \
      int stamp, void* stream) {                                             \
    return refresh_run<T>(handle, x, lengths, lo, hi, stamp, stream);        \
  }                                                                          \
  extern "C" void tpumd_cellgrid_pairlist_refresh_release_##SUFFIX(          \
      void* handle) {                                                        \
    delete static_cast<Refresh<T>*>(handle);                                 \
  }

TPUMD_PAIRLIST_ENTRIES(f32, float)
TPUMD_PAIRLIST_ENTRIES(f64, double)
