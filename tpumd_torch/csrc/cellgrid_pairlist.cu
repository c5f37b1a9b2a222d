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
// packing), code the largest code among i's special entries naming j;
// npairs[i] = min(count, K), and the row past it is left as it was (no
// reader goes there); stat[0] takes the longest count (atomicMax),
// stat[1] = 1 where a row overflowed; xhold, where given, takes x and
// boxhold the box corners lo and hi: the positions the list is held to
// until its next build.
//
// The refresh (pairlist_moved_kernel, then cellgrid_pairlist_kernel with
// the call's stamp: two launches from one call, at each force evaluation
// where the schedule leaves the list unchecked: check no, the steps
// before the delay, every > 1) keeps the list complete, so a list sweep
// sums the same pairs as the stencil: where some valid atom moved more
// than skin/2 (less the box's move, under a fix that moves the box) since
// the list's build, it rebuilds every row in place from the standing
// bins.  A pair within the cutoff now was within cutoff + skin = cutneigh
// of the stencil's candidates then.  The decision stays on the card: the
// first launch writes the call's stamp to stat[3] where some atom moved
// too far, and the second builds only where stat[3] holds the stamp,
// counting the refresh in stat[2].
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
// list (~705 a row).  The output is the list's live entries, ~22.6 million
// words (~90 MB), which at 3.35 TB/s is ~0.027 ms; the distance tests, ~9
// operations each, take ~0.03 ms at the f32 peak, and ~12 instructions a
// candidate on one lane.  At the chain, in.lj, eam and chute shapes
// (53,240-55,296 slots, 16-25 atoms a cell) a slot has ~400-700
// candidates and 12-75 entries.  The build runs once per re-bin, and its
// gate at every unchecked step.
//
// Design: one block per tile, the slots of a cell or of a part of one.
// The block stages the 27 neighbour cells into shared memory, up to each
// cell's extent, in 9 stages of 3 cells (the x offsets of one (z, y)
// offset), with the wrap shift applied: coordinates and, under EXCLUDE,
// the group bits, an empty slot's x set to +inf so that its r2 fails the
// cutoff test with no flag.  The stages are double-buffered: cp.async
// copies the next stage's coordinates, group bits and validity bytes (as
// 4-byte words) while the block tests the current one, and one pass by
// the copying threads applies the shift (rounded as the plain version
// rounds x_j + L) and the sentinel.  Every slot of the tile then tests the
// same candidates, read from shared memory as broadcasts, kBatch at a time
// so that their loads and arithmetic overlap, and the block stays
// converged.  G lanes per slot, a template parameter, by this rule on cell
// occupancy: G = 1 where a cell holds at most kSmallCap slots (chain,
// in.lj, eam, chute: a slot's serial walk of ~27 x 20 candidates is short)
// and 32 of its rows fit in shared memory, else G = kLanesBuild
// (rhodo_class's ~250-atom cells, whose 4x4x8 grid is also fewer cells
// than the card's 132 SMs).  With G = 1 a tile is kTile1 slots, a thread
// each, which appends its hits in order to its row in shared memory by a
// predicated store (a stride of K | 1 words keeps the appends on distinct
// banks); the tile's rows are then written out by warps, a row's live
// entries coalesced.  With G > 1 a tile is kWideBlock / G slots (which
// also bounds the shared memory that their special entries take): lane l
// of a slot tests candidates l, l + G, ... and a ballot within the G-lane
// group orders the hits, written straight to the row.  The codes cost a
// walk of i's S special slots (kept in shared memory) per cell, and one
// more per hit only in the cells that hold one of them.  Tiles run part by
// part, so the cells' first parts, which hold their atoms, come first.
// Only live entries are written: a row's tail past npairs[i] is left as it
// was.  The refresh's build is the same kernel, launched on as many blocks
// as the card holds at once, striding over the tiles; where no atom moved
// too far the refresh reads x and xhold once (~1.3 MB at the 32k in.lj
// shape) and its build's blocks return after one read of stat[3].  (One
// cooperative launch, the flag, a grid-wide sync and the build, took as
// long a step and 2 us more on the card: PERF.md.)  What holds the design
// above its bound (PERF.md): a G = 1 tile is one warp that walks its 9
// stages in a chain of dependent shared loads, copies and barriers, and
// the small decks give the card ~10-13 such warps an SM, too few to hide
// that chain.

#include <cuda_runtime.h>

#include "device_limits.cuh"

namespace {

constexpr int kLanesBuild = 16;    // lanes per slot on large cells
constexpr int kSmallCap = 64;      // cells of at most this many slots: G = 1
constexpr int kWideBlock = 256;    // threads of a block where G > 1
constexpr int kTile1 = 32;         // slots (and threads) of a tile where G = 1
constexpr int kBatch = 4;         // candidates a thread tests at once
constexpr int kCells = 27;         // the stencil's neighbour cells
constexpr int kRow = 3;            // of them a stage: the x offsets
constexpr int kCenter = 13;        // the offset (0, 0, 0) among the 27
constexpr int kMovedBlock = 256;   // threads of the refresh's first launch
constexpr int kMaxExcl = 4;    // neigh_modify exclude group pairs

static_assert(kLanesBuild > 1 && kLanesBuild <= 32 &&
                  (kLanesBuild & (kLanesBuild - 1)) == 0 &&
                  kWideBlock % 32 == 0 && kWideBlock / kLanesBuild >= 1,
              "kLanesBuild must be a power of two from 2 to a warp");

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
// +inf (an empty candidate's x) and a NaN (an empty slot's own x): no r2
// made with either passes the cutoff test
__device__ __forceinline__ float inf_t(float) {
  return __int_as_float(0x7f800000);
}
__device__ __forceinline__ double inf_t(double) {
  return __longlong_as_double(0x7ff0000000000000LL);
}
__device__ __forceinline__ float nan_t(float) {
  return __int_as_float(0x7fc00000);
}
__device__ __forceinline__ double nan_t(double) {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// cp.async of one element, or of a 4-byte word of which only the first
// bytes are read (the rest of the destination zeroed)
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_async(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_async(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_word_async(unsigned* dst,
                                                const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
  int lanes;             // G forced (1 or kLanesBuild), or 0: the rule
};

// a staged candidate: its coordinates with the wrap shift applied (x =
// +inf where the slot is empty) and its group bits
template <typename T>
struct __align__(16) Cand {
  T x, y, z;
  int g;
};

// The byte offsets of a block's dynamic shared memory, for tiles of tile
// slots: two stage buffers, each of the candidates (3 cap) and the
// validity words of a stage's three cells, the tile's special slots and
// codes and, where G = 1, its row counts and rows (a stride of K | 1
// words).
struct Layout {
  size_t cand, vwords, sslot, scode, count, rows, total;
  int nvw, stride;
};

template <typename T>
__host__ __device__ inline Layout layout(int cap, int tile, int S, int K,
                                         int G) {
  Layout l;
  l.nvw = (cap + 3) / 4 + 1;  // a cell's validity words
  l.stride = K | 1;
  l.cand = 0;
  l.vwords = 2 * kRow * static_cast<size_t>(cap) * sizeof(Cand<T>);
  size_t off = l.vwords + 2 * kRow * static_cast<size_t>(l.nvw) * 4;
  l.sslot = off;
  off += static_cast<size_t>(tile) * S * 4;
  l.scode = off;
  off += static_cast<size_t>(tile) * S * 4;
  l.count = off;
  l.rows = off + (G == 1 ? static_cast<size_t>(tile) * 4 : 0);
  l.total = l.rows + (G == 1 ? static_cast<size_t>(tile) * l.stride * 4 : 0);
  return l;
}

// whether a group-bit pair drops the pair (i, j)
__device__ __forceinline__ bool excluded(int gi, int gj,
                                         const Exclusions& ex) {
  bool out = false;
  for (int e = 0; e < ex.n; ++e) {
    out |= ((gi & ex.b1[e]) && (gj & ex.b2[e])) ||
           ((gi & ex.b2[e]) && (gj & ex.b1[e]));
  }
  return out;
}

// the code of the entry js among i's S special slots (sl) and codes (sc)
__device__ __forceinline__ int special_code(const int* sl, const int* sc,
                                            int S, int js) {
  int code = 0;
  for (int s = 0; s < S; ++s) {
    if (sl[s] == js && sc[s] > code) code = sc[s];
  }
  return code;
}

// |x_i - x_j|^2 of a staged candidate, rounded op by op as the plain
// version rounds it (no contraction), so both find the same pairs
template <typename T>
__device__ __forceinline__ T dist2(T xi, T yi, T zi, const Cand<T>& q) {
  const T dx = sub_rn(xi, q.x), dy = sub_rn(yi, q.y), dz = sub_rn(zi, q.z);
  return add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
}

__device__ __forceinline__ int pack(int js, int code) {
  return static_cast<int>(static_cast<unsigned>(js) |
                          (static_cast<unsigned>(code) << 30));
}

// The build: each block takes tiles of tile slots of a cell (parts tiles a
// cell, ntiles in all), striding over them; with stamp != 0 (the refresh's
// second launch) it returns at once unless stat[3] holds the stamp, and
// then counts the refresh in stat[2].  G lanes a slot; PERIODIC: every
// axis periodic (the offsets -1..1 on each, known at compile time);
// EXCLUDE: some group-bit pairs to drop.
template <typename T, int G, bool PERIODIC, bool EXCLUDE>
__global__ void __launch_bounds__(kWideBlock) cellgrid_pairlist_kernel(
    const BuildArgs<T> a, int tile, int parts, long long ntiles,
    int stamp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the 27 neighbour cells in stencil order (z, y, x offsets), kRow of
  // them (the x offsets) a stage: each cell's first slot, its extent (0
  // where a non-periodic axis drops the offset), its place in its
  // stage's buffer and its wrap shift; the stages that hold a cell
  __shared__ int nb_base[kCells], nb_n[kCells], nb_off[kCells];
  __shared__ T nb_shift[3 * kCells];
  __shared__ int st_row[kCells / kRow], st_count;
  if (stamp != 0) {
    if (a.stat[3] != stamp) return;  // the whole block: one word
    if (blockIdx.x == 0 && threadIdx.x == 0) a.stat[2] += 1;
  }
  if (a.boxhold != nullptr && blockIdx.x == 0 && threadIdx.x < 3) {
    a.boxhold[threadIdx.x] = a.lo[threadIdx.x];
    a.boxhold[3 + threadIdx.x] = a.hi[threadIdx.x];
  }
  const int S = a.S, K = a.K, cap = a.cap;
  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const long long np = static_cast<long long>(nx) * ny * nz * cap;
  const Layout lay = layout<T>(cap, tile, S, K, G);
  // stage buffer b: candidates cand + b kRow cap, validity words
  // vwords + (b kRow + cell of the stage) nvw
  Cand<T>* cand = reinterpret_cast<Cand<T>*>(smem_raw + lay.cand);
  unsigned* vwords = reinterpret_cast<unsigned*>(smem_raw + lay.vwords);
  int* sslot = reinterpret_cast<int*>(smem_raw + lay.sslot);
  int* scode = reinterpret_cast<int*>(smem_raw + lay.scode);
  int* scount = reinterpret_cast<int*>(smem_raw + lay.count);
  int* srows = reinterpret_cast<int*>(smem_raw + lay.rows);

  const int nthr = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t % G;
  const int li = t / G;  // the thread's slot in the tile
  const int gbase = (t & 31) & ~(G - 1);
  const unsigned gbits = 0xffffffffu >> (32 - G);
  const T Lx = a.lengths[0], Ly = a.lengths[1], Lz = a.lengths[2];

  const long long ncells = ntiles / parts;
  // tiles part by part, so that the first parts of the cells, which hold
  // their atoms, come first and a block striding over the tiles meets
  // the mostly empty later parts last
  for (long long tix = blockIdx.x; tix < ntiles; tix += gridDim.x) {
    const int cell = static_cast<int>(tix % ncells);
    const int first = static_cast<int>(tix / ncells) * tile;
    const long long cbase = static_cast<long long>(cell) * cap;
    __syncthreads();  // the previous tile's shared memory is consumed
    // the neighbour cells and the stages, by the first warp
    if (t < 32) {
      int jb = 0, jn = 0;
      T shx = T(0), shy = T(0), shz = T(0);
      if (t < kCells) {
        const int oz = t / 9 - 1, oy = (t / 3) % 3 - 1, ox = t % 3 - 1;
        const int pxa = PERIODIC || a.px, pya = PERIODIC || a.py,
                  pza = PERIODIC || a.pz;
        int zlo, zhi, ylo, yhi, xlo, xhi;
        axis_range(nz, pza, &zlo, &zhi);
        axis_range(ny, pya, &ylo, &yhi);
        axis_range(nx, pxa, &xlo, &xhi);
        if (oz >= zlo && oz <= zhi && oy >= ylo && oy <= yhi &&
            ox >= xlo && ox <= xhi) {
          const int cx = cell % nx, cy = (cell / nx) % ny,
                    cz = cell / (nx * ny);
          const int jz = wrap(cz, oz, nz, pza, Lz, &shz);
          const int jy = wrap(cy, oy, ny, pya, Ly, &shy);
          const int jx = wrap(cx, ox, nx, pxa, Lx, &shx);
          const int jcell = (jz * ny + jy) * nx + jx;
          jn = a.extent[jcell];
          jb = jcell * cap;
        }
        nb_base[t] = jb;
        nb_n[t] = jn;
        nb_shift[3 * t + 0] = shx;
        nb_shift[3 * t + 1] = shy;
        nb_shift[3 * t + 2] = shz;
      }
      // a cell's place in its stage: the extents of the cells before it
      const int r = t % kRow;
      const int n1 = __shfl_up_sync(0xffffffffu, jn, 1);
      const int n2 = __shfl_up_sync(0xffffffffu, jn, 2);
      const int off = (r >= 1 ? n1 : 0) + (r >= 2 ? n2 : 0);
      if (t < kCells) nb_off[t] = off;
      // the stages that hold an atom, in order
      const bool used = t < kCells && r == kRow - 1 && off + jn > 0;
      const unsigned m = __ballot_sync(0xffffffffu, used);
      if (used) st_row[__popc(m & ((1u << t) - 1u))] = t / kRow;
      if (t == 0) st_count = __popc(m);
    }
    // the tile's special slots and codes
    for (int e = t; e < tile * S; e += nthr) {
      const int ts = first + e / S;
      sslot[e] = ts < cap ? a.sslots[(cbase + ts) * S + e % S] : -1;
      scode[e] = ts < cap ? a.scodes[(cbase + ts) * S + e % S] : 0;
    }
    const int ext = a.extent[cell];
    __syncthreads();

    // this thread's slot
    const int ti = first + li;
    const bool active = li < tile && ti < cap;
    const long long i = cbase + ti;
    const bool ivalid = active && ti < ext && a.valid[i];
    const T xi = ivalid ? a.x[3 * i + 0] : nan_t(T(0));
    const T yi = ivalid ? a.x[3 * i + 1] : T(0);
    const T zi = ivalid ? a.x[3 * i + 2] : T(0);
    const int gi = (EXCLUDE && ivalid) ? a.gmask[i] : 0;
    const int* isl = sslot + li * S;
    const int* isc = scode + li * S;
    int* srow = srows + li * lay.stride;
    int* row = a.pairs + i * K;
    int count = 0;

    // a tile past the cell's extent holds no atom
    const int nst = first < ext ? st_count : 0;
    // stage s into buffer b (its three cells' coordinates, group bits and
    // validity words), committed as one group of copies
    auto fetch = [&](int s, int b) {
      for (int q = kRow * st_row[s]; q < kRow * st_row[s] + kRow; ++q) {
        const int jb = nb_base[q], n = nb_n[q];
        Cand<T>* c = cand + b * kRow * cap + nb_off[q];
        for (int k = t; k < n; k += nthr) {
          const T* src = a.x + 3 * (static_cast<long long>(jb) + k);
          copy_async(&c[k].x, src + 0);
          copy_async(&c[k].y, src + 1);
          copy_async(&c[k].z, src + 2);
          if (EXCLUDE) copy_async(&c[k].g, a.gmask + jb + k);
        }
        const long long w0 = jb >> 2;
        const int nw = static_cast<int>(((jb + n + 3LL) >> 2) - w0);
        unsigned* v = vwords + (b * kRow + q % kRow) * lay.nvw;
        for (int w = t; w < nw; w += nthr) {
          const long long byte = (w0 + w) * 4;
          const long long left = np - byte;
          copy_word_async(v + w, a.valid + byte,
                          static_cast<int>(left < 4 ? left : 4));
        }
      }
      copy_commit();
    };
    if (nst > 0) fetch(0, 0);
    for (int s = 0; s < nst; ++s) {
      const int b = s & 1;
      copy_wait();
      __syncthreads();  // stage s has landed; stage s - 1 is consumed
      if (s + 1 < nst) fetch(s + 1, b ^ 1);
      const int q0 = kRow * st_row[s];
      // the shift and the empty slots' sentinel, by the copying threads
      for (int q = q0; q < q0 + kRow; ++q) {
        const int jb = nb_base[q], n = nb_n[q];
        Cand<T>* c = cand + b * kRow * cap + nb_off[q];
        const unsigned char* v = reinterpret_cast<const unsigned char*>(
                                     vwords + (b * kRow + q % kRow) *
                                                  lay.nvw) +
                                 (jb & 3);
        const T sx = nb_shift[3 * q + 0], sy = nb_shift[3 * q + 1],
                sz = nb_shift[3 * q + 2];
        for (int k = t; k < n; k += nthr) {
          if (v[k]) {
            c[k].x = add_rn(c[k].x, sx);
            c[k].y = add_rn(c[k].y, sy);
            c[k].z = add_rn(c[k].z, sz);
          } else {
            c[k].x = inf_t(T(0));
          }
        }
      }
      __syncthreads();
      for (int q = q0; q < q0 + kRow; ++q) {
        const int jb = nb_base[q], n = nb_n[q];
        if (n == 0) continue;
        const Cand<T>* c = cand + b * kRow * cap + nb_off[q];
        const int self = q == kCenter ? ti : -1;
        // whether one of i's special slots lies in this cell
        bool spec = false;
        for (int e = lane; e < S; e += G) {
          spec |= isl[e] >= jb && isl[e] < jb + n;
        }
        if (G > 1) {
          spec = ((__ballot_sync(0xffffffffu, spec) >> gbase) & gbits) !=
                 0u;
        }
        // kBatch candidates an iteration: their distances are
        // independent, so their shared loads and arithmetic overlap
        auto hit = [&](int k, T r2, int gj) {
          return r2 < a.cutsq && k != self &&
                 !(EXCLUDE && excluded(gi, gj, a.ex));
        };
        if (G == 1) {
          // the append, branch-free but for a hit in a cell that holds
          // one of i's special partners: a predicated store and a count
          auto take = [&](int k, bool h) {
            int code = 0;
            if (h && spec) code = special_code(isl, isc, S, jb + k);
            if (h && count < K) srow[count] = pack(jb + k, code);
            count += h;
          };
          int k = 0;
          for (; k + kBatch <= n; k += kBatch) {
            T r2[kBatch];
            int gj[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              const Cand<T> p = c[k + u];
              r2[u] = dist2(xi, yi, zi, p);
              gj[u] = EXCLUDE ? p.g : 0;
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              take(k + u, hit(k + u, r2[u], gj[u]));
            }
          }
          for (; k < n; ++k) {
            take(k, hit(k, dist2(xi, yi, zi, c[k]), EXCLUDE ? c[k].g : 0));
          }
        } else {
          for (int k0 = 0; k0 < n; k0 += G * kBatch) {
            bool h[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              const int k = k0 + u * G + lane;
              h[u] = false;
              if (k < n) {
                const Cand<T> p = c[k];
                h[u] = hit(k, dist2(xi, yi, zi, p), EXCLUDE ? p.g : 0);
              }
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              const unsigned m =
                  (__ballot_sync(0xffffffffu, h[u]) >> gbase) & gbits;
              if (h[u]) {
                const int js = jb + k0 + u * G + lane;
                const int code = spec ? special_code(isl, isc, S, js) : 0;
                const int pos = count + __popc(m & ((1u << lane) - 1u));
                if (pos < K) row[pos] = pack(js, code);
              }
              count += __popc(m);
            }
          }
        }
      }
    }

    // the row's end, the longest row and the overflow flag
    if (active && lane == 0) {
      a.npairs[i] = count < K ? count : K;
      if (count > K) a.stat[1] = 1;
    }
    const int longest = __reduce_max_sync(0xffffffffu, count);
    if ((t & 31) == 0) atomicMax(a.stat, longest);
    if (a.xhold != nullptr && active) {
      for (int c = lane; c < 3; c += G) a.xhold[3 * i + c] = a.x[3 * i + c];
    }
    if (G == 1) {
      // the tile's rows out of shared memory, each row's live entries by
      // the lanes of a warp
      scount[li] = count < K ? count : K;
      __syncthreads();
      const int warp = t >> 5, wl = t & 31;
      for (int r = warp; r < tile && first + r < cap; r += nthr >> 5) {
        const int n = scount[r];
        int* out = a.pairs + (cbase + first + r) * K;
        const int* in = srows + r * lay.stride;
        for (int e = wl; e < n; e += 32) out[e] = in[e];
      }
    }
  }
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

// The refresh's first launch: writes the launch pair's stamp to stat[3]
// where some atom moved too far (moved_since_build); the second, the
// build with the stamp, rebuilds every row where stat[3] holds it and
// otherwise returns at once (no reset is needed: each refresh brings a
// new stamp).
template <typename T, bool PERIODIC, bool BOXTERM>
__global__ void __launch_bounds__(kMovedBlock)
pairlist_moved_kernel(const BuildArgs<T> a, T skin, int stamp) {
  const bool moved = moved_since_build<T, PERIODIC, BOXTERM>(a, skin);
  if (__syncthreads_or(moved) && threadIdx.x == 0) a.stat[3] = stamp;
}

// A build's launch shape: G lanes a slot, tiles of tile slots (parts a
// cell), the block's threads and shared bytes.
struct Plan {
  int G, tile, parts, block, dev;
  long long ntiles;
  size_t smem;
};

// The launch rule (the file's head comment), or the G the caller forces:
// cudaErrorInvalidValue for a G that is neither 1 nor kLanesBuild,
// cudaErrorInvalidConfiguration where a tile does not fit in shared
// memory.
template <typename T>
cudaError_t plan_build(const BuildArgs<T>& a, Plan* p) {
  int optin;
  const cudaError_t err = device_optin(&p->dev, &optin);
  if (err != cudaSuccess) return err;
  auto fits = [&](int G, int tile) {
    return layout<T>(a.cap, tile, a.S, a.K, G).total <=
           static_cast<size_t>(optin);
  };
  int G = a.lanes;
  if (G == 0) G = a.cap <= kSmallCap && fits(1, kTile1) ? 1 : kLanesBuild;
  if (G == 1) {
    p->tile = kTile1;
    p->block = kTile1;
  } else if (G == kLanesBuild) {
    p->tile = kWideBlock / G;
    p->block = kWideBlock;
  } else {
    return cudaErrorInvalidValue;
  }
  if (!fits(G, p->tile)) return cudaErrorInvalidConfiguration;
  p->G = G;
  p->parts = (a.cap + p->tile - 1) / p->tile;
  p->ntiles = static_cast<long long>(a.nx) * a.ny * a.nz * p->parts;
  p->smem = layout<T>(a.cap, p->tile, a.S, a.K, G).total;
  return cudaSuccess;
}

// Launch the build (stamp 0: a block per tile) or the refresh's gated
// build (as many blocks as the card holds at once, found once per
// instantiation, device, block and shared size).
template <typename T, int G, bool PERIODIC, bool EXCLUDE>
cudaError_t launch_plan(const BuildArgs<T>& a, const Plan& p, int stamp,
                        cudaStream_t s) {
  auto kernel = cellgrid_pairlist_kernel<T, G, PERIODIC, EXCLUDE>;
  static size_t raised = 0;
  static int resident = 0, on_dev = -1, for_block = 0, carved = -1;
  static size_t for_smem = 0;
  cudaError_t err;
  // all of the SM's L1 as shared memory, so that its tiles fit side by
  // side (the runtime's own split may hold fewer); both attributes hold
  // per device, so a new device sets them anew
  if (carved != p.dev) {
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
             cudaSharedmemCarveoutMaxShared)) != cudaSuccess) {
      return err;
    }
    carved = p.dev;
    raised = 48 * 1024;
  }
  if (p.smem > raised) {
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             static_cast<int>(p.smem))) != cudaSuccess) {
      return err;
    }
    raised = p.smem;
  }
  long long blocks = p.ntiles;
  if (stamp != 0) {
    if (p.dev != on_dev || p.smem != for_smem || p.block != for_block) {
      int nsm, per_sm;
      if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                        p.dev)) != cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, kernel, p.block, p.smem)) != cudaSuccess) {
        return err;
      }
      resident = per_sm * nsm;
      on_dev = p.dev;
      for_block = p.block;
      for_smem = p.smem;
    }
    if (blocks > resident) blocks = resident;
  }
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), p.block, p.smem, s>>>(
      a, p.tile, p.parts, p.ntiles, stamp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_build(const BuildArgs<T>& a, int stamp, cudaStream_t s) {
  Plan p;
  const cudaError_t err = plan_build(a, &p);
  if (err != cudaSuccess) return err;
  const bool periodic = a.px && a.py && a.pz, excl = a.ex.n != 0;
#define TPUMD_BUILD(LANES, P, E)                                             \
  if (p.G == LANES && periodic == P && excl == E)                            \
    return launch_plan<T, LANES, P, E>(a, p, stamp, s);
  TPUMD_BUILD(1, true, false)
  TPUMD_BUILD(1, true, true)
  TPUMD_BUILD(1, false, false)
  TPUMD_BUILD(1, false, true)
  TPUMD_BUILD(kLanesBuild, true, false)
  TPUMD_BUILD(kLanesBuild, true, true)
  TPUMD_BUILD(kLanesBuild, false, false)
  TPUMD_BUILD(kLanesBuild, false, true)
#undef TPUMD_BUILD
  return cudaErrorInvalidValue;
}

template <typename T>
bool bad_args(const BuildArgs<T>& a) {
  return a.nx < 1 || a.ny < 1 || a.nz < 1 || a.cap < 1 || a.cap > 1024 ||
         a.K < 1 || a.S < 0 || (a.ex.n && a.gmask == nullptr) ||
         (a.boxhold != nullptr && (a.lo == nullptr || a.hi == nullptr)) ||
         // the validity bytes are staged as aligned 4-byte words
         reinterpret_cast<unsigned long long>(a.valid) % 4 != 0;
}

template <typename T>
int launch(const BuildArgs<T>& a, void* stream) {
  if (bad_args(a)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_build(a, 0, static_cast<cudaStream_t>(stream)));
}

template <typename T, bool PERIODIC, bool BOXTERM>
cudaError_t launch_moved(const BuildArgs<T>& a, T skin, int stamp,
                         cudaStream_t s) {
  const long long np = static_cast<long long>(a.nx) * a.ny * a.nz * a.cap;
  const long long blocks = (np + kMovedBlock - 1) / kMovedBlock;
  pairlist_moved_kernel<T, PERIODIC, BOXTERM>
      <<<static_cast<unsigned>(blocks), kMovedBlock, 0, s>>>(a, skin, stamp);
  return cudaGetLastError();
}

template <typename T>
int launch_refresh(const BuildArgs<T>& a, double skin, int stamp,
                   int boxterm, void* stream) {
  if (bad_args(a) || a.xhold == nullptr || stamp == 0 ||
      (boxterm &&
       (a.boxhold == nullptr || a.lo == nullptr || a.hi == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool periodic = a.px && a.py && a.pz;
  const T sk = T(skin);
  const cudaError_t err =
      periodic ? (boxterm ? launch_moved<T, true, true>(a, sk, stamp, s)
                          : launch_moved<T, true, false>(a, sk, stamp, s))
               : (boxterm ? launch_moved<T, false, true>(a, sk, stamp, s)
                          : launch_moved<T, false, false>(a, sk, stamp, s));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_build(a, stamp, s));
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
// memory; lanes: the build's G, 0 for the launch rule or 1 or
// kLanesBuild forced (tests and chip_smoke.py force each).  The build
// entry returns the CUDA error code of its launch (0 on success); skin,
// stamp and boxterm are the refresh's.  The prepare
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
      int K, int lanes, double cutsq, double skin, int stamp, int boxterm,  \
      void *stream

#define TPUMD_PAIRLIST_BUILD_ARGS(T)                                         \
  BuildArgs<T> a{x,     valid,   sslots, scodes, S,      extent, lengths,    \
                 lo,    hi,      gmask,  {nexcl, {0}, {0}},                  \
                 pairs, npairs,  stat,   xhold,  boxhold, nx,    ny,         \
                 nz,    cap,     px,     py,     pz,      K,     T(cutsq),    \
                 lanes};                                                     \
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
