// Row gather out[m, :] = table[idx[m], :] on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tools/probes/gather_probe.py::k_tala (a
// take_along_axis over a table held whole in VMEM, the index broadcast over
// the 128 lanes; its reference is table[idx]).  Here it carries every row
// gather of the matrix neighbor engine (tpumd_torch/ops/gather.py): the
// candidate cells of each atom's stencil, the candidates' coordinates, the
// neighbours' tags, the packed j-side rows of the pair and granular sweeps,
// the pair styles' coefficient rows and the bonded tuples' members.  The
// table is (T, L) and the output (M, L), both row-major and contiguous, of
// 4- or 8-byte elements; idx holds M int32 row numbers in [0, T) (the
// caller guarantees the range: an index outside it reads outside the
// table).
//
// What bounds it: bytes.  Every output row is read once from the table and
// written once, with M indices.  The engine's tables are under 1 MB at 32k
// atoms and stay in the 50 MB L2; the output need not (IN_HYB32K's packed j
// rows: 32,000 x 136 rows of 20 bytes, 87 MB), so the writes and the
// indices' reads set the time.
//
// Two copies, chosen by the row's bytes and the two base addresses:
//
// Unit copy, for a row whose bytes and both bases are multiples of 16 (the
// probe's L = 16 and 128, the engine's rows of 4, 8, 12 or 16 f32 words),
// for every row over 64 bytes and for a gather of too few rows to give the
// narrow copy two blocks a streaming multiprocessor (a bonded style's
// members: its one phase beats the narrow copy's three there, 0.0027
// against 0.0030 ms on the H100): the row is cut into units of 16, 8 or 4
// bytes, the widest that divides the row's bytes and both bases; one
// thread copies one unit, consecutive threads consecutive units of the
// output, so every load and store is a whole 16 bytes at the first
// alignment and a warp's stores are whole lines.  The unit copy at 16
// bytes is already a load and a store of 16 bytes a thread: staged through
// shared memory, L = 16 took 0.0245-0.0305 ms against its 0.0154.
//
// Narrow copy, for the other rows of up to 64 bytes (the engine's odd and
// 8-byte-aligned widths: 3, 5 and 6 f32 words, and any row of a shifted
// table), where the unit copy moves 4 or 8 bytes a thread behind a
// dependent index read and a division: one thread per row, a block of 128
// threads copying a tile of 128 x R consecutive output rows (R = 4 rows a
// thread, fewer where the grid would not cover the card twice).
//  - The block reads the tile's indices once, 16 bytes at a time where
//    they are aligned, into shared memory.
//  - Each thread then issues the table loads of its rows (tile rows tid,
//    tid + 128, ...) before any of their stores, so that all are in flight
//    at once.  A row is read as the 16-byte chunks that hold it (two for a
//    20-byte row) through the read-only path, and its words picked out of
//    them by the row's offset in its first chunk: no division, every load
//    a whole 16 bytes.  A chunk holds at least one byte of the row, so it
//    never leaves the table's pages.
//  - The words go to the tile in shared memory, laid out as the output,
//    and one TMA bulk store (cp.async.bulk) writes the whole tile: the
//    tile's 128 x R rows make its bytes a multiple of 16.  The last tile,
//    and an output base not aligned to 16 bytes, take 16- and 4-byte
//    stores instead.
//  - Templated on the row's width in 4-byte words for the widths the port
//    passes (1, 3, 4, 5, 6, 8, 12, 16); one instance takes any other width
//    up to 16 words, its loads and words guarded by the width.
// Rows and units are counted in 64 bits where the output needs it.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;                  // narrow copy: a block
constexpr int kMaxRowsPerThread = 4;
constexpr int kNarrowWords = 16;               // rows of up to 64 bytes
// the least blocks of a narrow copy before a thread takes several rows:
// two a streaming multiprocessor of the H100's 132
constexpr long long kMinBlocks = 264;

// the word of a row at compile-time position k, the row starting s words
// (0-3) into the 16-byte chunks v
template <int N>
__device__ __forceinline__ unsigned int pick(const unsigned int (&v)[N],
                                             int k, int s) {
  return s == 0 ? v[k] : s == 1 ? v[k + 1] : s == 2 ? v[k + 2] : v[k + 3];
}

// W words a row (0: any width up to kNarrowWords, given as w_any), rpt
// rows a thread.  table16 is the table's base rounded down to 16 bytes and
// t0 the table's first word past it.
template <int W>
__global__ void __launch_bounds__(kThreads)
narrow_gather_kernel(const uint4* __restrict__ table16, int t0,
                     const int* __restrict__ idx,
                     unsigned int* __restrict__ out, long long m_rows,
                     int w_any, int rpt, bool idx16, bool out16) {
  constexpr int kMaxW = W ? W : kNarrowWords;
  constexpr int kChunks = (kMaxW + 6) / 4;     // 16-byte chunks a row spans
  const int w = W ? W : w_any;
  const int tile = kThreads * rpt;
  extern __shared__ uint4 smem[];
  int* s_idx = reinterpret_cast<int*>(smem);
  uint4* s_tile = smem + tile / 4;
  unsigned int* s_out = reinterpret_cast<unsigned int*>(s_tile);
  const int tid = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * tile;
  const int rows = static_cast<int>(m_rows - r0 < tile ? m_rows - r0 : tile);

  if (idx16 && rows == tile) {
    for (int c = tid; c < tile / 4; c += kThreads)
      reinterpret_cast<int4*>(s_idx)[c] =
          __ldg(reinterpret_cast<const int4*>(idx + r0) + c);
  } else {
    for (int p = tid; p < rows; p += kThreads) s_idx[p] = __ldg(idx + r0 + p);
  }
  __syncthreads();

  unsigned int v[kMaxRowsPerThread][4 * kChunks] = {};
  int shift[kMaxRowsPerThread];
#pragma unroll
  for (int r = 0; r < kMaxRowsPerThread; ++r) {
    const int p = tid + r * kThreads;          // p < rows: r < rpt
    shift[r] = 0;
    if (p < rows) {
      const unsigned long long word =
          t0 + static_cast<unsigned long long>(s_idx[p]) * w;
      shift[r] = static_cast<int>(word & 3);
      const uint4* src = table16 + (word >> 2);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (4 * c < shift[r] + w) {
          const uint4 q = __ldg(src + c);
          v[r][4 * c] = q.x;
          v[r][4 * c + 1] = q.y;
          v[r][4 * c + 2] = q.z;
          v[r][4 * c + 3] = q.w;
        }
      }
    }
  }
  // each row into the tile by the widest shared stores its width allows
#pragma unroll
  for (int r = 0; r < kMaxRowsPerThread; ++r) {
    const int p = tid + r * kThreads;
    if (p < rows) {
      unsigned int x[kMaxW];
#pragma unroll
      for (int k = 0; k < kMaxW; ++k) x[k] = pick(v[r], k, shift[r]);
      unsigned int* d = s_out + p * w;
      if constexpr (W != 0 && W % 4 == 0) {
#pragma unroll
        for (int c = 0; c < W / 4; ++c)
          reinterpret_cast<uint4*>(d)[c] =
              make_uint4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
      } else if constexpr (W != 0 && W % 2 == 0) {
#pragma unroll
        for (int c = 0; c < W / 2; ++c)
          reinterpret_cast<uint2*>(d)[c] = make_uint2(x[2 * c], x[2 * c + 1]);
      } else {
#pragma unroll
        for (int k = 0; k < kMaxW; ++k)
          if (W || k < w) d[k] = x[k];
      }
    }
  }

  // the tile starts r0 * w words into out, a multiple of 512 bytes
  const int words = rows * w;
  unsigned int* dst = out + r0 * w;
  if (out16 && rows == tile) {
    // the generic proxy's shared writes made visible to the bulk copy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      const auto src =
          static_cast<unsigned int>(__cvta_generic_to_shared(s_out));
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n\t"
          "cp.async.bulk.commit_group;\n\t"
          "cp.async.bulk.wait_group.read 0;"
          :: "l"(dst), "r"(src), "r"(4 * words) : "memory");
    }
    return;
  }
  __syncthreads();
  int k = tid;
  if (out16) {
    const int n16 = words / 4;
    for (int c = tid; c < n16; c += kThreads)
      reinterpret_cast<uint4*>(dst)[c] = s_tile[c];
    k = 4 * n16 + tid;
  }
  for (; k < words; k += kThreads) dst[k] = s_out[k];
}

template <typename U, typename I>
__global__ void unit_gather_kernel(const U* __restrict__ table,
                                   const int* __restrict__ idx,
                                   U* __restrict__ out, I total, I units) {
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  for (I t = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const I m = t / units;
    const I u = t - m * units;
    const size_t src = static_cast<size_t>(__ldg(idx + m)) * units + u;
    out[t] = __ldg(table + src);
  }
}

template <typename U>
int launch_units(const void* table, const int* idx, void* out,
                 long long m_rows, long long row_bytes, cudaStream_t stream) {
  const long long units = row_bytes / static_cast<long long>(sizeof(U));
  const long long total = m_rows * units;
  const int threads = 256;
  // one unit per thread: every copy's loads are in flight at once (a
  // capped grid whose threads loop over several units issued them one
  // after another: 0.1316 ms at L = 128 on the H100); the loop is a guard
  const long long blocks = (total + threads - 1) / threads;
  const int grid = static_cast<int>(blocks < INT_MAX ? blocks : INT_MAX);
  const U* t = static_cast<const U*>(table);
  U* o = static_cast<U*>(out);
  if (total <= INT_MAX) {   // t + stride stays below 2^32
    unit_gather_kernel<U, unsigned int><<<grid, threads, 0, stream>>>(
        t, idx, o, static_cast<unsigned int>(total),
        static_cast<unsigned int>(units));
  } else {
    unit_gather_kernel<U, unsigned long long><<<grid, threads, 0, stream>>>(
        t, idx, o, static_cast<unsigned long long>(total),
        static_cast<unsigned long long>(units));
  }
  return static_cast<int>(cudaGetLastError());
}

template <int W>
void launch_narrow(const uint4* table16, int t0, const int* idx,
                   unsigned int* out, long long m_rows, int w, bool idx16,
                   bool out16, cudaStream_t stream) {
  long long rpt = m_rows / (kThreads * kMinBlocks);
  rpt = rpt < 1 ? 1 : rpt > kMaxRowsPerThread ? kMaxRowsPerThread : rpt;
  const long long tile = kThreads * rpt;
  const long long blocks = (m_rows + tile - 1) / tile;
  const size_t shared = sizeof(int) * tile + sizeof(unsigned int) * tile * w;
  narrow_gather_kernel<W>
      <<<static_cast<unsigned int>(blocks), kThreads, shared, stream>>>(
          table16, t0, idx, out, m_rows, w, static_cast<int>(rpt), idx16,
          out16);
}

}  // namespace

// table (T, row_bytes / elem) and out (m_rows, row_bytes / elem) contiguous;
// returns the launch's CUDA error code (cudaErrorInvalidValue for a row
// not a whole number of 4-byte words).
extern "C" int tpumd_row_gather(const void* table, const void* idx,
                                void* out, long long m_rows,
                                long long row_bytes, void* stream) {
  if (m_rows <= 0 || row_bytes <= 0) return 0;
  if (row_bytes % 4 != 0 || m_rows / kThreads >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* ix = static_cast<const int*>(idx);
  auto st = static_cast<cudaStream_t>(stream);
  const auto tab = reinterpret_cast<uintptr_t>(table);
  const auto dst = reinterpret_cast<uintptr_t>(out);
  const auto align = tab | dst | static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0)
    return launch_units<uint4>(table, ix, out, m_rows, row_bytes, st);
  if (row_bytes > 4 * kNarrowWords || m_rows < kThreads * kMinBlocks) {
    if (align % 8 == 0)
      return launch_units<uint2>(table, ix, out, m_rows, row_bytes, st);
    return launch_units<unsigned int>(table, ix, out, m_rows, row_bytes, st);
  }
  const int w = static_cast<int>(row_bytes / 4);
  const auto* t16 = reinterpret_cast<const uint4*>(tab & ~uintptr_t{15});
  const int t0 = static_cast<int>((tab & 15) / 4);
  const bool idx16 = reinterpret_cast<uintptr_t>(idx) % 16 == 0;
  const bool out16 = dst % 16 == 0;
  auto* o = static_cast<unsigned int*>(out);
#define TPUMD_NARROW(W)                                                \
  case W:                                                              \
    launch_narrow<W>(t16, t0, ix, o, m_rows, w, idx16, out16, st);     \
    break
  switch (w) {
    TPUMD_NARROW(1);
    TPUMD_NARROW(3);
    TPUMD_NARROW(4);
    TPUMD_NARROW(5);
    TPUMD_NARROW(6);
    TPUMD_NARROW(8);
    TPUMD_NARROW(12);
    TPUMD_NARROW(16);
    default:
      launch_narrow<0>(t16, t0, ix, o, m_rows, w, idx16, out16, st);
  }
#undef TPUMD_NARROW
  return static_cast<int>(cudaGetLastError());
}
