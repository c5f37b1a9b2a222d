// Row gather out[m, :] = table[idx[m], :] on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tools/probes/gather_probe.py::k_tala (a
// take_along_axis over a table held whole in VMEM, the index broadcast over
// the 128 lanes; its reference is table[idx]).  Here it carries every row
// gather of the matrix neighbor engine (tpumd_torch/ops/gather.py): the
// candidate cells of each atom's stencil, the candidates' coordinates, the
// neighbours' tags, and the packed j-side rows of the pair and granular
// sweeps.  The table is (T, L) and the output (M, L), both row-major and
// contiguous, of 4- or 8-byte elements; idx holds M int32 row numbers in
// [0, T) (the caller guarantees the range: an index outside it reads outside
// the table).
//
// What bounds it: bytes.  Every output row is read once from the table and
// written once, with M indices: at the probe's shape (T = 32,768, L = 128
// f32, M = 524,288) that is 287,309,824 B, 0.0858 ms at 3.35 TB/s.  The
// 16 MB table fits in the 50 MB L2, so repeated rows may be served from L2
// and the kernel can beat the HBM bound on its reads.
//
// Design: the row is cut into copy units of 16, 8 or 4 bytes, the widest
// that divides the row's bytes and both base addresses.  One thread copies
// one unit, consecutive threads take consecutive units of the output, so a
// warp writes 32 consecutive units: for a wide row (L = 128 f32, 32 float4
// units) a warp copies one row with 16-byte loads; for the engine's narrow
// rows (L = 1 to 16) one warp copies several rows, each thread still on the
// element after its neighbour's.  The index of a row is read by every thread
// of the row through the read-only path.  Templated on the unit; one unit
// per thread (the loop is a grid-stride guard).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename U>
__global__ void row_gather_kernel(const U* __restrict__ table,
                                  const int* __restrict__ idx,
                                  U* __restrict__ out, unsigned int total,
                                  unsigned int units) {
  const unsigned int stride = gridDim.x * blockDim.x;
  for (unsigned int t = blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const unsigned int m = t / units;
    const unsigned int u = t - m * units;
    const size_t src = static_cast<size_t>(__ldg(idx + m)) * units + u;
    out[t] = __ldg(table + src);
  }
}

template <typename U>
int launch(const void* table, const int* idx, void* out, long long m_rows,
           long long row_bytes, cudaStream_t stream) {
  const unsigned int units = static_cast<unsigned int>(row_bytes / sizeof(U));
  const unsigned int total = static_cast<unsigned int>(m_rows) * units;
  const int threads = 256;
  // one unit per thread: every copy's loads are in flight at once (a
  // capped grid whose threads loop over several units issued them one
  // after another: 0.1316 ms at L = 128 on the H100)
  const long long blocks =
      (static_cast<long long>(total) + threads - 1) / threads;
  row_gather_kernel<U><<<static_cast<int>(blocks), threads, 0, stream>>>(
      static_cast<const U*>(table), idx, static_cast<U*>(out), total, units);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (T, row_bytes / elem) and out (m_rows, row_bytes / elem) contiguous;
// returns the launch's CUDA error code (cudaErrorInvalidValue when the
// output holds 2^31 or more 4-byte words: the kernel counts units in 32
// bits).
extern "C" int tpumd_row_gather(const void* table, const void* idx,
                                void* out, long long m_rows,
                                long long row_bytes, void* stream) {
  if (m_rows <= 0 || row_bytes <= 0) return 0;
  if (row_bytes % 4 != 0 || m_rows * (row_bytes / 4) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto align = reinterpret_cast<uintptr_t>(table) |
                     reinterpret_cast<uintptr_t>(out) |
                     static_cast<uintptr_t>(row_bytes);
  const int* ix = static_cast<const int*>(idx);
  auto st = static_cast<cudaStream_t>(stream);
  if (align % 16 == 0) return launch<uint4>(table, ix, out, m_rows,
                                            row_bytes, st);
  if (align % 8 == 0) return launch<uint2>(table, ix, out, m_rows,
                                           row_bytes, st);
  return launch<unsigned int>(table, ix, out, m_rows, row_bytes, st);
}
