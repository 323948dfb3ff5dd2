// gather_rows for Hopper (sm_90a): out[c, :] = table[idx[c], :], and a zero
// row wherever idx[c] lies outside [0, U).
//
// Replaces the Pallas kernel `gather_rows` in src/repro/kernels/costmodel.py,
// which serves the fused scorer's Eq. (9)-(13) validity screen.  On the TPU
// it is a one-hot gather-reduce over (pool, table-row) tiles, because the
// TPU has no fast dynamic gather; a GPU gathers directly, so each thread
// here copies output elements straight from the table.  An index outside
// [0, U) matches no one-hot lane in the Pallas kernel and yields zeros; the
// bound check below does the same.
//
// Tables hold int64 or float64 values.  The copy moves 64-bit words and
// never interprets them, so one kernel serves both types bit for bit.
//
// Bound on an H100: bytes.  Each call writes C*O*8 bytes, reads C*8 bytes
// of indices, and reads a table of at most a few MB (paper apps: U <= 2304,
// O <= 44, about 0.8 MB), which stays in the 50 MB L2.  At C = 262144 and
// O = 44 that is 94 MB, about 28 us at 3.35 TB/s.
//
// Design: a grid-stride loop over the flattened [C, O] output, so
// consecutive threads write consecutive addresses (coalesced stores) and
// read consecutive columns of one table row; the index of a row is read
// once per element through the read-only cache, where the O threads of one
// row hit the same line.  Nothing is allocated and nothing is synchronised:
// the wrapper allocates `out` and passes PyTorch's current stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// enough blocks to fill 132 SMs many times over; larger pools loop
constexpr int64_t kMaxBlocks = 132 * 32;

__global__ void gather_rows_kernel(uint64_t* __restrict__ out,
                                   const uint64_t* __restrict__ table,
                                   const int64_t* __restrict__ idx,
                                   int64_t n, int64_t u, int64_t o) {
  const int64_t total = n * o;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const int64_t c = i / o;
    const int64_t col = i - c * o;
    const int64_t r = __ldg(idx + c);
    out[i] = (r >= 0 && r < u) ? __ldg(table + r * o + col) : 0ull;
  }
}

}  // namespace

// out: [n, o] 64-bit words; table: [u, o] 64-bit words; idx: [n] int64.
// All pointers are device pointers on the current device; `stream` is a
// cudaStream_t.  Returns cudaGetLastError() after the launch (0 = success).
extern "C" int gather_rows_launch(void* out, const void* table,
                                  const void* idx, int64_t n, int64_t u,
                                  int64_t o, void* stream) {
  const int64_t total = n * o;
  if (total > 0) {
    int64_t blocks = (total + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    gather_rows_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t*>(out), static_cast<const uint64_t*>(table),
        static_cast<const int64_t*>(idx), n, u, o);
  }
  return static_cast<int>(cudaGetLastError());
}
