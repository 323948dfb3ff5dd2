// Hopper (sm_90a) building blocks shared by the port's TMA kernels
// (`flash_attention.cu`, `matmul.cu`, `rglru_scan.cu`): mbarriers, TMA
// loads and stores, wgmma descriptors and synchronisation, the m64n64k16
// shared-memory product, register rebalancing (`setmaxnreg`) and the
// run-time lookup of libcuda's tensor-map encoder; and, for the CUDA-core
// kernels of `flash_attention.cu` and `matmul.cu`, cp.async and the
// swizzle of their fp32 tiles (`cpa`).  Each source that
// includes this header gets its own copy (an anonymous namespace), so the
// libraries stay independent.
//
// `kernels/build.py` hashes this header with every source that includes
// it: an edit here rebuilds all three libraries.

#pragma once

#include <cstdint>
#include <cuda.h>             // CUtensorMap and its enums (types only:
                             // libcuda's encoder is looked up at run time)
#include <cuda_runtime.h>

namespace {
namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}
// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// makes the mbarrier inits visible to TMA (the async proxy) and to the
// other threads; once, by the thread that initialised them, before the
// block's __syncthreads
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one 64 x 64 box of a [B, S, heads, hd] tensor into shared memory, at
// (hd column c0, sequence row c1, head c2, batch c3); rows past the end
// arrive as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// one box of a 2-D tensor (c0 along the contiguous dim, c1 along rows);
// elements past either end arrive as zeros
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// TMA store of one box of shared memory into a 4-D map (coordinates as
// `tma_load`'s); boxes past either end of the tensor are clipped
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// until at most N committed stores still read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(N) : "memory");
}
// orders this thread's writes to shared memory before a TMA store reads
// them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand in shared memory (the
// layout TMA writes under CU_TENSOR_MAP_SWIZZLE_128B): start address and
// the leading and stride byte offsets, in 16-byte units; layout type 1.
// K-major: the stride offset is the step between 8-row groups, the leading
// one unused.  MN-major: the stride offset is the step between groups of 8
// K rows, the leading one the step between 64-element swizzle atoms along
// M or N.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | static_cast<uint64_t>(1) << 62;
}
// K-major (rows of 128 bytes along K): 8-row groups 1024 bytes apart; the
// leading offset is unused under the swizzle
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return desc(addr, 16, 1024);
}
// MN-major (each 128-byte row is one K index, 64 elements along N): 8-row
// groups 1024 bytes apart.  N is 64, one swizzle atom, so the offset
// between atoms along N is never used; both fields carry the row-group
// stride
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return desc(addr, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {   // every committed group
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of `d` across the
// asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define TC_D8(i)                                                         \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]),    \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define TC_D32 TC_D8(0), TC_D8(8), TC_D8(16), TC_D8(24)
#define TC_REGS32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B in shared memory, both
// K-major; fp32 accumulate.  scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TC_D32
      : "l"(a), "l"(b), "r"(scale_d));
}

// register rebalancing between the warpgroups of a warp-specialised block:
// the producer gives registers up, the consumers take them (every warp of
// a warpgroup executes it)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(N));
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the CUDA runtime so
// that the library links no -lcuda; null where it is missing
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

}  // namespace tc

// cp.async, for the CUDA-core kernels (`matmul_kernel`,
// `flash_attention_kernel`): copies from device memory into shared memory
// that pass by the registers, committed in groups and awaited by count.  A
// source size of 0 reads nothing and writes zeros, so the ragged edge of a
// tile arrives as zeros; the source address must still be a valid one.
namespace cpa {

// 16 bytes, both addresses 16-byte aligned, cached in L2 only
__device__ __forceinline__ void copy16(uint32_t dst, const void* src,
                                       bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
// 4 bytes, both addresses 4-byte aligned
__device__ __forceinline__ void copy4(uint32_t dst, const void* src,
                                      bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Where 16-byte chunk c of row r of a row-major fp32 tile of W floats a
// row lies in its row: the chunk index XOR-ed with the row, so that the
// 16-byte loads of one chunk from 8 consecutive rows fall in distinct
// banks.  Rows of 8 or more chunks XOR with r mod 8; the
// 4-chunk rows of W = 16, two to 128 bytes, with r / 2 mod 4.
template <int W>
__device__ __forceinline__ int chunk(int r, int c) {
  static_assert(W == 16 || W % 32 == 0, "row width");
  return W >= 32 ? c ^ (r & 7) : c ^ ((r >> 1) & 3);
}

}  // namespace cpa
}  // namespace
