// matmul for Hopper (sm_90a): out[M, N] = x[M, K] @ y[K, N], accumulated in
// fp32 over (BM, BK, BN) tiles with K innermost, from fp32 or bf16 inputs,
// written as fp32 or bf16 (round to nearest even).
//
// Replaces the Pallas kernel `matmul` (`_matmul_kernel`) in
// src/repro/kernels/matmul.py.  On the TPU the K tiles are the innermost,
// sequential grid axis and the fp32 accumulator tile lives in VMEM scratch
// from one grid step to the next; inputs are zero-padded to whole tiles.
// GPU blocks carry nothing between them, so here one block owns one
// BM x BN output tile and loops over the K tiles itself, with the
// accumulator in registers.  Ragged edges read as zeros, which is the
// function of Pallas's padding; indices into the output are 64-bit (M * N
// may exceed 2^31).
//
// Bound on an H100: operations.  A product of 2 M K N FLOP at the bf16
// tensor-core peak of 989 TFLOP/s; for the shapes this repository tunes
// (K >= 896, M >= 128) the bytes (each input read once, the output written
// once) take less at 3.35 TB/s, except the decode-like M = 128, which the
// bytes of y bound.
//
// Two kernels, chosen by the caller (`kernels/matmul.py`, one table keyed
// by the inputs' dtype), each built for its own set of tiles:
//
// * `tc::matmul_kernel_wgmma` (bf16 inputs): the tensor cores.  A block is
//   warp-specialised: one producer warpgroup gives up its registers
//   (`setmaxnreg`) and its first thread keeps a ring of (x, y) K tiles in
//   flight with TMA into 128-byte-swizzled shared memory, each stage
//   guarded by a full and an empty mbarrier; the ring has as many stages
//   as fit in the 232,448 bytes a block may use (`tc::stages`, the same
//   formula as the tile model's).  Two consumer warpgroups (one for the
//   64 x 64 tiles) split the output tile by rows (BM >= 128) or by columns
//   and issue `wgmma.mma_async` m64nNk16 with both operands in shared
//   memory: x K-major, y MN-major (the row-major [K, N] tile, as flash
//   reads V).  The fp32 accumulator stays in the tensor cores' registers
//   across all K tiles; one tile's products are in flight while the next
//   tile's are issued, and a stage is released once its products are done.
//   The epilogue writes from the registers with bounds checks.  TMA needs
//   16-byte-aligned bases and row strides: the wrapper zero-pads K (and
//   y's N) to a multiple of 8 where they are not, and y's row stride
//   (`ldy`) may then exceed N.  One block per output tile (no persistent
//   scheduler, no clusters), launched in groups of `kGroupM` tile rows so
//   that a wave of blocks shares its x rows and y columns in L2.
// * `matmul_kernel` (fp32 inputs; fp32 stays free of TF32): fp32 FMAs on
//   the CUDA cores (67 TFLOP/s peak).  Each thread holds 8 x 8 outputs,
//   so a block has BM BN / 64 threads, in warps of 32 x 64 outputs: lane
//   (rg, cg) = (lane / 8, lane % 8) takes rows 4 i + rg (i < 8) and columns
//   32 j + 4 cg .. + 3 (j < 2) of its warp's tile.  The x and y tiles pass
//   from device memory into shared memory by cp.async (16 bytes, no
//   registers; 4 bytes where K or N is not a multiple of 4 or a start is
//   not 16-byte aligned), in a ring of up to `kMaxStages` stages with the
//   next tiles in flight while one is multiplied (one barrier a K tile).
//   x stays K-major, as it lies in memory, each 16-byte chunk swizzled by
//   its row (`cpa::chunk`), and is read along K: one 16-byte load gives a
//   thread 4 K values of one row, and the four row groups of a warp load
//   four consecutive rows, in distinct banks.  A y row's 8 chunks under a
//   warp are 128 consecutive bytes.  So every fragment load is free of
//   bank conflicts, and 16 of them (4 K steps) feed 256 FMAs a thread.
//   Registers are not capped: ptxas gives a thread 168 at bk <= 32 and
//   214-221 at bk = 64 (one 256-thread block an SM); capped at 128 for
//   two blocks an SM, every tile spilled and ran slower on the card.

// The tiles instantiated below (`MATMUL_TILE` for the CUDA-core kernel,
// `MATMUL_TC_TILE` for the tensor-core one) are the whole sets the kernels
// are built for; the Python side (`CUDA_CORE.tiles`, `TENSOR_CORE.tiles` in
// kernels/matmul.py) must list the same sets, and the tile tuner
// (core/kernel_tune.py) picks only from them.

#include <climits>
#include <cstdint>
#include <cuda.h>             // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kSmemLimit = 232448;       // bytes a block may opt into
constexpr int kMaxStages = 3;            // of the CUDA-core kernel's ring
constexpr int kThreadTile = 64;          // outputs a thread: 8 x 8
constexpr int kWarpM = 32, kWarpN = 64;  // outputs a warp

__host__ __device__ constexpr int min_int(int a, int b) {
  return a < b ? a : b;
}

// stages of the CUDA-core kernel's (x, y) ring: `kMaxStages` where they
// fit in the shared memory a block may use, else as many as fit (two for
// the BK = 128 tiles of BM + BN = 192).  core/kernel_tune.py (`cc_stages`)
// computes the same number
__host__ __device__ constexpr int cc_stages(int bm, int bk, int bn) {
  return min_int(kMaxStages, kSmemLimit / ((bm + bn) * bk * 4));
}

template <int BM, int BK, int BN>
struct CcCfg {
  static constexpr int kThreads = BM * BN / kThreadTile;
  static constexpr int kWarpsN = BN / kWarpN;
  static constexpr int kStages = cc_stages(BM, BK, BN);
  static constexpr int kXFloats = BM * BK;                 // a stage's x
  static constexpr int kStageFloats = BM * BK + BK * BN;   // and y
  static constexpr size_t kSmem = sizeof(float) * kStages * kStageFloats;
  // 16-byte chunks of x and of y a thread copies a stage
  static constexpr int kXCopies = BM * BK / 4 / kThreads;
  static constexpr int kYCopies = BK * BN / 4 / kThreads;
  static_assert(BM % kWarpM == 0 && BN % kWarpN == 0 && BK % 16 == 0,
                "tile");
  static_assert(kXCopies * kThreads * 4 == BM * BK &&
                kYCopies * kThreads * 4 == BK * BN, "copies");
  static_assert(kStages >= 2 && kSmem <= kSmemLimit,
                "tiles exceed shared memory");
};

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int BM, int BK, int BN>
__global__ void __launch_bounds__(CcCfg<BM, BK, BN>::kThreads)
matmul_kernel(void* __restrict__ out, const float* __restrict__ x,
              const float* __restrict__ y, int64_t M, int64_t K, int64_t N,
              int out_bf16, int vec) {
  using C = CcCfg<BM, BK, BN>;
  constexpr int S = C::kStages;
  constexpr int XC = BK / 4, YC = BN / 4;        // 16-byte chunks a row
  extern __shared__ __align__(16) float smem[];  // [S][x BM x BK, y BK x BN]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rg = lane / 8, cg = lane % 8;
  const int wm = (warp / C::kWarpsN) * kWarpM;
  const int wn = (warp % C::kWarpsN) * kWarpN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int64_t n_k = (K + BK - 1) / BK;

  // K tile kt into stage s; what lies past M, K or N arrives as zeros
  auto load = [&](int64_t kt, int s) {
    float* xs = smem + s * C::kStageFloats;
    float* ys = xs + C::kXFloats;
    const int64_t k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < C::kXCopies; ++i) {
      const int e = tid + i * C::kThreads;
      const int r = e / XC, c = e % XC;
      const int64_t m = m0 + r, k = k0 + 4 * c;
      const uint32_t d = tc::smem_u32(xs + r * BK + 4 * cpa::chunk<BK>(r, c));
      const float* src = x + m * K + k;
      if (vec) {
        const bool ok = m < M && k < K;
        cpa::copy16(d, ok ? src : x, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = m < M && k + j < K;
          cpa::copy4(d + 4 * j, ok ? src + j : x, ok);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < C::kYCopies; ++i) {
      const int e = tid + i * C::kThreads;
      const int r = e / YC, c = e % YC;
      const int64_t k = k0 + r, n = n0 + 4 * c;
      const uint32_t d = tc::smem_u32(ys + r * BN + 4 * c);
      const float* src = y + k * N + n;
      if (vec) {
        const bool ok = k < K && n < N;
        cpa::copy16(d, ok ? src : y, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = k < K && n + j < N;
          cpa::copy4(d + 4 * j, ok ? src + j : y, ok);
        }
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_k) load(s, s);
    cpa::commit();
  }
  for (int64_t t = 0; t < n_k; ++t) {
    cpa::wait<S - 2>();            // this thread's copies of tile t landed
    __syncthreads();               // everyone's; and tile t - 1 is consumed
    if (t + S - 1 < n_k) load(t + S - 1, static_cast<int>((t + S - 1) % S));
    cpa::commit();
    const float* xs = smem + static_cast<int>(t % S) * C::kStageFloats;
    const float* ys = xs + C::kXFloats + wn + 4 * cg;
#pragma unroll 2
    for (int c = 0; c < BK / 4; ++c) {
      float a[8][4];               // rows 4 i + rg, K 4 c .. 4 c + 3
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = wm + 4 * i + rg;
        const float4 v = lds4(xs + r * BK + 4 * cpa::chunk<BK>(r, c));
        a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* yr = ys + (4 * c + kk) * BN;
        const float4 b0 = lds4(yr), b1 = lds4(yr + 32);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
  }

  const bool n_vec = !out_bf16 && N % 4 == 0;   // 16-byte output rows
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t m = m0 + wm + 4 * i + rg;
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t n = n0 + wn + 32 * h + 4 * cg;
      if (n_vec && n + 3 < N) {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + m * N + n) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
        continue;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n + j >= N) break;
        if (out_bf16)
          static_cast<__nv_bfloat16*>(out)[m * N + n + j] =
              __float2bfloat16_rn(acc[i][4 * h + j]);
        else
          static_cast<float*>(out)[m * N + n + j] = acc[i][4 * h + j];
      }
    }
  }
}

template <int BM, int BK, int BN>
cudaError_t launch(void* out, const void* x, const void* y, int64_t m,
                   int64_t k, int64_t n, int out_bf16, cudaStream_t stream) {
  using C = CcCfg<BM, BK, BN>;
  auto kernel = matmul_kernel<BM, BK, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  // 16-byte copies need 16-byte-aligned starts and rows of whole chunks
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0 && k % 4 == 0 &&
                   n % 4 == 0);
  const dim3 grid(static_cast<unsigned>((n + BN - 1) / BN),
                  static_cast<unsigned>((m + BM - 1) / BM));
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      out, static_cast<const float*>(x), static_cast<const float*>(y), m, k,
      n, out_bf16, vec);
  return cudaGetLastError();
}

#define MATMUL_TILE(BM, BK, BN)                                           \
  if (bm == BM && bk == BK && bn == BN)                                   \
    return launch<BM, BK, BN>(out, x, y, m, k, n, out_bf16, stream);

cudaError_t dispatch(void* out, const void* x, const void* y, int64_t m,
                     int64_t k, int64_t n, int bm, int bk, int bn,
                     int out_bf16, cudaStream_t stream) {
  MATMUL_TILE(128, 64, 128)
  MATMUL_TILE(128, 32, 128)
  MATMUL_TILE(128, 16, 128)
  MATMUL_TILE(128, 128, 64)
  MATMUL_TILE(128, 64, 64)
  MATMUL_TILE(128, 32, 64)
  MATMUL_TILE(128, 16, 64)
  MATMUL_TILE(64, 128, 128)
  MATMUL_TILE(64, 64, 128)
  MATMUL_TILE(64, 32, 128)
  MATMUL_TILE(64, 16, 128)
  MATMUL_TILE(64, 128, 64)
  MATMUL_TILE(64, 64, 64)
  MATMUL_TILE(64, 32, 64)
  MATMUL_TILE(64, 16, 64)
  return cudaErrorInvalidValue;    // no instantiation for this tile
}

// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16 inputs)

namespace tc {      // (its mbarrier, TMA and wgmma helpers: hopper.cuh)

constexpr int kSmemReserve = 2048;       // alignment slack and mbarriers
constexpr int kGroupM = 8;               // tile rows per launch group
constexpr int kProducerRegs = 40;        // setmaxnreg: 384 threads start at
constexpr int kConsumerRegs = 232;       // 168; 40 + 2 x 232 = 3 x 168

// stages of the (x, y) ring: as many bf16 tiles as fit beside the reserve.
// core/kernel_tune.py (`tc_stages`) computes the same number
__host__ __device__ constexpr int stages(int bm, int bk, int bn) {
  return (kSmemLimit - kSmemReserve) / ((bm + bn) * bk * 2);
}

template <int BM, int BK, int BN>
struct Cfg {
  static constexpr bool kSplitRows = BM >= 128;
  static constexpr int kCons = (BM >= 128 || BN >= 128) ? 2 : 1;
  static constexpr int WM = kSplitRows ? BM / kCons : BM;  // a consumer's
  static constexpr int WN = kSplitRows ? BN : BN / kCons;  // rows, columns
  static constexpr int MB = WM / 64;                       // m64 blocks
  static constexpr int kThreads = 128 * (kCons + 1);
  static constexpr int kStages = stages(BM, BK, BN);
  static constexpr uint32_t kXBytes = BM * BK * 2;         // one stage's x
  static constexpr uint32_t kYBytes = BK * BN * 2;         // and y
  static constexpr uint32_t kStageBytes = kXBytes + kYBytes;
  // 1024 of slack to align the ring, the ring, a full and an empty
  // mbarrier a stage
  static constexpr size_t kSmem = 1024 + kStages * kStageBytes + 16 * kStages;
  static_assert(BM % 64 == 0 && BN % 64 == 0 && BK % 64 == 0, "tile");
  static_assert(WN == 64 || WN == 128 || WN == 256, "wgmma width");
  static_assert(kStages >= 2, "fewer than two stages fit");
  static_assert(kSmem <= kSmemLimit, "tiles exceed shared memory");
};

#define MM_D8(i)                                                         \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]),    \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d[64 x N] += A[64 x 16] B[16 x N], A in shared memory K-major, B in
// shared memory MN-major (transposed), fp32 accumulate; N = 64, 128, 256
__device__ __forceinline__ void wgmma_mn(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : MM_D8(0), MM_D8(8), MM_D8(16), MM_D8(24)
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_mn(float (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : MM_D8(0), MM_D8(8), MM_D8(16), MM_D8(24), MM_D8(32), MM_D8(40),
        MM_D8(48), MM_D8(56)
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_mn(float (&d)[128], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}"
      ", %128, %129, p, 1, 1, 0, 1;\n}\n"
      : MM_D8(0), MM_D8(8), MM_D8(16), MM_D8(24), MM_D8(32), MM_D8(40),
        MM_D8(48), MM_D8(56), MM_D8(64), MM_D8(72), MM_D8(80),
        MM_D8(88), MM_D8(96), MM_D8(104), MM_D8(112), MM_D8(120)
      : "l"(a), "l"(b), "r"(1));
}

#undef MM_D8

// store two neighbouring outputs of one row, converted; `pair`: both in
// range and 2-element aligned
__device__ __forceinline__ void store2(void* out, int64_t i, float a, float b,
                                      bool pair, bool second, int out_bf16) {
  if (out_bf16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + i;
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
    } else {
      o[0] = __float2bfloat16_rn(a);
      if (second) o[1] = __float2bfloat16_rn(b);
    }
  } else {
    float* o = static_cast<float*>(out) + i;
    if (pair) {
      *reinterpret_cast<float2*>(o) = make_float2(a, b);
    } else {
      o[0] = a;
      if (second) o[1] = b;
    }
  }
}

template <int BM, int BK, int BN>
__global__ void __launch_bounds__(Cfg<BM, BK, BN>::kThreads, 1)
matmul_kernel_wgmma(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_y,
                    void* __restrict__ out, int64_t M, int64_t N, int K,
                    int tiles_m, int tiles_n, int out_bf16) {
  using C = Cfg<BM, BK, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = ring + C::kStages * C::kStageBytes;
  // stage s: x at ring + s kStageBytes ([BK / 64] boxes of BM rows x 128
  // bytes), y after it ([BN / 64] boxes of BK rows x 128 bytes)
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (C::kStages + s); };

  // block -> output tile: groups of kGroupM tile rows, down the rows of a
  // group first, then across its columns
  const int per_group = kGroupM * tiles_n;
  const int group = static_cast<int>(blockIdx.x) / per_group;
  const int first = group * kGroupM;
  const int rows = min(tiles_m - first, kGroupM);
  const int r = static_cast<int>(blockIdx.x) - group * per_group;
  const int m0 = (first + r % rows) * BM;
  const int n0 = (r / rows) * BN;
  const int n_k = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * C::kCons);      // one arrival a warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == C::kCons) {
    // ---- producer: one thread issues every load ----
    if constexpr (C::kCons == 2) setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == C::kCons * 128) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % C::kStages;
        mbar_wait(empty(s), ((kt / C::kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), C::kStageBytes);
        const uint32_t xs = ring + s * C::kStageBytes;
        const uint32_t ys = xs + C::kXBytes;
#pragma unroll
        for (int a = 0; a < BK / 64; ++a)
          tma_load_2d(xs + a * BM * 128, &tm_x, full(s), kt * BK + 64 * a,
                      m0);
#pragma unroll
        for (int a = 0; a < BN / 64; ++a)
          tma_load_2d(ys + a * BK * 128, &tm_y, full(s), n0 + 64 * a,
                      kt * BK);
      }
    }
  } else {
    // ---- consumer warpgroup `wg`: rows row_off .., columns col_off .. ----
    if constexpr (C::kCons == 2) setmaxnreg_inc<kConsumerRegs>();
    const int row_off = C::kSplitRows ? wg * C::WM : 0;
    const int col_off = C::kSplitRows ? 0 : wg * C::WN;
    float acc[C::MB][C::WN / 2];
#pragma unroll
    for (int mb = 0; mb < C::MB; ++mb)
#pragma unroll
      for (int i = 0; i < C::WN / 2; ++i) acc[mb][i] = 0.f;

    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % C::kStages;
      mbar_wait(full(s), (kt / C::kStages) & 1);
      const uint32_t xs = ring + s * C::kStageBytes + row_off * 128;
      const uint32_t ys =
          ring + s * C::kStageBytes + C::kXBytes + (col_off / 64) * BK * 128;
#pragma unroll
      for (int mb = 0; mb < C::MB; ++mb) fence_regs(acc[mb]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        // y: 16 K rows of 128 bytes from row 16 ks; atoms of 64 columns
        // BK rows apart.  x: 32 bytes at column 16 (ks % 4) of box ks / 4
        const uint64_t b = desc(ys + ks * 16 * 128, BK * 128, 1024);
#pragma unroll
        for (int mb = 0; mb < C::MB; ++mb)
          wgmma_mn(acc[mb],
                   desc_k(xs + (ks / 4) * BM * 128 + mb * 64 * 128
                          + (ks % 4) * 32),
                   b);
      }
      wgmma_commit();
      wgmma_wait_n<1>();           // the previous tile's products are done
#pragma unroll
      for (int mb = 0; mb < C::MB; ++mb) fence_regs(acc[mb]);
      if (kt > 0 && threadIdx.x % 32 == 0)
        mbar_arrive(empty((kt - 1) % C::kStages));
    }
    wgmma_wait();
#pragma unroll
    for (int mb = 0; mb < C::MB; ++mb) fence_regs(acc[mb]);

    // the m64nNk16 accumulator layout: a thread holds rows r0 and r0 + 8
    // of each 64-row block and, in each group of 8 columns, c0 and c0 + 1
    const int t = threadIdx.x % 128;
    const int64_t r0 = m0 + row_off + 16 * (t / 32) + (t % 32) / 4;
    const int64_t c0 = n0 + col_off + 2 * (t % 4);
    const bool even = N % 2 == 0;
#pragma unroll
    for (int mb = 0; mb < C::MB; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = r0 + 64 * mb + 8 * h;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < C::WN / 8; ++j) {
          const int64_t col = c0 + 8 * j;
          if (col >= N) continue;
          const int i = 4 * j + 2 * h;
          store2(out, row * N + col, acc[mb][i], acc[mb][i + 1],
                 even && col + 1 < N, col + 1 < N, out_bf16);
        }
      }
  }
}

// the 2-D map of a bf16 row-major [rows, cols] tensor with row stride `ld`
// elements, read in boxes of 64 columns (128 bytes) x `box_rows` rows under
// the 128-byte swizzle; elements past either end read as zeros
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
              int64_t rows, int64_t cols, int64_t ld, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int BK, int BN>
cudaError_t launch(void* out, const void* x, const void* y, int64_t m,
                   int64_t k, int64_t n, int64_t ldy, int out_bf16,
                   cudaStream_t stream) {
  using C = Cfg<BM, BK, BN>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap mx, my;
  if (!make_map(encode, &mx, x, m, k, k, BM) ||
      !make_map(encode, &my, y, k, ldy, ldy, BK))
    return cudaErrorInvalidValue;
  const int64_t tiles_m = (m + BM - 1) / BM, tiles_n = (n + BN - 1) / BN;
  if (tiles_m * tiles_n > INT_MAX || tiles_n * kGroupM > INT_MAX)
    return cudaErrorInvalidValue;
  auto kernel = matmul_kernel_wgmma<BM, BK, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned int>(tiles_m * tiles_n), C::kThreads,
           C::kSmem, stream>>>(
      mx, my, out, m, n, static_cast<int>(k), static_cast<int>(tiles_m),
      static_cast<int>(tiles_n), out_bf16);
  return cudaGetLastError();
}

#define MATMUL_TC_TILE(BM, BK, BN)                                        \
  if (bm == BM && bk == BK && bn == BN)                                   \
    return launch<BM, BK, BN>(out, x, y, m, k, n, ldy, out_bf16, stream);

cudaError_t dispatch(void* out, const void* x, const void* y, int64_t m,
                     int64_t k, int64_t n, int64_t ldy, int bm, int bk,
                     int bn, int out_bf16, cudaStream_t stream) {
  MATMUL_TC_TILE(128, 64, 256)
  MATMUL_TC_TILE(256, 64, 128)
  MATMUL_TC_TILE(128, 128, 256)
  MATMUL_TC_TILE(256, 128, 128)
  MATMUL_TC_TILE(128, 64, 128)
  MATMUL_TC_TILE(128, 128, 128)
  MATMUL_TC_TILE(64, 64, 256)
  MATMUL_TC_TILE(256, 64, 64)
  MATMUL_TC_TILE(64, 128, 256)
  MATMUL_TC_TILE(256, 128, 64)
  MATMUL_TC_TILE(64, 64, 128)
  MATMUL_TC_TILE(128, 64, 64)
  MATMUL_TC_TILE(64, 128, 128)
  MATMUL_TC_TILE(128, 128, 64)
  MATMUL_TC_TILE(64, 64, 64)
  MATMUL_TC_TILE(64, 128, 64)
  return cudaErrorInvalidValue;    // no instantiation for this tile
}

}  // namespace tc

}  // namespace

// x [m, k] contiguous; y [k, n] with row stride ldy >= n; out [m, n]
// contiguous, fp32 (out_bf16 = 0) or bf16 (out_bf16 = 1); x and y both
// fp32 (dtype 0) or both bf16 (dtype 1).  kernel 0 = `matmul_kernel` (CUDA
// cores: fp32, ldy == n), 1 = `tc::matmul_kernel_wgmma` (tensor cores: bf16,
// k > 0, x and y 16-byte aligned, k and ldy multiples of 8, as TMA reads
// them).  All pointers are device pointers on the current device; `stream`
// is a cudaStream_t.  Returns cudaGetLastError() after the launch (0 =
// success), cudaErrorInvalidValue for a tile not instantiated above or
// arguments the chosen kernel does not take, or cudaErrorNotSupported
// where libcuda has no tensor-map encoder.
extern "C" int matmul_launch(int kernel, void* out, const void* x,
                             const void* y, int dtype, int out_bf16,
                             int64_t m, int64_t k, int64_t n, int64_t ldy,
                             int bm, int bk, int bn, void* stream) {
  (void)cudaGetLastError();        // report only this launch's error
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (kernel == 0 && dtype == 0 && ldy == n) {
    err = dispatch(out, x, y, m, k, n, bm, bk, bn, out_bf16, s);
  } else if (kernel == 1 && dtype == 1 && k > 0 && k < INT_MAX &&
             m < INT_MAX && ldy < INT_MAX && ldy >= n && k % 8 == 0 &&
             ldy % 8 == 0) {
    err = tc::dispatch(out, x, y, m, k, n, ldy, bm, bk, bn, out_bf16, s);
  }
  return static_cast<int>(err);
}
