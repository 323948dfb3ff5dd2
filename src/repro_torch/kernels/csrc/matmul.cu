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
// accumulator in registers: 256 threads, each holding a TM x TN sub-tile
// (TM = BM / 16, TN = BN / 16).  The x and y tiles pass through shared
// memory in the inputs' own dtype, two stages deep: while the block
// multiplies from one stage, each thread holds its share of the next
// tiles in registers and stores them to the other stage afterwards (one
// barrier per K tile).  x is stored transposed ([BK][BM]) so that a
// thread reads its TM rows and its TN columns as vectors.  Ragged edges
// are bounds-checked and read as zeros, which is the function of Pallas's
// padding; indices into the output are 64-bit (M * N may exceed 2^31).
//
// Bound on an H100: operations.  A product of 2 M K N FLOP at the bf16
// tensor-core peak of 989 TFLOP/s; for the shapes this repository tunes
// (K >= 896, M, N >= 128) the bytes (each input read once, the output
// written once) take less at 3.35 TB/s.  This first version multiplies
// with fp32 FMAs on the CUDA cores (67 TFLOP/s peak): mma.sync, then
// wgmma fed by TMA, is the way to the bound (later work).
//
// The tiles below are the whole set the kernel is built for; the Python
// side (`MATMUL_TILES` in kernels/matmul.py) must list the same set, and
// the tile tuner (core/kernel_tune.py) picks only from it.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16 threads over the output tile

// N consecutive elements of shared memory, 4 * N or 2 * N bytes aligned,
// into fp32 registers
template <int N>
__device__ __forceinline__ void load_frag(const float* p, float* dst) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    dst[i] = v.x; dst[i + 1] = v.y; dst[i + 2] = v.z; dst[i + 3] = v.w;
  }
}
template <int N>
__device__ __forceinline__ void load_frag(const __nv_bfloat16* p,
                                          float* dst) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p + i);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    dst[i] = __low2float(lo); dst[i + 1] = __high2float(lo);
    dst[i + 2] = __low2float(hi); dst[i + 3] = __high2float(hi);
  }
}

template <typename T, int BM, int BK, int BN>
constexpr size_t smem_bytes() {
  return 2 * sizeof(T) * (BK * BM + BK * BN);    // two stages of x^T, y
}

template <typename T, int BM, int BK, int BN>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(void* __restrict__ out, const T* __restrict__ x,
              const T* __restrict__ y, int64_t M, int64_t K, int64_t N,
              int out_bf16) {
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int LX = BM * BK / kThreads;        // x elements per thread
  constexpr int LY = BK * BN / kThreads;        // y elements per thread
  static_assert(BM % 64 == 0 && BN % 64 == 0 && BK % 16 == 0, "tile");
  static_assert(LX * kThreads == BM * BK && LY * kThreads == BK * BN, "");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);       // [2][BK][BM]
  T* ys = xs + 2 * BK * BM;                     // [2][BK][BN]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int64_t n_k = (K + BK - 1) / BK;

  // Each thread stages column kx of rows mx + i * RX of the x tile, and
  // column ny of rows ky + i * RY of the y tile: its columns are the same
  // for every i, so one base pointer and one column check serve them all.
  constexpr int RX = kThreads / BK, RY = kThreads / BN;
  static_assert(RX * BK == kThreads && RY * BN == kThreads, "");
  const int kx = tid % BK, mx = tid / BK;
  const int ny = tid % BN, ky = tid / BN;
  const T* xp = x + (m0 + mx) * K + kx;
  const T* yp = y + static_cast<int64_t>(ky) * N + n0 + ny;
  const bool n_ok = n0 + ny < N;
  T rx[LX], ry[LY];                             // the next tiles, staged
  auto fetch = [&](int64_t k0) {
    const bool k_ok = k0 + kx < K;
#pragma unroll
    for (int i = 0; i < LX; ++i)                // consecutive threads on k
      rx[i] = (k_ok && m0 + mx + i * RX < M)
                  ? xp[static_cast<int64_t>(i) * RX * K + k0] : T(0.0f);
#pragma unroll
    for (int i = 0; i < LY; ++i)                // consecutive threads on n
      ry[i] = (n_ok && k0 + ky + i * RY < K)
                  ? yp[(k0 + i * RY) * N] : T(0.0f);
  };
  auto stash = [&](int stage) {
    T* xd = xs + stage * BK * BM + kx * BM + mx;    // transposed
    T* yd = ys + stage * BK * BN + tid;
#pragma unroll
    for (int i = 0; i < LX; ++i) xd[i * RX] = rx[i];
#pragma unroll
    for (int i = 0; i < LY; ++i) yd[i * kThreads] = ry[i];
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  fetch(0);
  stash(0);
  __syncthreads();
  for (int64_t t = 0; t < n_k; ++t) {
    const int stage = static_cast<int>(t & 1);
    if (t + 1 < n_k) fetch((t + 1) * BK);       // loads in flight
    const T* xc = xs + stage * BK * BM + ty * TM;
    const T* yc = ys + stage * BK * BN + tx * TN;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
      load_frag<TM>(xc + kk * BM, a);
      load_frag<TN>(yc + kk * BN, b);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other stage was last read before the previous barrier
    if (t + 1 < n_k) stash(stage ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t m = m0 + ty * TM + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t n = n0 + tx * TN + j;
      if (n < N) {
        if (out_bf16)
          static_cast<__nv_bfloat16*>(out)[m * N + n] =
              __float2bfloat16_rn(acc[i][j]);
        else
          static_cast<float*>(out)[m * N + n] = acc[i][j];
      }
    }
  }
}

template <typename T, int BM, int BK, int BN>
cudaError_t launch(void* out, const void* x, const void* y, int64_t m,
                   int64_t k, int64_t n, int out_bf16, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, BM, BK, BN>();
  static_assert(smem <= 232448, "tiles exceed shared memory");
  auto kernel = matmul_kernel<T, BM, BK, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((n + BN - 1) / BN),
                  static_cast<unsigned>((m + BM - 1) / BM));
  kernel<<<grid, kThreads, smem, stream>>>(
      out, static_cast<const T*>(x), static_cast<const T*>(y), m, k, n,
      out_bf16);
  return cudaGetLastError();
}

#define MATMUL_TILE(BM, BK, BN)                                           \
  if (bm == BM && bk == BK && bn == BN)                                   \
    return launch<T, BM, BK, BN>(out, x, y, m, k, n, out_bf16, stream);

template <typename T>
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

}  // namespace

// x [m, k] and y [k, n] contiguous, both fp32 (dtype 0) or bf16 (dtype 1);
// out [m, n] contiguous, fp32 (out_bf16 = 0) or bf16 (out_bf16 = 1).
// `stream` is a cudaStream_t.  Returns cudaGetLastError() after the launch
// (0 = success; cudaErrorInvalidValue for a tile not instantiated above).
extern "C" int matmul_launch(void* out, const void* x, const void* y,
                             int dtype, int out_bf16, int64_t m, int64_t k,
                             int64_t n, int bm, int bk, int bn,
                             void* stream) {
  (void)cudaGetLastError();        // report only this launch's error
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? dispatch<float>(out, x, y, m, k, n, bm, bk, bn, out_bf16, s)
                 : dispatch<__nv_bfloat16>(out, x, y, m, k, n, bm, bk, bn,
                                           out_bf16, s);
  return static_cast<int>(err);
}
