// rglru_scan for Hopper (sm_90a): the RG-LRU linear recurrence
// h[b, t, w] = a[b, t, w] * h[b, t-1, w] + b[b, t, w], h[b, -1, w] = 0, per
// channel, in fp32 from fp32 or bf16 inputs, the output in the inputs'
// dtype.
//
// Replaces the Pallas kernel `rglru_scan` (`_scan_kernel`) in
// src/repro/kernels/rg_lru.py.  On the TPU the sequence is the innermost,
// sequential grid axis: h is carried in VMEM from one 256-step tile to the
// next and each tile is scanned by log-step doubling across its rows.  GPU
// blocks carry nothing between them and run in no order, so here the
// sequence is cut into chunks of `chunk` steps and scanned in three passes:
//   1. one thread per (batch, chunk, channel) composes its chunk's affine
//      map h -> A h + T: A = the product of a over the chunk, T = the
//      chunk's last h with a zero carry-in;
//   2. one thread per (batch, channel) walks the chunks in order and turns
//      each chunk's (A, T) into its carry-in, h before its first step;
//   3. one thread per (batch, chunk, channel) re-runs its chunk from that
//      carry-in with h = fmaf(a, h, b) and writes every h.
// Inside a chunk the order of operations is the sequential recurrence's,
// so only the carries are composed in another order: the result sits
// within a few fp32 ulps of a step-by-step scan.  Neighbouring threads take
// neighbouring channels, so every step of a warp reads 32 consecutive
// elements; a thread loads 8 steps ahead of its dependent FMA chain.
//
// Bound on an H100: bytes.  The function reads a and b once and writes h
// once: at [1, 32768, 4096] fp32 that is 3 x 537 MB = 1.61 GB, 0.481 ms at
// 3.35 TB/s; at [4, 2048, 4096] 0.403 GB, 0.120 ms.  Passes 1 and 3 both
// read a and b (pass 2 moves only 2 x 4 bytes per chunk and channel), so
// this design moves 5/3 of those bytes and cannot beat 5/3 of the bound.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // channels per block
constexpr int kAhead = 8;          // steps loaded before they are consumed

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);        // round to nearest even
}

// Runs steps [t0, t1) of one channel from carry-in `h`, calling
// `step(t, a_t, h)` after each h = fmaf(a_t, h, b_t), in order.
template <typename T, typename Step>
__device__ __forceinline__ float run(const T* ap, const T* bp, int64_t ass,
                                     int64_t bss, int64_t t0, int64_t t1,
                                     float h, Step step) {
  int64_t t = t0;
  for (; t + kAhead <= t1; t += kAhead) {
    float av[kAhead], bv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      av[u] = to_float(ap[(t + u) * ass]);
      bv[u] = to_float(bp[(t + u) * bss]);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      h = fmaf(av[u], h, bv[u]);
      step(t + u, av[u], h);
    }
  }
  for (; t < t1; ++t) {
    const float at = to_float(ap[t * ass]);
    h = fmaf(at, h, to_float(bp[t * bss]));
    step(t, at, h);
  }
  return h;
}

// pass 1: prod = the product of a over the chunk, tail = its last h from a
// zero carry-in; both [batch, n_chunks, w] fp32
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_chunk_maps(float* __restrict__ prod, float* __restrict__ tail,
                 const T* __restrict__ a, const T* __restrict__ b, int64_t s,
                 int64_t w, int64_t chunk, int64_t asb, int64_t ass,
                 int64_t bsb, int64_t bss) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= w) return;
  const int64_t k = blockIdx.y, bi = blockIdx.z;
  const int64_t t0 = k * chunk, t1 = t0 + chunk < s ? t0 + chunk : s;
  float A = 1.f;
  const float h = run(a + bi * asb + c, b + bi * bsb + c, ass, bss, t0, t1,
                      0.f, [&](int64_t, float at, float) { A *= at; });
  const int64_t o = (bi * gridDim.y + k) * w + c;
  prod[o] = A;
  tail[o] = h;
}

// pass 2: prod[k] becomes chunk k's carry-in, in place
__global__ void __launch_bounds__(kThreads)
rglru_chunk_carries(float* __restrict__ prod,
                    const float* __restrict__ tail, int64_t w,
                    int64_t n_chunks) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= w) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * n_chunks * w + c;
  float h = 0.f;
  int64_t k = 0;
  for (; k + kAhead <= n_chunks; k += kAhead) {
    float A[kAhead], Tl[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      A[u] = prod[base + (k + u) * w];
      Tl[u] = tail[base + (k + u) * w];
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      prod[base + (k + u) * w] = h;
      h = fmaf(A[u], h, Tl[u]);
    }
  }
  for (; k < n_chunks; ++k) {
    const float A = prod[base + k * w];
    prod[base + k * w] = h;
    h = fmaf(A, h, tail[base + k * w]);
  }
}

// pass 3: each chunk from its carry-in, every h written to the contiguous
// out [batch, s, w]
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_chunk_outputs(T* __restrict__ out, const float* __restrict__ carry,
                    const T* __restrict__ a, const T* __restrict__ b,
                    int64_t s, int64_t w, int64_t chunk, int64_t asb,
                    int64_t ass, int64_t bsb, int64_t bss) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= w) return;
  const int64_t k = blockIdx.y, bi = blockIdx.z;
  const int64_t t0 = k * chunk, t1 = t0 + chunk < s ? t0 + chunk : s;
  T* o = out + bi * s * w + c;
  run(a + bi * asb + c, b + bi * bsb + c, ass, bss, t0, t1,
      carry[(bi * gridDim.y + k) * w + c],
      [&](int64_t t, float, float h) { store(o + t * w, h); });
}

template <typename T>
cudaError_t launch(void* out, float* prod, float* tail, const void* a,
                   const void* b, int64_t batch, int64_t s, int64_t w,
                   int64_t chunk, int64_t asb, int64_t ass, int64_t bsb,
                   int64_t bss, cudaStream_t stream) {
  const int64_t n_chunks = (s + chunk - 1) / chunk;
  const unsigned int wx = static_cast<unsigned int>((w + kThreads - 1)
                                                    / kThreads);
  const dim3 grid(wx, static_cast<unsigned int>(n_chunks),
                  static_cast<unsigned int>(batch));
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  rglru_chunk_maps<T><<<grid, kThreads, 0, stream>>>(
      prod, tail, at, bt, s, w, chunk, asb, ass, bsb, bss);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rglru_chunk_carries<<<dim3(wx, static_cast<unsigned int>(batch)),
                        kThreads, 0, stream>>>(prod, tail, w, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rglru_chunk_outputs<T><<<grid, kThreads, 0, stream>>>(
      static_cast<T*>(out), prod, at, bt, s, w, chunk, asb, ass, bsb, bss);
  return cudaGetLastError();
}

}  // namespace

// out: contiguous [batch, s, w]; a and b: [batch, s, w] with the channel
// dim contiguous and strides (batch, seq) in elements; prod and tail: fp32
// scratch of batch * ceil(s / chunk) * w elements each.  dtype 0 = float32,
// 1 = bfloat16 (out, a and b alike).  All pointers are device pointers on
// the current device; `stream` is a cudaStream_t.  Returns
// cudaGetLastError() after the three launches (0 = success) or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int rglru_scan_launch(void* out, void* prod, void* tail,
                                 const void* a, const void* b, int dtype,
                                 int64_t batch, int64_t s, int64_t w,
                                 int64_t chunk, int64_t asb, int64_t ass,
                                 int64_t bsb, int64_t bss, void* stream) {
  if (batch <= 0 || s <= 0 || w <= 0 || chunk <= 0 || batch > 65535 ||
      (s + chunk - 1) / chunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();        // report only this call's error
  const auto st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(prod);
  float* t = static_cast<float*>(tail);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(out, p, t, a, b, batch, s, w, chunk, asb, ass, bsb,
                        bss, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(out, p, t, a, b, batch, s, w, chunk, asb,
                                ass, bsb, bss, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
