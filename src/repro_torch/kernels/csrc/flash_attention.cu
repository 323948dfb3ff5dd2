// flash_attention for Hopper (sm_90a): causal or non-causal GQA softmax
// attention, out[b, i, h, :] = softmax_j(q[b,i,h,:] . k[b,j,h/G,:] / sqrt(hd))
// v[b,j,h/G,:], computed in fp32 from fp32 or bf16 inputs.
//
// Replaces the Pallas kernel `flash_attention` (`_flash_kernel`) in
// src/repro/kernels/flash_attention.py.  On the TPU the KV dimension is the
// innermost, sequential grid axis, and the online-softmax state (m, l) and
// the fp32 accumulator live in VMEM scratch from one grid step to the next.
// GPU blocks run in no order and carry nothing between them, so here one
// block owns one (batch, query head, tile of 64 query rows) and loops over
// the KV tiles itself, with m and l in registers and the accumulator in
// registers.  The numerics are the Pallas kernel's: masked scores are
// -1e30, a row whose scores are all masked so far is not "alive" (its p is
// 0 and its correction 1), l is floored at 1e-30 before the division, the
// scale is 1/sqrt(hd), and the causal mask is top-left, q_pos >= k_pos.
// KV tiles strictly above the diagonal are skipped, which halves the causal
// work; the diagonal tile and the ragged ends are masked element by
// element.  Query head h reads KV head h / G in place: K and V are never
// widened to H heads, transposed or padded in device memory.  q, k and v
// are read in the JAX layout [B, S, heads, hd] through their strides; the
// head dim must be contiguous.  `out` is a contiguous [B, Sq, H, hd].
//
// Bound on an H100: operations.  A causal call at B = 1, S = 32768, H = 14,
// hd = 64 does 4 * S^2 * H * hd / 2 = 1.92e12 FLOP, 1.95 ms at the bf16
// tensor-core peak of 989 TFLOP/s; its bytes (q, k, v read once, out
// written once: about 134 MB in bf16) take 0.04 ms at 3.35 TB/s.  This
// first version multiplies with fp32 FMAs on the CUDA cores (67 TFLOP/s
// peak, so at least 29 ms for that call), from fp32 tiles in shared
// memory: each thread owns a 4 x 4 tile of the 64 x 64 score tile and a
// 4 x hd/16 tile of the output, and reads q^T, k^T and p^T as float4s.
// mma.sync or wgmma with TMA-fed tiles is the way to the bound (later work).

#include <cstdint>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBKV = 64;           // keys per KV tile (== kBQ: one ld below)
constexpr int kThreads = 256;      // 16 row groups x 16 column groups
constexpr int kLd = kBQ + 4;       // ld of the transposed tiles: float4
                                   // aligned, rows on staggered banks
constexpr float kNegInf = -1e30f;  // the Pallas kernel's masked score

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);        // round to nearest even
}

template <int HD>
constexpr size_t smem_bytes() {
  // q^T [HD][kLd], k^T [HD][kLd], v [kBKV][HD], p^T [kBKV][kLd]; at HD 256
  // 222,208 bytes, under the 232,448 a block may opt into (one block an SM)
  return sizeof(float) * (2 * HD * kLd + kBKV * HD + kBKV * kLd);
}
static_assert(smem_bytes<256>() <= 232448, "tiles exceed shared memory");

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(T* __restrict__ out, const T* __restrict__ q,
                       const T* __restrict__ k, const T* __restrict__ v,
                       int64_t sq, int64_t skv, int64_t n_heads, int group,
                       int causal, float scale,
                       int64_t qsb, int64_t qss, int64_t qsh,
                       int64_t ksb, int64_t kss, int64_t ksh,
                       int64_t vsb, int64_t vss, int64_t vsh) {
  constexpr int kCols = HD / 16;   // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // q^T * scale
  float* ks = qs + HD * kLd;       // k^T
  float* vs = ks + HD * kLd;       // v
  float* ps = vs + kBKV * HD;      // p^T

  const int tid = threadIdx.x;
  const int r = tid >> 4;          // rows 4r .. 4r+3 of the tile
  const int c = tid & 15;          // score cols 4c .. 4c+3; out cols c*kCols..
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kBQ;
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + (h / group) * ksh;
  const T* vb = v + b * vsb + (h / group) * vsh;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int row = e / HD, d = e % HD;
    const int64_t qi = q0 + row;
    qs[d * kLd + row] = qi < sq ? to_float(qb[qi * qss + d]) * scale : 0.f;
  }

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  // keys a row of this tile can see: all, or (causal) up to its last row
  const int64_t q_last = (q0 + kBQ < sq ? q0 + kBQ : sq) - 1;
  const int64_t kv_end = causal ? (q_last + 1 < skv ? q_last + 1 : skv) : skv;

  for (int64_t k0 = 0; k0 < kv_end; k0 += kBKV) {
    __syncthreads();               // the previous tile is consumed
    for (int e = tid; e < kBKV * HD; e += kThreads) {
      const int row = e / HD, d = e % HD;
      const int64_t ki = k0 + row;
      const bool in = ki < skv;
      ks[d * kLd + row] = in ? to_float(kb[ki * kss + d]) : 0.f;
      vs[row * HD + d] = in ? to_float(vb[ki * vss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + d * kLd + 4 * r);
      const float4 kv = *reinterpret_cast<const float4*>(ks + d * kLd + 4 * c);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    // mask, then the online softmax; a row's 16 column groups are 16
    // neighbouring lanes of one warp, reduced by butterfly shuffles
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qi = q0 + 4 * r + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t ki = k0 + 4 * c + j;
        if (ki >= skv || (causal && qi < ki)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const bool alive = m_new > 0.5f * kNegInf;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = alive ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = alive ? expf(m[i] - m_new) : 1.f;
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(ps + (4 * c + j) * kLd + 4 * r) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBKV; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(ps + kk * kLd + 4 * r);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      const float* vrow = vs + kk * HD + c * kCols;
      float va[kCols];
      if constexpr (kCols % 4 == 0) {
#pragma unroll
        for (int j = 0; j < kCols; j += 4) {
          const float4 x = *reinterpret_cast<const float4*>(vrow + j);
          va[j] = x.x; va[j + 1] = x.y; va[j + 2] = x.z; va[j + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j) va[j] = vrow[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qi = q0 + 4 * r + i;
    if (qi >= sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* o = out + ((b * sq + qi) * n_heads + h) * HD + c * kCols;
#pragma unroll
    for (int j = 0; j < kCols; ++j) store(o + j, acc[i][j] / li);
  }
}

template <typename T, int HD>
cudaError_t launch(void* out, const void* q, const void* k, const void* v,
                   int64_t b, int64_t sq, int64_t skv, int64_t h, int64_t kv,
                   int causal, const int64_t* st, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, HD>;
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned int>((sq + kBQ - 1) / kBQ),
                  static_cast<unsigned int>(h), static_cast<unsigned int>(b));
  const float scale = static_cast<float>(1.0 / std::sqrt(double(HD)));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), sq, skv, h,
      static_cast<int>(h / kv), causal, scale, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int64_t hd, void* out, const void* q, const void* k,
                     const void* v, int64_t b, int64_t sq, int64_t skv,
                     int64_t h, int64_t kv, int causal, const int64_t* st,
                     cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(out, q, k, v, b, sq, skv, h, kv, causal, st, stream);
    case 32: return launch<T, 32>(out, q, k, v, b, sq, skv, h, kv, causal, st, stream);
    case 64: return launch<T, 64>(out, q, k, v, b, sq, skv, h, kv, causal, st, stream);
    case 128: return launch<T, 128>(out, q, k, v, b, sq, skv, h, kv, causal, st, stream);
    case 256: return launch<T, 256>(out, q, k, v, b, sq, skv, h, kv, causal, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// out: contiguous [b, sq, h, hd]; q: [b, sq, h, hd], k and v: [b, skv, kv,
// hd], each with the head dim contiguous and strides (batch, seq, head) in
// elements.  dtype 0 = float32, 1 = bfloat16 (all four tensors alike).
// All pointers are device pointers on the current device; `stream` is a
// cudaStream_t.  Returns cudaGetLastError() after the launch (0 = success)
// or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int flash_attention_launch(
    void* out, const void* q, const void* k, const void* v, int dtype,
    int64_t b, int64_t sq, int64_t skv, int64_t h, int64_t kv, int64_t hd,
    int causal, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
    int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
    void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0 || kv <= 0 || h % kv != 0 || skv < 0 ||
      h > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();        // report only this launch's error
  const int64_t st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(hd, out, q, k, v, b, sq, skv, h, kv, causal, st, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(hd, out, q, k, v, b, sq, skv, h, kv,
                                  causal, st, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
