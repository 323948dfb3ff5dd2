// flash_attention for Hopper (sm_90a): causal or non-causal GQA softmax
// attention, out[b, i, h, :] = softmax_j(q[b,i,h,:] . k[b,j,h/G,:] / sqrt(hd))
// v[b,j,h/G,:], computed in fp32 from fp32 or bf16 inputs.
//
// Replaces the Pallas kernel `flash_attention` (`_flash_kernel`) in
// src/repro/kernels/flash_attention.py.  On the TPU the KV dimension is the
// innermost, sequential grid axis, and the online-softmax state (m, l) and
// the fp32 accumulator live in VMEM scratch from one grid step to the next.
// GPU blocks run in no order and carry nothing between them, so here a
// block owns one (batch, query head, tile of query rows) and loops over the
// KV tiles itself, with m, l and the accumulator in registers.  The
// numerics are the Pallas kernel's: masked scores are -1e30, a row whose
// scores are all masked so far is not "alive" (its p is 0 and its
// correction 1), l is summed from the fp32 p and floored at 1e-30 before
// the division, the scale is 1/sqrt(hd), and the causal mask is top-left,
// q_pos >= k_pos.  KV tiles strictly above the diagonal are skipped, which
// halves the causal work; the diagonal tile and the ragged ends are masked
// element by element.  Query head h reads KV head h / G in place: K and V
// are never widened to H heads, transposed or padded in device memory.  q,
// k and v are read in the JAX layout [B, S, heads, hd] through their
// strides; the head dim must be contiguous.  `out` is a contiguous
// [B, Sq, H, hd].
//
// Bound on an H100: operations.  A causal call at B = 1, S = 32768, H = 14,
// hd = 64 does 4 * S^2 * H * hd / 2 = 1.92e12 FLOP, 1.95 ms at the bf16
// tensor-core peak of 989 TFLOP/s; its bytes (q, k, v read once, out
// written once: about 134 MB in bf16) take 0.04 ms at 3.35 TB/s.
//
// Two kernels, chosen by the caller (`kernels/flash_attention.py`, one
// table keyed by dtype and head dim):
//
// * `flash_attention_kernel_wgmma` (bf16 at head dims 64, 128, 256): the
//   tensor cores.  A block owns 128 query rows: two consumer warpgroups of
//   64 rows and one producer warpgroup, whose first thread keeps TMA loads
//   of K and V tiles in flight into two-stage rings of shared memory, each
//   tile guarded by a full and an empty mbarrier.  Q, K and V arrive as
//   64 x 64 boxes (128 bytes a row, 128-byte swizzle), read through 4-D
//   tensor maps over the JAX layout's strides (built in the C entry
//   point); rows past the end arrive as zeros.  S = Q K^T is `wgmma` with
//   both operands in shared memory, K-major; the softmax runs on the
//   accumulator fragments in registers (a row lives in one quad of
//   lanes), with exp(scale (s - m)) as 2^(s c - m c), c = scale log2(e):
//   one FFMA and one MUFU.EX2 a score (m c rounded once, and the
//   correction between tiles taken from those rounded values by the
//   accurate exp2f).  The Pallas kernel keeps p in fp32
//   and multiplies p @ v in fp32, which one bf16 operand cannot: p is
//   split into three bf16 terms, hi + mid + lo, that carry all 24 bits of
//   its significand (exactly, for every p >= 2^-110), and each term goes
//   straight from the accumulator fragment into a `wgmma` A operand (the
//   m64nNk16 accumulator layout is the A-fragment layout), with B = the V
//   tile, MN-major.  The tensor cores align each product to the running
//   sum and truncate, which over a long row loses the small terms, so each
//   KV tile's p @ v goes into a fresh accumulator, smallest terms first,
//   and is added to the output accumulator with fp32 FMAs (acc corr +
//   tile, as the Pallas kernel adds).  Every product is exact and every
//   sum fp32, so the kernel is within one bf16 ulp of the Pallas kernel's
//   function (not equal to it: ex2 is approximate, and the scale is
//   folded into the exponent, where Pallas scales q first; at hd 128 the
//   scale is not a power of two).  The price is the p @ v product three
//   times, twice the bound's tensor-core work, so half the bound is its
//   ceiling.  The two consumer
//   warpgroups take turns to issue their products (named barriers), so
//   that one's softmax overlaps the other's products.  Query tiles launch
//   heaviest first (causal work grows with the tile index).  The producer
//   gives its registers to the consumers (`setmaxnreg`): at hd 256 the
//   64 x 256 fp32 accumulator alone is 128 registers a thread.
// * `flash_attention_kernel` (fp32 at every head dim, bf16 at 16 and 32): fp32
//   FMAs on the CUDA cores (67 TFLOP/s peak); fp32 inputs stay in fp32
//   throughout (no TF32).  A block owns 128 query rows, 16 to each of its 8
//   warps, so a row's softmax never leaves its warp.  q * scale is stored in
//   shared memory once (1/sqrt(hd): exact where hd is a power of 4), and the
//   softmax takes expf; exp2f with log2(e) folded into the scale ran 5-9 %
//   faster on the card but missed the fp32 tolerance at hd 256 (PERF.md).  K
//   and V tiles of `Tile<HD>::kBKV` keys pass into a ring of `kSlots` slots by
//   cp.async (16 bytes, no registers; 4 bytes where a start or a stride is not
//   16-byte aligned; bf16 through the registers, widened to fp32), K of tile
//   t, then V of tile t, then K of tile t + 1: while one slot is multiplied
//   the next ones load, and one barrier guards each slot.  Every tile row is
//   stored as it lies in memory, along the head dim, its 16-byte chunks
//   swizzled by the row (`cpa::chunk`).  Lane (rg, cg) = (lane / 8, lane % 8)
//   of a warp owns rows 4 i + rg (i < 4) of the warp's 16: their scores at
//   keys 8 j + cg, and their output at columns 32 j + 4 cg .. + 3 (hd 16: 2
//   cg, 2 cg + 1). Scores: each 16-byte load gives 4 head-dim values of one
//   row (q) or key (k), and 4 q and kBKV / 8 k loads feed 2 kBKV FMAs; the
//   rows and keys of one load are consecutive, in distinct banks.  Only a tile
//   that reaches past Skv or, causal, past a warp's first row is masked.  p
//   goes through the warp's own slice of shared memory, [key][rg][i], written
//   and read as float4s without conflicts, and p @ v reads one float4 of p and
//   hd / 32 float4s of a v row a key.  Query tiles launch heaviest first
//   (causal work grows with the tile index).  hd <= 64 fits two blocks an SM
//   (at most 128 registers a thread: a few spill, which ran faster on the card
//   than one block an SM without spills); at hd 256 the block takes 208 KB and
//   32-key tiles, and every load is hidden behind the products of both
//   warpgroups of the block.

#include <climits>
#include <cstdint>
#include <cmath>
#include <cuda.h>             // CUtensorMap and its enums (types only:
                             // libcuda's encoder is looked up at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 128;           // query rows per block
constexpr int kWarps = 8;          // each owns 16 of the rows
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsW = kBQ / kWarps;
constexpr float kNegInf = -1e30f;  // the Pallas kernel's masked score

// Keys a K or V tile and slots of the ring, by head dim
template <int HD>
struct Tile;
#define FLASH_TILE(HD, BKV, SLOTS)                                        \
  template <>                                                             \
  struct Tile<HD> {                                                       \
    static constexpr int kBKV = BKV, kSlots = SLOTS;                      \
  };
FLASH_TILE(16, 64, 2)
FLASH_TILE(32, 64, 2)
FLASH_TILE(64, 64, 2)
FLASH_TILE(128, 64, 4)
FLASH_TILE(256, 32, 2)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// 4 consecutive output elements, 16-byte aligned in fp32
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  p[0] = __float2bfloat16(a);      // round to nearest even
  p[1] = __float2bfloat16(b);
  p[2] = __float2bfloat16(c);
  p[3] = __float2bfloat16(d);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  p[0] = a;
  p[1] = b;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  p[0] = __float2bfloat16(a);
  p[1] = __float2bfloat16(b);
}

template <int HD>
constexpr size_t smem_bytes() {
  // q * scale [kBQ][HD], the ring [kSlots][kBKV][HD], p [kWarps][kBKV]
  // [kRowsW]; at HD 128 229,376 bytes, under the 232,448 a block may opt
  // into, at HD 64 98,304 (two blocks an SM)
  return sizeof(float) * (kBQ * HD + Tile<HD>::kSlots * Tile<HD>::kBKV * HD
                          + kWarps * Tile<HD>::kBKV * kRowsW);
}
static_assert(smem_bytes<128>() <= 232448 && smem_bytes<256>() <= 232448,
              "tiles exceed shared memory");

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 2 : 1)
flash_attention_kernel(T* __restrict__ out, const T* __restrict__ q,
                       const T* __restrict__ k, const T* __restrict__ v,
                       int64_t sq, int64_t skv, int64_t n_heads,
                       int64_t n_batch, int group, int causal, float scale,
                       int vec, int64_t qsb, int64_t qss, int64_t qsh,
                       int64_t ksb, int64_t kss, int64_t ksh,
                       int64_t vsb, int64_t vss, int64_t vsh) {
  constexpr int BKV = Tile<HD>::kBKV, S = Tile<HD>::kSlots;
  constexpr int NC = HD / 4;               // 16-byte chunks a row
  constexpr int TC = BKV / 8;              // keys a thread
  constexpr int TH = HD >= 32 ? HD / 8 : 2;   // output columns a thread
  constexpr int kCopies = BKV * NC / kThreads;
  static_assert(kCopies * kThreads == BKV * NC, "copies");
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // q * scale, [kBQ][HD]
  float* ring = qs + kBQ * HD;             // [S][BKV][HD]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rg = lane / 8, cg = lane % 8;
  float* ps = ring + S * BKV * HD + warp * BKV * kRowsW;   // [BKV][4][4]
  // block -> (query tile, head, batch), the last query tiles first
  const int64_t n_qt = (sq + kBQ - 1) / kBQ;
  const int64_t hb = n_heads * n_batch;
  const int64_t q0 = (n_qt - 1 - blockIdx.x / hb) * kBQ;
  const int64_t h = blockIdx.x % n_heads;
  const int64_t b = blockIdx.x / n_heads % n_batch;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + (h / group) * ksh;
  const T* vb = v + b * vsb + (h / group) * vsh;

  for (int e = tid; e < kBQ * NC; e += kThreads) {
    const int r = e / NC, c = e % NC;
    const int64_t qi = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < sq) {
      const T* p = qb + qi * qss + 4 * c;
      x = make_float4(to_float(p[0]) * scale, to_float(p[1]) * scale,
                      to_float(p[2]) * scale, to_float(p[3]) * scale);
    }
    *reinterpret_cast<float4*>(qs + r * HD + 4 * cpa::chunk<HD>(r, c)) = x;
  }

  // keys a row of this tile can see: all, or (causal) up to its last row
  const int64_t q_last = (q0 + kBQ < sq ? q0 + kBQ : sq) - 1;
  const int64_t kv_end = causal ? (q_last + 1 < skv ? q_last + 1 : skv) : skv;
  const int n_items = 2 * static_cast<int>((kv_end + BKV - 1) / BKV);

  // item 2 t is K tile t, item 2 t + 1 V tile t; keys past skv are zeros
  auto fill = [&](int item, int slot) {
    const T* base = (item & 1) ? vb : kb;
    const int64_t stride = (item & 1) ? vss : kss;
    const int64_t k0 = static_cast<int64_t>(item >> 1) * BKV;
    float* dst = ring + slot * BKV * HD;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / NC, c = e % NC;
      const int64_t ki = k0 + r;
      const bool ok = ki < skv;
      float* d = dst + r * HD + 4 * cpa::chunk<HD>(r, c);
      const T* src = ok ? base + ki * stride + 4 * c : base;
      if constexpr (sizeof(T) == 4) {
        if (vec) {
          cpa::copy16(tc::smem_u32(d), src, ok);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            cpa::copy4(tc::smem_u32(d + j), src + (ok ? j : 0), ok);
        }
      } else {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok)
          x = make_float4(to_float(src[0]), to_float(src[1]),
                          to_float(src[2]), to_float(src[3]));
        *reinterpret_cast<float4*>(d) = x;
      }
    }
  };

  float acc[4][TH];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TH; ++j) acc[i][j] = 0.f;
  }
  const int row0 = warp * kRowsW + rg;     // row 4 i + rg of the warp's

#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (j < n_items) fill(j, j);
    cpa::commit();
  }
  for (int it = 0; it < n_items; ++it) {
    cpa::wait<S - 2>();            // this thread's copies of item it landed
    __syncthreads();               // everyone's; and item it - 1 is consumed
    if (it + S - 1 < n_items) fill(it + S - 1, (it + S - 1) % S);
    cpa::commit();
    const float* tile = ring + (it % S) * BKV * HD;
    const int64_t k0 = static_cast<int64_t>(it >> 1) * BKV;

    if ((it & 1) == 0) {
      // scores of rows 4 i + rg at keys 8 j + cg, d ascending
      float s[4][TC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < NC; ++c) {
        float4 qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = row0 + 4 * i;
          qv[i] = lds4(qs + r * HD + 4 * cpa::chunk<HD>(r, c));
        }
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int key = 8 * j + cg;
          const float4 kv = lds4(tile + key * HD + 4 * cpa::chunk<HD>(key, c));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
          }
        }
      }
      // mask (only a tile that reaches past skv or, causal, past the
      // warp's first row has masked scores), then the online softmax; a
      // row's 8 column groups are 8 neighbouring lanes of one warp,
      // reduced by butterfly shuffles
      const bool edge = k0 + BKV > skv ||
                        (causal && k0 + BKV - 1 > q0 + warp * kRowsW);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t qi = q0 + row0 + 4 * i;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int64_t ki = k0 + 8 * j + cg;
          if (edge && (ki >= skv || (causal && qi < ki))) s[i][j] = kNegInf;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const bool alive = m_new > 0.5f * kNegInf;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          s[i][j] = alive ? expf(s[i][j] - m_new) : 0.f;
          sum += s[i][j];
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const float corr = alive ? expf(m[i] - m_new) : 1.f;
        l[i] = l[i] * corr + sum;
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < TH; ++j) acc[i][j] *= corr;
      }
#pragma unroll
      for (int j = 0; j < TC; ++j)
        *reinterpret_cast<float4*>(ps + ((8 * j + cg) * 4 + rg) * 4) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      __syncwarp();
    } else {
      // acc += p v over the tile's keys, in key order
#pragma unroll 4
      for (int kk = 0; kk < BKV; ++kk) {
        const float4 p4 = lds4(ps + (kk * 4 + rg) * 4);
        const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
        const float* vrow = tile + kk * HD;
        float va[TH];
        if constexpr (HD >= 32) {
#pragma unroll
          for (int j = 0; j < HD / 32; ++j) {
            const float4 x = lds4(vrow + 4 * cpa::chunk<HD>(kk, 8 * j + cg));
            va[4 * j] = x.x; va[4 * j + 1] = x.y;
            va[4 * j + 2] = x.z; va[4 * j + 3] = x.w;
          }
        } else {
          const float2 x = *reinterpret_cast<const float2*>(
              vrow + 4 * cpa::chunk<HD>(kk, cg / 2) + 2 * (cg % 2));
          va[0] = x.x; va[1] = x.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TH; ++j)
            acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
      }
      __syncwarp();                // p is read before the next tile's
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qi = q0 + row0 + 4 * i;
    if (qi >= sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* o = out + ((b * sq + qi) * n_heads + h) * HD;
    if constexpr (HD >= 32) {
#pragma unroll
      for (int j = 0; j < HD / 32; ++j)
        store4(o + 32 * j + 4 * cg, acc[i][4 * j] / li,
               acc[i][4 * j + 1] / li, acc[i][4 * j + 2] / li,
               acc[i][4 * j + 3] / li);
    } else {
      store2(o + 2 * cg, acc[i][0] / li, acc[i][1] / li);
    }
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
  const int64_t blocks = (sq + kBQ - 1) / kBQ * h * b;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  // 16-byte copies of K and V rows: 16-byte-aligned starts and strides
  int vec = reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(v) % 16 == 0;
  for (int i = 3; i < 9; ++i) vec = vec && st[i] % 4 == 0;
  const float scale = static_cast<float>(1.0 / std::sqrt(double(HD)));
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), sq, skv, h, b,
      static_cast<int>(h / kv), causal, scale, vec, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

// fp32 at every head dim, bf16 at 16 and 32 (the tensor-core kernel takes
// bf16 at the others)
template <typename T>
cudaError_t dispatch(int64_t hd, void* out, const void* q, const void* k,
                     const void* v, int64_t b, int64_t sq, int64_t skv,
                     int64_t h, int64_t kv, int causal, const int64_t* st,
                     cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(out, q, k, v, b, sq, skv, h, kv, causal, st, stream);
    case 32: return launch<T, 32>(out, q, k, v, b, sq, skv, h, kv, causal, st, stream);
  }
  if constexpr (sizeof(T) == 4) {
    switch (hd) {
      case 64: return launch<T, 64>(out, q, k, v, b, sq, skv, h, kv, causal, st, stream);
      case 128: return launch<T, 128>(out, q, k, v, b, sq, skv, h, kv, causal, st, stream);
      case 256: return launch<T, 256>(out, q, k, v, b, sq, skv, h, kv, causal, st, stream);
    }
  }
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16, head dims 64, 128, 256)

namespace tc {      // (its mbarrier, TMA and wgmma helpers: hopper.cuh)

constexpr int kConsumers = 2;            // warpgroups of 64 query rows
constexpr int kBQ = 64 * kConsumers;     // query rows per block
constexpr int kThreads = 128 * (kConsumers + 1);   // + the producer's
constexpr int kStages = 2;               // K/V ring depth
constexpr int kBox = 64;                 // TMA box: 64 rows x 64 bf16
constexpr uint32_t kBoxBytes = kBox * kBox * 2;     // 8 KB, 1024-aligned
constexpr int kProducerRegs = 24;        // setmaxnreg: 384 threads start at
constexpr int kConsumerRegs = 240;       // 168; 24 + 2 x 240 = 3 x 168

// keys per KV tile, and 64-column boxes of a tile's p @ V per pass: the
// score tile (kBKV / 2 registers a thread), the three bf16 terms of p
// (3 kBKV / 8) and a pass's fresh accumulator (32 a box) must fit beside
// the hd / 2 of the accumulator; at hd 256 only one box does
template <int HD> struct Tile;
template <> struct Tile<64> { static constexpr int kBKV = 128, kPass = 1; };
template <> struct Tile<128> { static constexpr int kBKV = 64, kPass = 2; };
template <> struct Tile<256> { static constexpr int kBKV = 64, kPass = 1; };

template <int HD>                        // one warpgroup's Q
__host__ __device__ constexpr uint32_t q_bytes() { return 64 * HD * 2; }
template <int HD>
__host__ __device__ constexpr uint32_t kv_bytes() {
  return Tile<HD>::kBKV * HD * 2;
}
template <int HD>
constexpr size_t smem_bytes() {
  // 1024 of slack to align the tiles, Q, the K and V rings, 9 mbarriers;
  // 197,704 bytes at hd 256
  return 1024 + kConsumers * q_bytes<HD>() + 2 * kStages * kv_bytes<HD>()
         + 8 * (1 + 4 * kStages);
}
static_assert(smem_bytes<256>() <= 232448, "tiles exceed shared memory");

// named barrier `id` over `n` threads: wait for it, or only arrive
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(n) : "memory");
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A from registers (the fragment of
// an m64nNk16 accumulator, packed to bf16 pairs), B in shared memory,
// MN-major; fp32 accumulate.  scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TC_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

#undef TC_REGS32
#undef TC_D32
#undef TC_D8

// p = hi + mid + lo, three bf16 values as the high halves of fp32 words,
// by truncation: hi keeps p's sign, exponent and top 7 mantissa bits; the
// rest, r = p - hi (exact), holds at most 16 significant bits, and so on.
// The sum is exactly p whenever p is a multiple of 2^-133 (bf16's finest
// step), which covers every p >= 2^-110; below that it drops less than
// 2^-133.  Only the high halves are read (`pack_hi`), so lo is not masked.
__device__ __forceinline__ void split3(float p, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = __float_as_uint(p) & 0xFFFF0000u;
  const float r = p - __uint_as_float(hi);
  mid = __float_as_uint(r) & 0xFFFF0000u;
  lo = __float_as_uint(r - __uint_as_float(mid));
}

// two bf16 held in the high halves of x (low lane) and y (high lane)
__device__ __forceinline__ uint32_t pack_hi(uint32_t x, uint32_t y) {
  return __byte_perm(x, y, 0x7632);
}

// 2^x, one MUFU.EX2 (relative error about 2^-22; 0 below 2^-126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one warpgroup's state and steps; a thread holds rows row0 and row0 + 8
// of the warpgroup's 64, each spread over the 4 lanes of a quad, and in
// each group of 8 columns the pair col0, col0 + 1 (the m64nNk16
// accumulator layout)
template <int HD>
struct Consumer {
  static constexpr int kBKV = Tile<HD>::kBKV;
  static constexpr int kCB = HD / kBox;     // 64-column boxes across hd
  static constexpr int kRB = kBKV / kBox;   // 64-row boxes down a KV tile
  static constexpr int kKS = kBKV / 16;     // k16 slices of p @ v
  static constexpr int kPass = Tile<HD>::kPass;

  float o[kCB][32];                  // the fp32 accumulator, 64 x hd
  float sc[kRB][32];                 // scores, then p, 64 x kBKV
  uint32_t ph[kKS][4], pm[kKS][4], pl[kKS][4];   // p's bf16 terms
  float m[2], mc[2], l[2], corr[2];  // mc: m c, as the tile's p used it
  int row0, col0, wg_row0;

  // S = Q K^T over the head dim, 16 columns a step (not committed)
  __device__ __forceinline__ void issue_qk(uint32_t s_q, uint32_t s_k) {
#pragma unroll
    for (int c = 0; c < kRB; ++c)
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const uint32_t col = (ks / 4) * kBoxBytes + (ks % 4) * 32;
        wgmma_ss(sc[c], desc_k(s_q + col),
                 desc_k(s_k + c * kCB * kBoxBytes + col), ks > 0);
      }
  }

  // O = O corr + p @ V.  The tensor cores align each product to the
  // running sum and truncate, so a term far below the sum is lost: each
  // pass takes kPass column boxes of p @ V into a fresh fp32 accumulator,
  // the terms of p from the smallest (all lo, all mid, then all hi), and
  // adds it to O with fp32 FMAs (rounded to nearest), as the Pallas kernel
  // adds its tile's product to its accumulator.  Slice ks (keys 16 ks ..
  // + 15) is rows 16 (ks % 4) .. of V's row box ks / 4.
  __device__ __forceinline__ void pv(uint32_t s_v) {
#pragma unroll
    for (int g = 0; g < kCB; g += kPass) {
      float t[kPass][32];
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
#pragma unroll
        for (int i = 0; i < 32; ++i) t[j][i] = 0.f;
        fence_regs(t[j]);
      }
      fence_terms();
      wgmma_fence();
      auto term = [&](const uint32_t (&x)[kKS][4], bool first) {
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
          for (int j = 0; j < kPass; ++j)
            wgmma_rs(t[j], x[ks],
                     desc_mn(s_v + ((ks / 4) * kCB + g + j) * kBoxBytes
                             + (ks % 4) * 16 * 128),
                     !(first && ks == 0));
      };
      term(pl, true);
      term(pm, false);
      term(ph, false);
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        fence_regs(t[j]);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          o[g + j][i] = fmaf(o[g + j][i], corr[(i / 2) % 2], t[j][i]);
      }
    }
  }

  __device__ __forceinline__ void fence_sc() {
#pragma unroll
    for (int c = 0; c < kRB; ++c) fence_regs(sc[c]);
  }
  __device__ __forceinline__ void fence_terms() {
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
      for (int a = 0; a < 4; ++a)
        asm volatile("" : "+r"(ph[ks][a]), "+r"(pm[ks][a]), "+r"(pl[ks][a])
                     :: "memory");
  }

  // mask the raw scores of keys k0 .., then the online softmax: p and
  // corr in the Pallas kernel's terms, with exp(scale (x - m)) as
  // 2^(x c - mc), c = scale log2(e), mc = m c rounded: one FFMA and one
  // MUFU a score, and corr = 2^(mc_old - mc) (exp2f)
  __device__ __forceinline__ void softmax(int k0, int skv, int causal,
                                          float c) {
    const bool edge = k0 + kBKV > skv || (causal && k0 + kBKV - 1 > wg_row0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int cc = 0; cc < kRB; ++cc)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        if (edge) {
          const int key = k0 + kBox * cc + 8 * (i / 4) + col0 + i % 2;
          if (key >= skv || (causal && row0 + 8 * r < key))
            sc[cc][i] = kNegInf;
        }
        mx[r] = fmaxf(mx[r], sc[cc][i]);
      }
    bool alive[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alive[r] = m_new > 0.5f * kNegInf;
      // m c rounded once (no contraction), and the correction from the
      // two rounded values the tiles' p used, by the accurate exp2f (ex2
      // is biased low by about 2^-24): either error is a factor on all
      // the earlier tiles at every rise of the maximum, which over a long
      // row whose maximum rises often (olmoe-1b-7b's 32k prefill) drifted
      // past FLASH_TOL
      const float mc_new = __fmul_rn(m_new, c);
      corr[r] = alive[r] ? exp2f(mc[r] - mc_new) : 1.f;
      mc[r] = mc_new;
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int cc = 0; cc < kRB; ++cc)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        const float p = alive[r] ? ex2(fmaf(sc[cc][i], c, -mc[r])) : 0.f;
        sc[cc][i] = p;
        sum[r] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
  }

  // p's terms as A fragments: slice ks is accumulator registers
  // 8 (ks % 4) .. + 7 of score block ks / 4
  __device__ __forceinline__ void split() {
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = 8 * (ks % 4) + 2 * a;
        uint32_t h0, m0, l0, h1, m1, l1;
        split3(sc[ks / 4][i], h0, m0, l0);
        split3(sc[ks / 4][i + 1], h1, m1, l1);
        ph[ks][a] = pack_hi(h0, h1);
        pm[ks][a] = pack_hi(m0, m1);
        pl[ks][a] = pack_hi(l0, l1);
      }
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             __nv_bfloat16* __restrict__ out, int sq, int skv,
                             int n_heads, int batch, int group, int causal,
                             float scale) {
  constexpr int kBKV = Tile<HD>::kBKV;
  constexpr int kCB = HD / kBox;
  constexpr int kRB = kBKV / kBox;
  constexpr uint32_t kQ = q_bytes<HD>(), kKV = kv_bytes<HD>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_k = s_q + kConsumers * kQ;
  const uint32_t s_v = s_k + kStages * kKV;
  const uint32_t bars = s_v + kStages * kKV;
  const uint32_t q_full = bars;
  // stage s of the K ring and of the V ring: full (loaded), empty (read)
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * kStages + s); };

  // block -> (head, batch, query tile); the last query tiles, which see
  // the most keys under the causal mask, take the first blocks
  const int n_qt = (sq + kBQ - 1) / kBQ;
  int idx = blockIdx.x;
  const int h = idx % n_heads;
  idx /= n_heads;
  const int bb = idx % batch;
  const int q0 = (n_qt - 1 - idx / batch) * kBQ;
  const int kvh = h / group;
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int kv_end = causal ? min(q_last + 1, skv) : skv;
  const int n_kv = (kv_end + kBKV - 1) / kBKV;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumers * 128);
      mbar_init(v_empty(s), kConsumers * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every load, K(j) before V(j) ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(q_full, kConsumers * kQ);
      for (int w = 0; w < kConsumers; ++w)
        for (int cb = 0; cb < kCB; ++cb)
          tma_load(s_q + w * kQ + cb * kBoxBytes, &tm_q, q_full, cb * kBox,
                   q0 + w * kBox, h, bb);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % kStages;
        const uint32_t free_parity = ((it / kStages) & 1) ^ 1;
        const int k0 = it * kBKV;
        mbar_wait(k_empty(s), free_parity);
        mbar_expect_tx(k_full(s), kKV);
        for (int rb = 0; rb < kRB; ++rb)
          for (int cb = 0; cb < kCB; ++cb)
            tma_load(s_k + s * kKV + (rb * kCB + cb) * kBoxBytes, &tm_k,
                     k_full(s), cb * kBox, k0 + rb * kBox, kvh, bb);
        mbar_wait(v_empty(s), free_parity);
        mbar_expect_tx(v_full(s), kKV);
        for (int rb = 0; rb < kRB; ++rb)
          for (int cb = 0; cb < kCB; ++cb)
            tma_load(s_v + s * kKV + (rb * kCB + cb) * kBoxBytes, &tm_v,
                     v_full(s), cb * kBox, k0 + rb * kBox, kvh, bb);
      }
    }
  } else {
    // ---- consumer warpgroup `wg`: query rows q0 + 64 wg .. + 63 ----
    setmaxnreg_inc<kConsumerRegs>();
    Consumer<HD> cs;
    const int t = threadIdx.x % 128;
    cs.wg_row0 = q0 + kBox * wg;
    cs.row0 = cs.wg_row0 + 16 * (t / 32) + (t % 32) / 4;
    cs.col0 = 2 * (t % 4);
    const uint32_t s_qw = s_q + wg * kQ;
    const float c = scale * 1.4426950408889634f;     // scale log2(e)
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i) cs.o[cb][i] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      cs.m[r] = cs.mc[r] = kNegInf;
      cs.l[r] = 0.f;
    }

    // the two consumer warpgroups take turns to issue their products
    // (named barrier 1 + wg is this warpgroup's turn), so that one's
    // softmax runs while the other's products do; warpgroup 0 goes first
    auto turn_wait = [&] { bar_sync(1 + wg, 256); };
    auto turn_pass = [&] { bar_arrive(2 - wg, 256); };
    if (wg == 1) turn_pass();

    // tile 0's scores and p
    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    turn_wait();
    cs.fence_sc();
    wgmma_fence();
    cs.issue_qk(s_qw, s_k);
    wgmma_commit();
    turn_pass();
    wgmma_wait();
    cs.fence_sc();
    mbar_arrive(k_empty(0));
    cs.softmax(0, skv, causal, c);
    cs.split();

    // each step, in one turn: tile it's p @ V, then tile it+1's
    // S = Q K^T; then tile it+1's softmax.  Warpgroup 1 passes no turn
    // after its last, so every arrival on a barrier is waited for.
    for (int it = 0;; ++it) {
      const int s = it % kStages, sn = (it + 1) % kStages;
      const bool next = it + 1 < n_kv;
      mbar_wait(v_full(s), (it / kStages) & 1);
      if (next) mbar_wait(k_full(sn), ((it + 1) / kStages) & 1);
      turn_wait();
      cs.pv(s_v + s * kKV);
      mbar_arrive(v_empty(s));
      if (!next) {
        if (wg == 0) turn_pass();
        break;
      }
      cs.fence_sc();
      wgmma_fence();
      cs.issue_qk(s_qw, s_k + sn * kKV);
      wgmma_commit();
      turn_pass();
      wgmma_wait();
      cs.fence_sc();
      mbar_arrive(k_empty(sn));
      cs.softmax((it + 1) * kBKV, skv, causal, c);
      cs.split();
    }

    // out = acc / max(l, 1e-30), rounded to bf16 once
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = cs.row0 + 8 * r;
      if (row >= sq) continue;
      const float lr = fmaxf(cs.l[r], 1e-30f);
      __nv_bfloat16* orow =
          out + ((static_cast<int64_t>(bb) * sq + row) * n_heads + h) * HD;
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = 4 * j + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(orow + kBox * cb + 8 * j +
                                             cs.col0) =
              __floats2bfloat162_rn(cs.o[cb][i] / lr, cs.o[cb][i + 1] / lr);
        }
    }
  }
}

// the 4-D map of a bf16 [batch, seq, heads, hd] tensor with element
// strides (sb, ss, sh, 1), read in 64 x 64 boxes (hd columns x seq rows)
// under the 128-byte swizzle; out-of-range rows read as zeros
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
              int64_t hd, int64_t seq, int64_t heads, int64_t batch,
              int64_t sb, int64_t ss, int64_t sh) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kBox, kBox, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(void* out, const void* q, const void* k, const void* v,
                   int64_t b, int64_t sq, int64_t skv, int64_t h, int64_t kv,
                   int causal, const int64_t* st, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!make_map(encode, &mq, q, HD, sq, h, b, st[0], st[1], st[2]) ||
      !make_map(encode, &mk, k, HD, skv, kv, b, st[3], st[4], st[5]) ||
      !make_map(encode, &mv, v, HD, skv, kv, b, st[6], st[7], st[8]))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_kernel_wgmma<HD>;
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t blocks = (sq + kBQ - 1) / kBQ * h * b;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const float scale = static_cast<float>(1.0 / std::sqrt(double(HD)));
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), static_cast<int>(sq),
      static_cast<int>(skv), static_cast<int>(h), static_cast<int>(b),
      static_cast<int>(h / kv), causal, scale);
  return cudaGetLastError();
}

cudaError_t dispatch(int64_t hd, void* out, const void* q, const void* k,
                     const void* v, int64_t b, int64_t sq, int64_t skv,
                     int64_t h, int64_t kv, int causal, const int64_t* st,
                     cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<64>(out, q, k, v, b, sq, skv, h, kv, causal, st, stream);
    case 128: return launch<128>(out, q, k, v, b, sq, skv, h, kv, causal, st, stream);
    case 256: return launch<256>(out, q, k, v, b, sq, skv, h, kv, causal, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// out: contiguous [b, sq, h, hd]; q: [b, sq, h, hd], k and v: [b, skv, kv,
// hd], each with the head dim contiguous and strides (batch, seq, head) in
// elements.  dtype 0 = float32, 1 = bfloat16 (all four tensors alike).
// kernel 0 = `flash_attention_kernel` (CUDA cores: float32 at hd 16, 32,
// 64, 128 or 256, bfloat16 at 16 or 32), 1 =
// `flash_attention_kernel_wgmma` (tensor cores: bfloat16, hd 64, 128 or
// 256, skv > 0, q, k and v 16-byte aligned with
// strides of a multiple of 8 elements, as TMA reads them).  All pointers
// are device pointers on the current device; `stream` is a cudaStream_t.
// Returns cudaGetLastError() after the launch (0 = success),
// cudaErrorInvalidValue for arguments the chosen kernel does not take, or
// cudaErrorNotSupported where libcuda has no tensor-map encoder.
extern "C" int flash_attention_launch(
    int kernel, void* out, const void* q, const void* k, const void* v,
    int dtype, int64_t b, int64_t sq, int64_t skv, int64_t h, int64_t kv,
    int64_t hd, int causal, int64_t qsb, int64_t qss, int64_t qsh,
    int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
    int64_t vsh, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0 || kv <= 0 || h % kv != 0 || skv < 0 ||
      h > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();        // report only this launch's error
  const int64_t st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (kernel == 0 && dtype == 0) {
    err = dispatch<float>(hd, out, q, k, v, b, sq, skv, h, kv, causal, st, s);
  } else if (kernel == 0 && dtype == 1) {
    err = dispatch<__nv_bfloat16>(hd, out, q, k, v, b, sq, skv, h, kv,
                                  causal, st, s);
  } else if (kernel == 1 && dtype == 1 && skv > 0 && sq < INT_MAX &&
             skv < INT_MAX) {
    // TMA's rule (16-byte-aligned starts and strides) is checked by the
    // wrapper's `tma_readable`; here cuTensorMapEncodeTiled refuses what
    // breaks it (cudaErrorInvalidValue from `launch`)
    err = tc::dispatch(hd, out, q, k, v, b, sq, skv, h, kv, causal, st, s);
  }
  return static_cast<int>(err);
}
