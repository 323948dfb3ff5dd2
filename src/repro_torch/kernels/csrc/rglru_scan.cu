// rglru_scan for Hopper (sm_90a): the RG-LRU linear recurrence
// h[b, t, w] = a[b, t, w] * h[b, t-1, w] + b[b, t, w], h[b, -1, w] = 0, per
// channel, in fp32 from fp32 or bf16 inputs, the output in the inputs'
// dtype; and the RG-LRU block around it, with the recurrence's inputs made
// in its loads and its output gated in its stores.
//
// Replaces the Pallas kernel `rglru_scan` (`_scan_kernel`) in
// src/repro/kernels/rg_lru.py.  On the TPU the sequence is the innermost,
// sequential grid axis: h is carried in VMEM from one 256-step tile to the
// next.  Two kernels here, both one walk:
//
// * `rglru_slab_kernel` (the channel-slab walk, the bare scan).  One
//   block of one warp owns 32 contiguous channels of one batch row (128
//   bytes of fp32) for the whole sequence and carries h in registers, as the TPU kernel
//   carries it in VMEM.  Lane 0 keeps kSlabStages - 1 tiles of
//   [kSlabT steps x 32 channels] of a and b in flight into a ring in
//   shared memory (TMA on mbarriers); each lane runs h = fmaf(a, h, b) step
//   by step, in order, into an h tile that TMA stores.  So a and b are
//   read once and h written once: 3 x 537 MB = 1.61 GB at [1, 32768, 4096]
//   fp32, 0.481 ms
//   at 3.35 TB/s (0.403 GB, 0.120 ms at [4, 2048, 4096]): the bound's
//   bytes, and no carry is composed, so the result is the sequential
//   recurrence's.  Its parallelism is the slab count, B x W / 32: 128
//   slabs at [1, 32768, 4096] for 132 SMs, 512 at [4, 2048, 4096].  A
//   shape with fewer slabs than SMs leaves SMs idle: one slab streams at
//   about 20 GB/s, so the time is the sequence's length, flat in the slab
//   count (0.625 ms at S 32768 from 16 to 128 slabs on an H100).  A
//   single-pass scan with decoupled look-back (Merrill & Garland) would
//   also read once and fill the card at any width, but it composes
//   carries across chunks (another order than the recurrence) and needs a
//   flag protocol between blocks; the model's shapes give enough slabs
//   without it.
//
// * `rglru_gated_kernel`: the slab walk with the RG-LRU block's operands
//   made in its loads and its output gated in its stores.  Per element,
//   from the gate logits ra, ri (fp32), the conv output xc and the GeLU
//   branch `gate` (fp32 or bf16), with the per-channel ba, bi, a_param:
//     r = sigmoid(ra + ba), i = sigmoid(ri + bi),
//     log_a = (-8 logaddexp(a_param, 0)) r, a = exp(log_a),
//     beta = sqrt(max(1 - exp(2 log_a), 1e-6)), b = beta (i xc),
//     h = a h + b (the walk above), y = h gelu_tanh(gate),
//   y rounded once (to nearest even) into the output dtype: the arithmetic
//   of models/layers.py's `_rglru_gates`, `_rglru_decay`,
//   `rglru_scan_inputs` and `rglru_output`, op for op in the same order
//   and with the same functions (accurate expf, log1pf, tanhf; IEEE
//   division and sqrt; no fast math), as PyTorch's CUDA kernels compute
//   them.  The per-element work (about 110 instructions, 5
//   transcendentals) must stay off the h chain (one FMA a step), so the
//   block is warp-specialised: warp 0 issues the TMA loads of xc, ra, ri
//   and gate into a ring of kGStages stages; kGWorkers worker warps read
//   each stage, free it, and write a, b and g = gelu_tanh(gate) into a slot
//   of fp32 tiles; warp 1 runs the chain over a and b and writes h over b;
//   the workers, kGLag tiles behind, write y = h g into a y tile that TMA
//   stores.  ra and ri
//   are read where the gate einsum leaves them, head-major
//   ([heads, B, S, hd] storage), through a 4-D tensor map (channel in
//   head, step, head, batch).  Bytes at [1, 32768, 4096]: xc, ra, ri fp32
//   and gate bf16 read once (1.88 GB), y bf16 written once (0.27 GB):
//   2.15 GB, 0.64 ms at 3.35 TB/s; its transcendentals (about 0.67 G) take
//   about 0.18 ms at the MUFU rate, so it stays bytes-bound.
//
// Every tile is a TMA box of 32 channels x k steps; steps past the end of
// the sequence and channels past the end of a tensor arrive as zeros, run
// through the chain harmlessly (they come after every real step of their
// channel) and are never stored.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using tc::bulk_commit;
using tc::bulk_wait_read;
using tc::fence_barrier_init;
using tc::fence_proxy_async;
using tc::mbar_arrive;
using tc::mbar_expect_tx;
using tc::mbar_init;
using tc::mbar_wait;
using tc::smem_u32;
using tc::tma_load;
using tc::tma_store;

constexpr int kAhead = 8;          // steps loaded before they are consumed
constexpr int kC = 32;             // channels of a slab: one warp's lanes

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);     // round to nearest even
}

template <typename T>
constexpr CUtensorMapDataType tma_dtype() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// ==================================================== the channel-slab walk

// the 4-D map of an operand [B, S, groups, inner] (inner contiguous; the
// step, group and batch strides in elements, multiples of 16 bytes), read
// in boxes of 32 channels x `box_t` steps of one group and batch row
bool make_map(CUtensorMap* map, CUtensorMapDataType dtype, int elem,
              const void* ptr, int64_t inner, int64_t s, int64_t groups,
              int64_t batch, int64_t ss, int64_t sg, int64_t sb, int box_t) {
  const tc::EncodeTiled encode = tc::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(s),
      static_cast<cuuint64_t>(groups), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss * elem),
                                 static_cast<cuuint64_t>(sg * elem),
                                 static_cast<cuuint64_t>(sb * elem)};
  const cuuint32_t box[4] = {kC, static_cast<cuuint32_t>(box_t), 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return encode(map, dtype, 4, const_cast<void*>(ptr), dims, strides, box,
                one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// one operand's geometry, as the wrappers pass it: [B, S, groups, inner]
// with the channel c at (group c / inner, inner index c % inner)
struct Operand {
  const void* ptr;
  int64_t inner, groups, ss, sg, sb;
};

// --------------------------------------------------------------- bare scan

constexpr int kSlabT = 32;         // steps a tile
constexpr int kSlabStages = 6;     // tiles of a and b in the ring

template <typename T>
struct SlabCfg {
  static constexpr uint32_t kTile = kSlabT * kC * sizeof(T);
  static constexpr uint32_t kStage = 2 * kTile;                 // a, b
  static constexpr uint32_t kSmem =
      128 + kSlabStages * (kStage + 8) + 2 * kTile;             // + 2 h
};

// One warp: lane 0 keeps kSlabStages - 1 tiles of a and b in flight; every
// lane steps its channel through each tile and writes h into one of two
// h tiles, which lane 0 stores with TMA: one warp storing its own
// 128-byte row every step cannot keep up with the loads.
template <typename T>
__global__ void __launch_bounds__(32)
rglru_slab_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_b,
                  const __grid_constant__ CUtensorMap tm_out, int64_t s,
                  int n_groups, int64_t a_inner, int64_t b_inner) {
  using C = SlabCfg<T>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t pad = ((base + 127) & ~127u) - base;
  const uint32_t ring = base + pad;
  const uint8_t* ring_ptr = smem_raw + pad;
  const uint32_t hs = ring + kSlabStages * C::kStage;
  T* hs_ptr = reinterpret_cast<T*>(smem_raw + pad + kSlabStages * C::kStage);
  const uint32_t bars = hs + 2 * C::kTile;
  auto full = [&](int st) { return bars + 8 * st; };

  const int lane = threadIdx.x;
  const int bi = static_cast<int>(blockIdx.x / n_groups);
  const int c0 = static_cast<int>(blockIdx.x % n_groups) * kC;
  const int n_tiles = static_cast<int>((s + kSlabT - 1) / kSlabT);
  if (lane == 0) {
    for (int st = 0; st < kSlabStages; ++st) mbar_init(full(st), 1);
    fence_barrier_init();
  }
  __syncwarp();
  auto issue = [&](int k) {
    const int st = k % kSlabStages;
    const uint32_t dst = ring + st * C::kStage;
    mbar_expect_tx(full(st), C::kStage);
    tma_load(dst, &tm_a, full(st), static_cast<int>(c0 % a_inner),
             k * kSlabT, static_cast<int>(c0 / a_inner), bi);
    tma_load(dst + C::kTile, &tm_b, full(st),
             static_cast<int>(c0 % b_inner), k * kSlabT,
             static_cast<int>(c0 / b_inner), bi);
  };
  if (lane == 0)
    for (int k = 0; k < kSlabStages - 1 && k < n_tiles; ++k) issue(k);

  float h = 0.f;
  for (int k = 0; k < n_tiles; ++k) {
    // into the slot of tile k - 1, which every lane read before the
    // __syncwarp that ended the last step (generic reads, then the TMA
    // write: the order CUTLASS's pipelines rely on too)
    if (lane == 0) {
      if (k + kSlabStages - 1 < n_tiles) issue(k + kSlabStages - 1);
      bulk_wait_read<1>();       // tile k - 2's h tile is free again
    }
    __syncwarp();
    const int st = k % kSlabStages;
    mbar_wait(full(st), (k / kSlabStages) & 1);
    const T* ta = reinterpret_cast<const T*>(ring_ptr + st * C::kStage)
                  + lane;
    const T* tb = reinterpret_cast<const T*>(ring_ptr + st * C::kStage
                                             + C::kTile) + lane;
    T* th = hs_ptr + (k & 1) * kSlabT * kC + lane;
#pragma unroll
    for (int r0 = 0; r0 < kSlabT; r0 += kAhead) {
      float av[kAhead], bv[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        av[u] = to_float(ta[(r0 + u) * kC]);
        bv[u] = to_float(tb[(r0 + u) * kC]);
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        h = fmaf(av[u], h, bv[u]);
        store(th + (r0 + u) * kC, h);
      }
    }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      tma_store(&tm_out, hs + (k & 1) * C::kTile, c0, k * kSlabT, 0, bi);
      bulk_commit();
    }
  }
  if (lane == 0) bulk_wait_read<0>();
}

// the map of the output [batch, s, w] with row stride ldo elements
bool make_out_map(CUtensorMap* map, CUtensorMapDataType dtype, int elem,
                  void* ptr, int64_t batch, int64_t s, int64_t w,
                  int64_t ldo, int box_t) {
  return make_map(map, dtype, elem, ptr, w, s, 1, batch, ldo, ldo, s * ldo,
                  box_t);
}

template <typename T>
cudaError_t launch_slab(void* out, int64_t ldo, const Operand& a,
                        const Operand& b, int64_t batch, int64_t s,
                        int64_t w, cudaStream_t stream) {
  using C = SlabCfg<T>;
  CUtensorMap ma, mb, mo;
  if (!make_map(&ma, tma_dtype<T>(), sizeof(T), a.ptr, a.inner, s, a.groups,
                batch, a.ss, a.sg, a.sb, kSlabT) ||
      !make_map(&mb, tma_dtype<T>(), sizeof(T), b.ptr, b.inner, s, b.groups,
                batch, b.ss, b.sg, b.sb, kSlabT) ||
      !make_out_map(&mo, tma_dtype<T>(), sizeof(T), out, batch, s, w, ldo,
                    kSlabT))
    return cudaErrorInvalidValue;
  const int64_t n_groups = (w + kC - 1) / kC;
  auto kernel = rglru_slab_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned int>(batch * n_groups), 32, C::kSmem,
           stream>>>(ma, mb, mo, s, static_cast<int>(n_groups), a.inner,
                     b.inner);
  return cudaGetLastError();
}

// ------------------------------------------------------------ gated block

constexpr int kGT = 32;            // steps a tile
constexpr int kGStages = 4;        // TMA stages (xc, ra, ri, gate)
constexpr int kGLag = 2;           // tiles the epilogue trails the prologue
constexpr int kGSlots = kGLag + 1; // a, b (then h), g slots
constexpr int kGWorkers = 16;      // prologue / epilogue warps
constexpr int kGThreads = 32 * (2 + kGWorkers);
constexpr int kGRows = kGT / kGWorkers;    // rows of a tile a worker takes
static_assert(kGT % kGWorkers == 0, "whole rows for every worker warp");

template <typename TX, typename TG, typename TO>
struct GatedCfg {
  static constexpr uint32_t kXc = kGT * kC * sizeof(TX);
  static constexpr uint32_t kRa = kGT * kC * 4;
  static constexpr uint32_t kGate = kGT * kC * sizeof(TG);
  static constexpr uint32_t kStage = kXc + 2 * kRa + kGate;
  static constexpr uint32_t kTile = kGT * kC * 4;               // fp32
  static constexpr uint32_t kSlot = 3 * kTile;                  // a, b, g
  static constexpr uint32_t kY = kGT * kC * sizeof(TO);
  static constexpr uint32_t kSmem = 128 + kGStages * (kStage + 16)
                                    + kGSlots * (kSlot + 16) + 2 * kY;
};

// torch.sigmoid on CUDA: 1 / (1 + exp(-x))
__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}
// torch.logaddexp(x, 0) on CUDA: max + log1p(exp(-|x - 0|))
__device__ __forceinline__ float logaddexp0(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}
// F.gelu(x, approximate="tanh") on CUDA, its constants as PyTorch's
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = static_cast<float>(
      1.41421356237309504880 * 1.12837916709551257390 * 0.5);
  constexpr float kKappa = 0.044715f;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.f + tanhf(inner));
}
// torch.clamp_min(x, 1e-6): NaN stays NaN
__device__ __forceinline__ float clamp_min_1e6(float x) {
  return isnan(x) ? x : fmaxf(x, 1e-6f);
}
// the worker warps' own barrier (barrier 0 is __syncthreads')
__device__ __forceinline__ void workers_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(32 * kGWorkers) : "memory");
}

// Shared memory: kGStages TMA stages (xc, ra, ri, gate tiles), which only
// TMA writes and the workers' prologue reads; kGSlots slots of fp32 tiles
// a, b and g = gelu(gate), which only threads touch (the prologue writes
// a, b, g, the chain reads a and b and writes h over b, the epilogue reads
// h and g); and two y tiles, which the epilogue writes and a TMA store
// reads.  A stage is free once its prologue has read it; a slot once its
// epilogue has (the same worker thread writes the next tile into it,
// after, in program order); a y tile once its store has read it.
template <typename TX, typename TG, typename TO>
__global__ void __launch_bounds__(kGThreads, 2)
rglru_gated_kernel(const __grid_constant__ CUtensorMap tm_xc,
                   const __grid_constant__ CUtensorMap tm_ra,
                   const __grid_constant__ CUtensorMap tm_ri,
                   const __grid_constant__ CUtensorMap tm_gate,
                   const __grid_constant__ CUtensorMap tm_out,
                   const float* __restrict__ ba,
                   const float* __restrict__ bi_,
                   const float* __restrict__ a_param, int64_t s, int64_t w,
                   int n_groups, int64_t xc_inner, int64_t ra_inner,
                   int64_t ri_inner, int64_t gate_inner) {
  using C = GatedCfg<TX, TG, TO>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t pad = ((base + 127) & ~127u) - base;
  const uint32_t ring = base + pad;
  uint8_t* ring_ptr = smem_raw + pad;
  uint8_t* slot_ptr = ring_ptr + kGStages * C::kStage;
  const uint32_t ys = ring + kGStages * C::kStage + kGSlots * C::kSlot;
  TO* ys_ptr = reinterpret_cast<TO*>(slot_ptr + kGSlots * C::kSlot);
  const uint32_t bars = ys + 2 * C::kY;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kGStages + st); };
  auto ab = [&](int sl) { return bars + 8 * (2 * kGStages + sl); };
  auto hd = [&](int sl) { return bars + 8 * (2 * kGStages + kGSlots + sl); };
  auto tile = [&](int sl, int i) {        // i: 0 = a, 1 = b / h, 2 = g
    return reinterpret_cast<float*>(slot_ptr + sl * C::kSlot
                                    + i * C::kTile);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bi = static_cast<int>(blockIdx.x / n_groups);
  const int c0 = static_cast<int>(blockIdx.x % n_groups) * kC;
  const int n_tiles = static_cast<int>((s + kGT - 1) / kGT);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kGStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kGWorkers);    // one arrival a worker warp
    }
    for (int sl = 0; sl < kGSlots; ++sl) {
      mbar_init(ab(sl), kGWorkers);
      mbar_init(hd(sl), 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 0) {
    // ---- producer: one lane issues every load ----
    if (lane == 0) {
      for (int k = 0; k < n_tiles; ++k) {
        const int st = k % kGStages;
        mbar_wait(empty(st), ((k / kGStages) & 1) ^ 1);
        mbar_expect_tx(full(st), C::kStage);
        const uint32_t dst = ring + st * C::kStage;
        const int t = k * kGT;
        tma_load(dst, &tm_xc, full(st), static_cast<int>(c0 % xc_inner), t,
                 static_cast<int>(c0 / xc_inner), bi);
        tma_load(dst + C::kXc, &tm_ra, full(st),
                 static_cast<int>(c0 % ra_inner), t,
                 static_cast<int>(c0 / ra_inner), bi);
        tma_load(dst + C::kXc + C::kRa, &tm_ri, full(st),
                 static_cast<int>(c0 % ri_inner), t,
                 static_cast<int>(c0 / ri_inner), bi);
        tma_load(dst + C::kXc + 2 * C::kRa, &tm_gate, full(st),
                 static_cast<int>(c0 % gate_inner), t,
                 static_cast<int>(c0 / gate_inner), bi);
      }
    }
    return;
  }

  if (warp == 1) {
    // ---- the h chain: h = fmaf(a, h, b) step by step, h over b ----
    float h = 0.f;
    for (int k = 0; k < n_tiles; ++k) {
      const int sl = k % kGSlots;
      mbar_wait(ab(sl), (k / kGSlots) & 1);
      const float* A = tile(sl, 0) + lane;
      float* B = tile(sl, 1) + lane;
#pragma unroll
      for (int r0 = 0; r0 < kGT; r0 += kAhead) {
        float av[kAhead], bv[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          av[u] = A[(r0 + u) * kC];
          bv[u] = B[(r0 + u) * kC];
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          h = fmaf(av[u], h, bv[u]);
          B[(r0 + u) * kC] = h;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(hd(sl));
    }
    return;
  }

  // ---- workers: a, b and g in the loads, y in the stores ----
  const int wk = warp - 2;
  const bool elected = wk == 0 && lane == 0;   // issues the y stores
  const int c = c0 + lane;
  float cba = 0.f, cbi = 0.f, log_a0 = 0.f;
  if (c < w) {
    cba = ba[c];
    cbi = bi_[c];
    log_a0 = -8.f * logaddexp0(a_param[c]);
  }
  for (int k = 0; k < n_tiles + kGLag; ++k) {
    if (k < n_tiles) {
      const int st = k % kGStages, sl = k % kGSlots;
      mbar_wait(full(st), (k / kGStages) & 1);
      const uint8_t* sp = ring_ptr + st * C::kStage;
      const TX* X = reinterpret_cast<const TX*>(sp) + lane;
      const float* RA = reinterpret_cast<const float*>(sp + C::kXc) + lane;
      const float* RI = reinterpret_cast<const float*>(sp + C::kXc + C::kRa)
                        + lane;
      const TG* G = reinterpret_cast<const TG*>(sp + C::kXc + 2 * C::kRa)
                    + lane;
      float x[kGRows], ra[kGRows], ri[kGRows], g[kGRows];
#pragma unroll
      for (int u = 0; u < kGRows; ++u) {
        const int r = (wk + u * kGWorkers) * kC;
        x[u] = to_float(X[r]);
        ra[u] = RA[r];
        ri[u] = RI[r];
        g[u] = to_float(G[r]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));   // the stage is read
      float* A = tile(sl, 0) + lane;
      float* B = tile(sl, 1) + lane;
      float* Gl = tile(sl, 2) + lane;
#pragma unroll
      for (int u = 0; u < kGRows; ++u) {
        const int r = (wk + u * kGWorkers) * kC;
        const float rr = sigmoid_f(ra[u] + cba);
        const float ii = sigmoid_f(ri[u] + cbi);
        const float log_a = log_a0 * rr;
        const float a = expf(log_a);
        const float beta = sqrtf(clamp_min_1e6(1.f - expf(2.f * log_a)));
        A[r] = a;
        B[r] = beta * (ii * x[u]);
        Gl[r] = gelu_tanh(g[u]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(ab(sl));
    }
    if (k >= kGLag) {
      const int j = k - kGLag, sl = j % kGSlots;
      mbar_wait(hd(sl), (j / kGSlots) & 1);
      const float* Hh = tile(sl, 1) + lane;
      const float* Gl = tile(sl, 2) + lane;
      TO* Y = ys_ptr + (j & 1) * kGT * kC + lane;
#pragma unroll
      for (int u = 0; u < kGRows; ++u) {
        const int r = (wk + u * kGWorkers) * kC;
        store(Y + r, Hh[r] * Gl[r]);
      }
      fence_proxy_async();
      if (elected) bulk_wait_read<0>();        // y tile j - 1 is read
      workers_sync();
      if (elected) {
        tma_store(&tm_out, ys + (j & 1) * C::kY, c0, j * kGT, 0, bi);
        bulk_commit();
      }
    }
  }
  if (elected) bulk_wait_read<0>();
}

template <typename TX, typename TG, typename TO>
cudaError_t launch_gated(void* out, int64_t ldo, const Operand& xc,
                         const Operand& ra, const Operand& ri,
                         const Operand& gate, const float* ba,
                         const float* bi, const float* a_param,
                         int64_t batch, int64_t s, int64_t w,
                         cudaStream_t stream) {
  using C = GatedCfg<TX, TG, TO>;
  CUtensorMap mx, ma, mi, mg, mo;
  if (!make_map(&mx, tma_dtype<TX>(), sizeof(TX), xc.ptr, xc.inner, s,
                xc.groups, batch, xc.ss, xc.sg, xc.sb, kGT) ||
      !make_map(&ma, tma_dtype<float>(), 4, ra.ptr, ra.inner, s, ra.groups,
                batch, ra.ss, ra.sg, ra.sb, kGT) ||
      !make_map(&mi, tma_dtype<float>(), 4, ri.ptr, ri.inner, s, ri.groups,
                batch, ri.ss, ri.sg, ri.sb, kGT) ||
      !make_map(&mg, tma_dtype<TG>(), sizeof(TG), gate.ptr, gate.inner, s,
                gate.groups, batch, gate.ss, gate.sg, gate.sb, kGT) ||
      !make_out_map(&mo, tma_dtype<TO>(), sizeof(TO), out, batch, s, w, ldo,
                    kGT))
    return cudaErrorInvalidValue;
  const int64_t n_groups = (w + kC - 1) / kC;
  auto kernel = rglru_gated_kernel<TX, TG, TO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned int>(batch * n_groups), kGThreads, C::kSmem,
           stream>>>(mx, ma, mi, mg, mo, ba, bi, a_param, s, w,
                     static_cast<int>(n_groups), xc.inner, ra.inner,
                     ri.inner, gate.inner);
  return cudaGetLastError();
}

// an operand from its numbers in `g`: inner, groups and the step, group and
// batch strides (elements); true where a slab of 32 channels stays inside
// one group and TMA can read it (16-byte aligned start and strides)
bool operand(Operand* op, const void* ptr, const int64_t* g, int elem,
             int64_t w) {
  *op = {ptr, g[0], g[1], g[2], g[3], g[4]};
  if (op->inner <= 0 || op->groups <= 0) return false;
  if (op->groups > 1 && (op->inner % kC || op->inner * op->groups != w))
    return false;
  if (op->groups == 1 && op->inner < w) return false;
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  for (int i = 2; i < 5; ++i)
    if ((g[i] * elem) % 16 || g[i] <= 0) return false;
  return true;
}

// shapes both kernels take: coordinates in int, the output's row
// stride ldo >= w in whole 16-byte rows, 16-byte aligned
bool slab_shape(const void* out, int64_t ldo, int elem, int64_t batch,
                int64_t s, int64_t w) {
  return batch > 0 && s > 0 && w > 0 && s <= INT32_MAX &&
         batch * ((w + kC - 1) / kC) <= INT32_MAX && ldo >= w &&
         (ldo * elem) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

}  // namespace

// h = scan(a, b): a and b [batch, s, w] read by TMA, their channel dim
// contiguous, their batch and step strides (asb, ass, bsb, bss, elements)
// and their start 16-byte multiples; out [batch, s, w] with row stride ldo
// (elements, whole 16-byte rows).  dtype 0 = float32, 1 = bfloat16 (out, a
// and b alike).  All pointers are device pointers on the current device;
// `stream` is a cudaStream_t.  Returns cudaGetLastError() after the launch
// (0 = success), cudaErrorInvalidValue for arguments the kernel does not
// take, or cudaErrorNotSupported where libcuda has no tensor-map encoder.
extern "C" int rglru_scan_launch(void* out, int64_t ldo, const void* a,
                                 const void* b, int dtype, int64_t batch,
                                 int64_t s, int64_t w, int64_t asb,
                                 int64_t ass, int64_t bsb, int64_t bss,
                                 void* stream) {
  if (dtype & ~1) return static_cast<int>(cudaErrorInvalidValue);
  const int elem = dtype == 0 ? 4 : 2;
  const int64_t ga[5] = {w, 1, ass, ass, asb};
  const int64_t gb[5] = {w, 1, bss, bss, bsb};
  Operand oa, ob;
  if (!slab_shape(out, ldo, elem, batch, s, w) ||
      !operand(&oa, a, ga, elem, w) || !operand(&ob, b, gb, elem, w))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tc::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  (void)cudaGetLastError();        // report only this call's error
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? launch_slab<float>(out, ldo, oa, ob, batch, s, w, st)
                 : launch_slab<__nv_bfloat16>(out, ldo, oa, ob, batch, s, w,
                                              st));
}

// y = scan(a, b) * gelu_tanh(gate), a and b made from xc, ra, ri and the
// per-channel ba, bi, a_param (fp32, contiguous [w]) as the header says.
// out: [batch, s, w] with row stride ldo (elements, whole 16-byte rows),
// dtype out_dtype.  Each of xc, ra, ri, gate is [batch, s, groups, inner]
// with groups * inner = w (or one group of inner >= w), inner contiguous,
// described by six numbers in `geom` (inner, groups, step stride, group
// stride, batch stride, in elements, and one unused), 16-byte aligned with
// strides multiples of 16 bytes, and inner a multiple of 32 where
// groups > 1.  ra and ri are fp32; xc, gate and out take dtype 0 =
// float32 or 1 = bfloat16.  Returns cudaGetLastError() after the launch
// (0 = success), cudaErrorInvalidValue for arguments the kernel does not
// take, or cudaErrorNotSupported where libcuda has no tensor-map encoder.
extern "C" int rglru_gated_scan_launch(void* out, int64_t ldo, int out_dtype,
                                       const void* xc, int xc_dtype,
                                       const void* ra, const void* ri,
                                       const void* gate, int gate_dtype,
                                       const int64_t* geom, const void* ba,
                                       const void* bi, const void* a_param,
                                       int64_t batch, int64_t s, int64_t w,
                                       void* stream) {
  if ((xc_dtype | gate_dtype | out_dtype) & ~1 ||
      !slab_shape(out, ldo, out_dtype == 0 ? 4 : 2, batch, s, w))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tc::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  (void)cudaGetLastError();        // report only this call's error
  Operand ox, oa, oi, og;
  const int ex = xc_dtype == 0 ? 4 : 2, eg = gate_dtype == 0 ? 4 : 2;
  if (!operand(&ox, xc, geom, ex, w) || !operand(&oa, ra, geom + 6, 4, w) ||
      !operand(&oi, ri, geom + 12, 4, w) ||
      !operand(&og, gate, geom + 18, eg, w))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const float* fba = static_cast<const float*>(ba);
  const float* fbi = static_cast<const float*>(bi);
  const float* fap = static_cast<const float*>(a_param);
  using f32 = float;
  using b16 = __nv_bfloat16;
#define RGLRU_GATED(TX, TG, TO)                                             \
  return static_cast<int>(launch_gated<TX, TG, TO>(                         \
      out, ldo, ox, oa, oi, og, fba, fbi, fap, batch, s, w, st));
  switch (xc_dtype << 2 | gate_dtype << 1 | out_dtype) {
    case 0: RGLRU_GATED(f32, f32, f32)
    case 1: RGLRU_GATED(f32, f32, b16)
    case 2: RGLRU_GATED(f32, b16, f32)
    case 3: RGLRU_GATED(f32, b16, b16)
    case 4: RGLRU_GATED(b16, f32, f32)
    case 5: RGLRU_GATED(b16, f32, b16)
    case 6: RGLRU_GATED(b16, b16, f32)
    default: RGLRU_GATED(b16, b16, b16)
  }
#undef RGLRU_GATED
}
