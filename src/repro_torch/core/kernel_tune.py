"""Kernel-tile DSE: the paper's loop-tiling optimization applied to the
tiles of the matmul kernels (`kernels/matmul.py`).

The model is the reference's (`repro.core.kernel_tune`), with the chip as
a parameter: for a product (M, K, N) at tile t = (bm, bk, bn),

  compute        = 2 ceil(M/bm) ceil(N/bn) ceil(K/bk) bm bk bn FLOP
                   over the peak of the datapath the kernel runs on
                                                              (Eqs. 3-4)
  memory traffic = x tiles refetched ceil(N/bn) times + y tiles refetched
                   ceil(M/bm) times + the output once, over the HBM rate
                                                              (Eqs. 5-8)
  fast memory    = stages x (bm bk + bk bn) x dtype bytes, plus the fp32
                   accumulator bm bn x 4 where the chip keeps it there
                                                             (Eqs. 10-13)
  latency        = max(compute, memory)

On the TPU the accumulator sits in VMEM beside the double-buffered input
tiles.  On Hopper it sits in registers, and only the input tiles use
shared memory, so the constraint splits in two: the input tiles' stages in
a block's shared memory, and the accumulator in the registers of the
block's threads.  The tuner sweeps the tiles the CUDA kernel of the dtype
is built for (`kernels.matmul.CUDA_CORE.tiles` for fp32,
`TENSOR_CORE.tiles` for bf16), so every tile it picks can be launched.

A GPU runs blocks side by side on its SMs, and the terms the TPU model
lacks are what rank a GPU kernel's tiles.  Each is a `TileChip` field that
is off by default, so that the reference's constants give the reference's
model exactly:

  waves (`sms`)  blocks per SM = min(what shared memory admits, what the
                 registers admit); waves = ceil(tiles / (SMs x blocks per
                 SM)); compute = waves x blocks per SM x one block's time,
                 a block's share of the peak being peak / SMs.  A ragged
                 last wave costs a whole one.
  operands (`smem_bw`)  the tensor-core kernel's shared memory traffic a
                 K tile: TMA's writes of the x and y tiles, and each wgmma
                 instruction's reads of its 64-row A and its B (a consumer
                 warpgroup issues one per 64 rows it owns), at 128 bytes a
                 clock an SM.  A block's K tile takes the longer of its
                 tensor-core time and this; narrow tiles lose here.
  latency (`load_latency_s`)  with S stages in the ring, S - 1 loads are in
                 flight while one stage is multiplied: a K tile takes at
                 least the load latency over S - 1.  Two-stage tiles lose.
  launch order (`group_m`)  the kernel launches its blocks in groups of
                 `group_m` tile rows; the model takes a group's x rows as
                 read from HBM once and y once per group (L2 holds what a
                 group shares), instead of the refetch counts above.

The H100's tensor-core chip (`H100_TC_TILES`) takes all four, fitted to
the kernel's structure (`csrc/matmul.cu`): stages fill the shared memory
(`tc_stages`, the kernel's formula), so one block runs on an SM.  The
CUDA-core chip (`H100_TILES`) follows `matmul_kernel`'s structure:

  threads (`thread_tile`)  a thread holds 8 x 8 outputs, so a block has
                 bm bn / 64 threads (64 to 256 over the kernel's tiles).
  stages         the cp.async ring holds three stages where three
                 fit in a block's shared memory, else as many as fit
                 (`cc_stages`, the kernel's formula: two for the bk = 128
                 tiles of bm + bn = 192).
  registers      a thread's 64 accumulators plus `reg_overhead` (its x and
                 y fragments, 32 + 8, addresses and loop state: ptxas
                 gives 168 a thread at bk <= 32), within `reg_budget`
                 (255: the kernel caps none); a block needs its threads'
                 registers on one SM.
  waves          blocks an SM = the fewest that its shared memory, its
                 registers and its 2048 threads admit, and the wave term.
  occupancy (`occupancy`, `peak_share`)  an SM's FMAs issue from its 4
                 schedulers; one with n resident warps issues 1 -
                 exp(-n / occupancy) of the time, one with none never, and
                 a full SM reaches `peak_share` of the peak (`issue_share`).
                 Each of a block's K tiles also costs it `k_tile_s` (its
                 barrier and the wait for its stage), which sets the
                 depths apart: bk = 16 ran some 12 % slower than bk = 64
                 at 128 x 128.  Fitted on the card's sweeps of the 15
                 tiles at 8192^3 (`chip_smoke.py`'s tile DSE): 4 warps an
                 SM ran 0.81x as fast as 8 (occupancy 0.69), 8 warps
                 reached 62 % of the peak (0.656), and 0.2 us a K tile
                 ranks the sweep best (rank correlation 0.88 over two
                 sweeps) and picks their fastest tile, 128 x 64 x 128.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.roofline import HW
from repro_torch.kernels.matmul import CUDA_CORE, TENSOR_CORE

__all__ = ["TileChip", "H100_TILES", "H100_TC_TILES", "SMEM_PER_SM",
           "REGS_PER_SM", "THREADS_PER_SM", "TileConfig", "tc_stages",
           "tc_consumers", "cc_stages", "block_threads", "issue_share",
           "tile_cost", "tune_matmul_tiles"]


@dataclasses.dataclass(frozen=True)
class TileChip:
    """What the tile model needs to know of a chip and the kernel on it."""

    peak_flops: float          # of the datapath the kernel multiplies on
    hbm_bw: float              # bytes/s
    smem_bytes: int            # fast memory one block may use
    stages: int                # buffers of each input tile
    acc_in_smem: bool          # fp32 accumulator in that memory (TPU VMEM)
    align: Tuple[int, int, int]   # bm, bk, bn must be multiples of these
    reg_budget: int = 0        # 32-bit registers a thread may spend on
                               # its accumulator and the rest; 0: none
    # --- GPU terms, each off at its default (module docstring) ---
    tensor_core: bool = False  # the wgmma kernel: stages fill the shared
                               # memory (`tc_stages`), its consumer split,
                               # and the accumulator alone against
                               # `reg_budget` (a consumer thread's share)
    sms: int = 0               # SMs; > 0: the wave term
    reg_overhead: int = 0      # registers a thread holds beside its tiles
    smem_bw: float = 0.0       # shared-memory bytes/s an SM; > 0: the
                               # operand term
    load_latency_s: float = 0.0   # > 0: the latency term
    group_m: int = 0           # > 0: the launch-order memory term
    thread_tile: int = 0       # > 0: the CUDA-core kernel, each thread
                               # holding this many outputs: bm bn /
                               # thread_tile threads a block, thread_tile
                               # + `reg_overhead` registers each, and
                               # min(`stages`, what fits) stages
                               # (`cc_stages`)
    occupancy: float = 0.0     # > 0: the occupancy term (module docstring)
    peak_share: float = 1.0    # of the peak, an SM full of warps
    k_tile_s: float = 0.0      # a block's fixed time a K tile (its barrier
                               # and the wait for its stage), added to the
                               # occupancy term's


# what an H100 SM shares among its blocks: 228 KB of shared memory (1 KB
# of it reserved per block), 65,536 registers and 2048 threads
SMEM_PER_SM = 233472
REGS_PER_SM = 65536
THREADS_PER_SM = 2048


def tc_stages(bm: int, bk: int, bn: int, *, dtype_bytes: int = 2,
              smem_bytes: int = 232448, reserve: int = 2048) -> int:
    """Stages of the tensor-core kernel's (x, y) ring: as many as fit in
    the shared memory a block may use, less the reserve for alignment and
    mbarriers (`tc::stages` in `csrc/matmul.cu`, the same formula)."""
    return (smem_bytes - reserve) // ((bm + bn) * bk * dtype_bytes)


def cc_stages(bm: int, bk: int, bn: int, *, dtype_bytes: int = 4,
              smem_bytes: int = 232448, max_stages: int = 3) -> int:
    """Stages of the CUDA-core kernel's (x, y) cp.async ring: `max_stages`
    where they fit in the shared memory a block may use, else as many as
    fit (`cc_stages` in `csrc/matmul.cu`, the same formula)."""
    return min(max_stages, smem_bytes // ((bm + bn) * bk * dtype_bytes))


def block_threads(t: "TileConfig", chip: "TileChip") -> int:
    """Threads of one block of the CUDA-core kernel at tile t: bm bn over
    the outputs a thread holds."""
    return t.bm * t.bn // chip.thread_tile


def issue_share(warps: int, chip: "TileChip") -> float:
    """The occupancy term: the share of its FMA peak an SM reaches with
    `warps` resident warps, spread over its 4 schedulers.  A scheduler
    with n warps issues 1 - exp(-n / occupancy) of the time (its warps
    wait on loads, barriers and dependent FMAs), one with none never, and a
    full SM `peak_share` of the peak."""
    active = min(4, warps)
    return (chip.peak_share * active / 4
            * (1.0 - math.exp(-warps / active / chip.occupancy)))


def tc_consumers(bm: int, bn: int) -> Tuple[int, int, int]:
    """The tensor-core kernel's split of a bm x bn tile (`tc::Cfg`):
    (consumer warpgroups, rows, columns of each).  Two split the rows when
    bm >= 128, else the columns when bn >= 128; a 64 x 64 tile has one."""
    cons = 2 if bm >= 128 or bn >= 128 else 1
    if bm >= 128:
        return cons, bm // cons, bn
    return cons, bm, bn // cons


_H100 = HW()
#: the H100 and `matmul_kernel` in `csrc/matmul.cu` (fp32 inputs): fp32
#: FMAs on the CUDA cores, at most 232,448 bytes of shared memory a block
#: (opt-in above 48 KB), a cp.async ring of three stages where they fit
#: (`cc_stages`), 8 x 8 outputs a thread (bm bn / 64 threads a block), 64
#: accumulators and 104 more registers a thread (168, as ptxas reports at
#: bk <= 32; the kernel caps none), waves over 132 SMs, and the occupancy
#: term and the cost of a K tile fitted on the card (module docstring)
H100_TILES = TileChip(peak_flops=_H100.fp32_flops, hbm_bw=_H100.hbm_bw,
                      smem_bytes=232448, stages=3, acc_in_smem=False,
                      align=(64, 16, 64), reg_budget=255, sms=132,
                      reg_overhead=104, thread_tile=64, occupancy=0.69,
                      peak_share=0.656, k_tile_s=0.2e-6)
#: the H100 and `tc::matmul_kernel_wgmma` (bf16 inputs): the tensor-core
#: peak, tiles in whole 64 x 64 x 64 wgmma and swizzle units, the ring
#: filling the shared memory, an accumulator of at most 128 registers a
#: consumer thread (of its 232 after `setmaxnreg`), 128 bytes of shared
#: memory a clock an SM at the clock the peak implies (989e12 / (132 x
#: 4096 FLOP a clock) = 1.83 GHz), a 1.5 us load latency (fitted on a
#: first sweep of the kernel's 16 tiles at five shapes on the card, 0.5-3
#: us tried: shorter ones tie the two-stage tiles with their four-stage
#: twins, longer ones rank the sweep worse) and the kernel's launch groups
#: of 8 tile rows
H100_TC_TILES = TileChip(peak_flops=_H100.peak_flops, hbm_bw=_H100.hbm_bw,
                         smem_bytes=232448, stages=2, acc_in_smem=False,
                         align=(64, 64, 64), reg_budget=128,
                         tensor_core=True, sms=132, reg_overhead=40,
                         smem_bw=128 * _H100.peak_flops / (132 * 4096),
                         load_latency_s=1.5e-6, group_m=8)


@dataclasses.dataclass(frozen=True)
class TileConfig:
    bm: int
    bk: int
    bn: int


def _blocks_per_sm(t: TileConfig, smem: int, chip: TileChip) -> int:
    """Blocks an SM runs at once: the fewest that its shared memory, its
    registers and its threads admit (at least one)."""
    if chip.tensor_core:
        cons, wm, wn = tc_consumers(t.bm, t.bn)
        threads = 128 * (cons + 1)
        regs = wm * wn // 128 + chip.reg_overhead
    else:
        threads = block_threads(t, chip)
        regs = chip.thread_tile + chip.reg_overhead
    by_smem = SMEM_PER_SM // (smem + 1024)
    by_regs = REGS_PER_SM // (threads * min(regs, 255))
    return max(1, min(by_smem, by_regs, THREADS_PER_SM // threads))


def _k_tile_s(t: TileConfig, stages: int, dtype_bytes: int,
              chip: TileChip) -> float:
    """One block's time for one K tile: its tensor-core (or FMA) time at
    an SM's share of the peak, or longer where the shared-memory operand
    traffic or the load latency over the stages in flight takes longer."""
    s = 2.0 * t.bm * t.bk * t.bn / (chip.peak_flops / chip.sms)
    if chip.smem_bw:
        cons, wm, wn = tc_consumers(t.bm, t.bn)
        writes = (t.bm + t.bn) * t.bk * dtype_bytes          # TMA fills
        reads = cons * (wm // 64) * (64 + wn) * t.bk * dtype_bytes
        s = max(s, (writes + reads) / chip.smem_bw)
    if chip.load_latency_s:
        s = max(s, chip.load_latency_s / (stages - 1))
    return s


def tile_cost(M: int, K: int, N: int, t: TileConfig, *,
              dtype_bytes: int = 2,
              chip: TileChip = H100_TILES) -> Dict[str, float]:
    """Latency model for one (M,K,N) matmul at tile t; seconds."""
    gm = -(-M // t.bm)
    gk = -(-K // t.bk)
    gn = -(-N // t.bn)

    # fast memory: the input tiles' stages (+ the accumulator on the TPU)
    stages = chip.stages
    if chip.tensor_core:
        stages = tc_stages(t.bm, t.bk, t.bn, dtype_bytes=dtype_bytes,
                           smem_bytes=chip.smem_bytes)
    elif chip.thread_tile:
        # a ring of at least two: where two do not fit, the tile is over
        stages = max(2, cc_stages(t.bm, t.bk, t.bn, dtype_bytes=dtype_bytes,
                                  smem_bytes=chip.smem_bytes,
                                  max_stages=chip.stages))
    smem = stages * (t.bm * t.bk + t.bk * t.bn) * dtype_bytes
    if chip.acc_in_smem:
        smem += t.bm * t.bn * 4
    am, ak, an = chip.align
    valid = smem <= chip.smem_bytes and t.bm % am == 0 and \
        t.bk % ak == 0 and t.bn % an == 0
    if chip.tensor_core:
        # at least two stages; registers: a consumer thread's share of its
        # fp32 accumulator
        _, wm, wn = tc_consumers(t.bm, t.bn)
        valid = valid and stages >= 2 and wm * wn / 128 <= chip.reg_budget
    elif chip.thread_tile:
        # registers: a thread's accumulators and the rest, within the
        # budget, and the block's on one SM
        regs = chip.thread_tile + chip.reg_overhead
        valid = valid and regs <= chip.reg_budget and \
            block_threads(t, chip) * regs <= REGS_PER_SM

    # compute: every tile triple runs bm*bk*bn MACs
    flops = 2.0 * gm * gn * gk * t.bm * t.bk * t.bn
    compute_s = flops / chip.peak_flops
    if chip.sms:
        # waves of blocks over the SMs, each block at its SM's share
        per_sm = _blocks_per_sm(t, smem, chip)
        waves = -(-(gm * gn) // (chip.sms * per_sm))
        compute_s = waves * per_sm * gk * _k_tile_s(t, max(stages, 2),
                                                    dtype_bytes, chip)
        if chip.occupancy:
            compute_s /= issue_share(per_sm * block_threads(t, chip) // 32,
                                     chip)
            compute_s += waves * per_sm * gk * chip.k_tile_s

    # memory: with K innermost and output-stationary accumulation,
    # x tiles stream once per (i, j) pass -> refetched gn times total;
    # y tiles refetched gm times; output written once.  Launched in
    # groups of group_m tile rows, x is read once and y once per group.
    bytes_x = gm * gk * t.bm * t.bk * dtype_bytes * gn
    bytes_y = gk * gn * t.bk * t.bn * dtype_bytes * gm
    bytes_o = gm * gn * t.bm * t.bn * dtype_bytes
    if chip.group_m:
        bytes_x = M * K * dtype_bytes
        bytes_y = K * N * dtype_bytes * -(-gm // chip.group_m)
        bytes_o = M * N * dtype_bytes
    memory_s = (bytes_x + bytes_y + bytes_o) / chip.hbm_bw

    return {"valid": valid, "compute_s": compute_s, "memory_s": memory_s,
            "latency_s": max(compute_s, memory_s), "smem_bytes": smem,
            "hbm_bytes": bytes_x + bytes_y + bytes_o}


def tune_matmul_tiles(M: int, K: int, N: int, *, dtype_bytes: int = 2,
                      chip: Optional[TileChip] = None,
                      tiles: Optional[Iterable[Tuple[int, int, int]]] = None,
                      ) -> Tuple[TileConfig, Dict[str, float],
                                 List[Tuple[TileConfig, float]]]:
    """Exhaustive sweep of `tiles` (the space is enumerable; equivalent to
    Algorithm 1 with k = |variables|).  Returns (best tile, its cost, full
    ranking).  Ties keep the order of `tiles`: the first of equal
    latency wins.  By default the kernel of the dtype: bf16
    (`dtype_bytes=2`) on the tensor-core chip and its tiles, fp32 (4) on
    the CUDA-core chip and its tiles."""
    kernel = TENSOR_CORE if dtype_bytes == 2 else CUDA_CORE
    if chip is None:
        chip = H100_TC_TILES if kernel is TENSOR_CORE else H100_TILES
    if tiles is None:
        tiles = kernel.tiles
    ranking: List[Tuple[TileConfig, float]] = []
    best: Optional[TileConfig] = None
    best_cost: Optional[Dict[str, float]] = None
    for bm, bk, bn in tiles:
        t = TileConfig(bm, bk, bn)
        c = tile_cost(M, K, N, t, dtype_bytes=dtype_bytes, chip=chip)
        if not c["valid"]:
            continue
        ranking.append((t, c["latency_s"]))
        if best_cost is None or c["latency_s"] < best_cost["latency_s"]:
            best, best_cost = t, c
    ranking.sort(key=lambda x: x[1])
    assert best is not None, "no valid tile under the chip's constraints"
    return best, best_cost, ranking
