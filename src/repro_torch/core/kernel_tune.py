"""Kernel-tile DSE: the paper's loop-tiling optimization applied to the
tiles of the matmul kernel (`kernels/matmul.py`).

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
a block's shared memory, and the accumulator plus the staged next tiles in
the registers of the block's threads.  The tuner sweeps the tiles the CUDA
kernel is built for (`kernels.matmul.MATMUL_TILES`), so every tile it picks
can be launched.

The model has no L2 cache (50 MB on the H100): the refetches it counts
partly hit L2 on the card, so its traffic overstates HBM bytes.

On the H100 the model does not rank the kernel's tiles: at the fp32-FMA
peak the compute term dominates every product large enough to matter, no
tile pads a dimension that is a multiple of 128, and shared memory and
registers admit all of `MATMUL_TILES`.  Every tile then ties, and the pick
is the first of `MATMUL_TILES`: the order of that tuple, not the model, is
the policy.  A term for occupancy (blocks per SM from registers and shared
memory, and how many SMs the grid fills) is what would let the model tell
the tiles apart (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.roofline import HW
from repro_torch.kernels.matmul import MATMUL_TILES

__all__ = ["TileChip", "H100_TILES", "TileConfig", "tile_cost",
           "tune_matmul_tiles"]


@dataclasses.dataclass(frozen=True)
class TileChip:
    """What the tile model needs to know of a chip and the kernel on it."""

    peak_flops: float          # of the datapath the kernel multiplies on
    hbm_bw: float              # bytes/s
    smem_bytes: int            # fast memory one block may use
    stages: int                # buffers of each input tile
    acc_in_smem: bool          # fp32 accumulator in that memory (TPU VMEM)
    align: Tuple[int, int, int]   # bm, bk, bn must be multiples of these
    threads: int = 0           # threads a block; 0: no register budget
    reg_budget: int = 0        # 32-bit registers a thread may spend on
                               # the accumulator and the staged tiles


_H100 = HW()
#: the H100 and `csrc/matmul.cu`: fp32 FMAs on the CUDA cores, at most
#: 232,448 bytes of shared memory a block (opt-in above 48 KB), two stages
#: of input tiles, 256 threads, and half of the 255 registers a thread may
#: hold for its accumulator and its staged share of the next tiles (the
#: other half holds fragments, addresses and loop state)
H100_TILES = TileChip(peak_flops=_H100.fp32_flops, hbm_bw=_H100.hbm_bw,
                      smem_bytes=232448, stages=2, acc_in_smem=False,
                      align=(64, 16, 64), threads=256, reg_budget=128)


@dataclasses.dataclass(frozen=True)
class TileConfig:
    bm: int
    bk: int
    bn: int


def tile_cost(M: int, K: int, N: int, t: TileConfig, *,
              dtype_bytes: int = 2,
              chip: TileChip = H100_TILES) -> Dict[str, float]:
    """Latency model for one (M,K,N) matmul at tile t; seconds."""
    gm = -(-M // t.bm)
    gk = -(-K // t.bk)
    gn = -(-N // t.bn)

    # fast memory: the input tiles' stages (+ the accumulator on the TPU)
    smem = chip.stages * (t.bm * t.bk + t.bk * t.bn) * dtype_bytes
    if chip.acc_in_smem:
        smem += t.bm * t.bn * 4
    am, ak, an = chip.align
    valid = smem <= chip.smem_bytes and t.bm % am == 0 and \
        t.bk % ak == 0 and t.bn % an == 0
    if chip.threads:
        # registers: the fp32 accumulator and the staged next input tiles
        regs = (t.bm * t.bn + t.bm * t.bk + t.bk * t.bn) / chip.threads
        valid = valid and regs <= chip.reg_budget

    # compute: every tile triple runs bm*bk*bn MACs
    flops = 2.0 * gm * gn * gk * t.bm * t.bk * t.bn
    compute_s = flops / chip.peak_flops

    # memory: with K innermost and output-stationary accumulation,
    # x tiles stream once per (i, j) pass -> refetched gn times total;
    # y tiles refetched gm times; output written once.
    bytes_x = gm * gk * t.bm * t.bk * dtype_bytes * gn
    bytes_y = gk * gn * t.bk * t.bn * dtype_bytes * gm
    bytes_o = gm * gn * t.bm * t.bn * dtype_bytes
    memory_s = (bytes_x + bytes_y + bytes_o) / chip.hbm_bw

    return {"valid": valid, "compute_s": compute_s, "memory_s": memory_s,
            "latency_s": max(compute_s, memory_s), "smem_bytes": smem,
            "hbm_bytes": bytes_x + bytes_y + bytes_o}


def tune_matmul_tiles(M: int, K: int, N: int, *, dtype_bytes: int = 2,
                      chip: TileChip = H100_TILES,
                      tiles: Iterable[Tuple[int, int, int]] = MATMUL_TILES,
                      ) -> Tuple[TileConfig, Dict[str, float],
                                 List[Tuple[TileConfig, float]]]:
    """Exhaustive sweep of `tiles` (the space is enumerable; equivalent to
    Algorithm 1 with k = |variables|).  Returns (best tile, its cost, full
    ranking).  Ties keep the order of `tiles`: the first of equal
    latency wins."""
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
