"""`repro_torch.core.kernel_tune` on the CPU: with the reference's
constants passed in, the port's tile model returns the reference's tile,
cost and ranking exactly; with its Hopper defaults (the tensor-core chip
for bf16, the CUDA-core chip for fp32), every pick is a tile the dtype's
CUDA kernel is built for and fits the kernel's shared memory and register
budgets (a property test, like tests/test_property.py), and the GPU terms
rank the tiles.  Exact equality throughout: the same arithmetic in the
same order."""

import itertools

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                       # pragma: no cover - container
    from _hypothesis_fallback import given, settings, strategies as st

from repro.core import kernel_tune as ref_kt
from repro.core.roofline import HW as RefHW
from repro_torch.core.kernel_tune import (H100_TC_TILES, H100_TILES,
                                          REGS_PER_SM, TileChip, TileConfig,
                                          block_threads, cc_stages,
                                          tc_consumers, tc_stages, tile_cost,
                                          tune_matmul_tiles)
from repro_torch.core.roofline import HW
from repro_torch.kernels.matmul import CUDA_CORE, TENSOR_CORE

#: the reference's chip: v5e VMEM, the MXU's alignment, the accumulator
#: beside the double-buffered inputs, no register budget
REF_CHIP = TileChip(peak_flops=RefHW().peak_flops, hbm_bw=RefHW().hbm_bw,
                    smem_bytes=ref_kt.VMEM_BYTES, stages=2,
                    acc_in_smem=True,
                    align=(8, ref_kt.MXU_DIM, ref_kt.MXU_DIM))
#: the reference's default domains, in its order of enumeration
REF_TILES = list(itertools.product((128, 256, 512, 1024),
                                   (128, 256, 512, 1024, 2048),
                                   (128, 256, 512, 1024)))
GRID = [(4096, 4096, 4096), (8, 4096, 4096), (8192, 8192, 8192),
        (33, 65, 17), (1000, 3000, 700), (128, 8192, 256),
        (32768, 896, 151936), (4096, 14336, 4096)]


def _ref_cost_as_port(c):
    c = dict(c)
    c["smem_bytes"] = c.pop("vmem_bytes")
    return c


@pytest.mark.parametrize("dtype_bytes", [2, 4])
@pytest.mark.parametrize("m,k,n", GRID)
def test_reference_constants_give_the_reference_ranking(m, k, n,
                                                        dtype_bytes):
    want_best, want_cost, want_rank = ref_kt.tune_matmul_tiles(
        m, k, n, dtype_bytes=dtype_bytes)
    best, cost, rank = tune_matmul_tiles(m, k, n, dtype_bytes=dtype_bytes,
                                         chip=REF_CHIP, tiles=REF_TILES)
    assert (best.bm, best.bk, best.bn) == (want_best.bm, want_best.bk,
                                           want_best.bn)
    assert cost == _ref_cost_as_port(want_cost)
    assert [((t.bm, t.bk, t.bn), lat) for t, lat in rank] == \
        [((t.bm, t.bk, t.bn), lat) for t, lat in want_rank]


@pytest.mark.parametrize("tile", [(128, 128, 128), (8, 128, 128),
                                  (1024, 2048, 1024), (100, 128, 128),
                                  (256, 100, 128)])
def test_reference_constants_give_the_reference_cost(tile):
    t = TileConfig(*tile)
    want = ref_kt.tile_cost(1000, 3000, 700, ref_kt.TileConfig(*tile))
    assert tile_cost(1000, 3000, 700, t, chip=REF_CHIP) == \
        _ref_cost_as_port(want)


def test_every_kernel_tile_is_a_candidate_on_the_h100():
    for tile in CUDA_CORE.tiles:
        for dtype_bytes in (2, 4):
            assert tile_cost(4096, 4096, 4096, TileConfig(*tile),
                             dtype_bytes=dtype_bytes,
                             chip=H100_TILES)["valid"], tile
    for tile in TENSOR_CORE.tiles:
        assert tile_cost(4096, 4096, 4096, TileConfig(*tile),
                         chip=H100_TC_TILES)["valid"], tile


def test_h100_chip_is_the_datasheet_fp32_fma_rate():
    """The CUDA-core chip multiplies at the fp32 FMA rate, the tensor-core
    chip at the bf16 tensor-core peak; both read HBM at 3.35 TB/s and
    spread blocks over 132 SMs."""
    assert H100_TILES.peak_flops == HW().fp32_flops == 67e12
    assert H100_TC_TILES.peak_flops == HW().peak_flops == 989e12
    for chip in (H100_TILES, H100_TC_TILES):
        assert chip.hbm_bw == HW().hbm_bw == 3.35e12
        assert chip.smem_bytes == 232448 and not chip.acc_in_smem
        assert chip.sms == 132


def test_tiles_the_budgets_rule_out():
    """Over the shared memory a block may use, or over the registers of
    its threads, a tile is invalid."""
    big = tile_cost(4096, 4096, 4096, TileConfig(128, 512, 128),
                    dtype_bytes=4)
    assert big["smem_bytes"] > H100_TILES.smem_bytes and not big["valid"]
    regs = tile_cost(4096, 4096, 4096, TileConfig(256, 16, 256))
    assert regs["smem_bytes"] <= H100_TILES.smem_bytes
    # 1024 threads of 64 accumulators and the rest: over an SM's registers
    assert block_threads(TileConfig(256, 16, 256), H100_TILES) == 1024
    assert not regs["valid"]


def test_ties_keep_the_order_of_the_tiles():
    """The fp32 chip still ties tiles that fill the same waves with the same
    work: at 4096^3 a bm x bn tile and its bn x bm twin at one bk have the
    same blocks, threads, shared memory, K tiles and refetched bytes.  The
    ranking keeps their order in `tiles`, and the first of them is picked,
    whichever way the tuple runs."""
    tiles = ((128, 32, 64), (64, 32, 128), (128, 16, 64), (64, 16, 128))
    best, _, rank = tune_matmul_tiles(4096, 4096, 4096, dtype_bytes=4,
                                      tiles=tiles)
    top = [(t.bm, t.bk, t.bn) for t, lat in rank if lat == rank[0][1]]
    assert len(top) > 1
    assert top == [t for t in tiles if t in top]
    assert (best.bm, best.bk, best.bn) == tiles[0] == top[0]
    rev = tuple(reversed(tiles))
    best, _, rank = tune_matmul_tiles(4096, 4096, 4096, dtype_bytes=4,
                                      tiles=rev)
    assert (best.bm, best.bk, best.bn) == [t for t in rev if t in top][0]


def test_padding_moves_the_pick():
    """A ragged M of 130 pads 128- and 256-row tiles to 256 rows and
    64-row ones to 192: the tensor-core model picks bm = 64, and its
    compute term covers the padded rows at the tensor-core peak."""
    best, cost, _ = tune_matmul_tiles(130, 4096, 4096)
    assert best.bm == 64
    assert cost["compute_s"] >= 2 * 192 * 4096 * 4096 / 989e12


def test_8192_cubed_no_longer_ties():
    """bf16 8192^3: the operand, latency and wave terms set the tiles
    apart, and the pick is the widest tile with four stages, 128 x 256 x
    64 (the fastest of the kernel's tiles on the card, PERF.md)."""
    best, cost, rank = tune_matmul_tiles(8192, 8192, 8192)
    lats = [lat for _, lat in rank]
    assert len(set(lats)) > len(lats) // 2 and lats[0] < lats[1]
    assert (best.bm, best.bk, best.bn) == (128, 64, 256)
    assert tc_stages(128, 64, 256) == 4 and cost["compute_s"] > \
        cost["memory_s"]
    # two-stage tiles wait on their loads: the same tile at bk 128 is slower
    deep = tile_cost(8192, 8192, 8192, TileConfig(128, 128, 256),
                     chip=H100_TC_TILES)
    assert tc_stages(128, 128, 256) == 2
    assert deep["latency_s"] > cost["latency_s"]


def test_decode_like_shape_is_bound_by_its_bytes():
    """(128, 4096, 12288): the pick's time is its memory term (y read
    once), and no 256-row tile, which pads M = 128 to 256 and multiplies
    zeros, is picked."""
    best, cost, rank = tune_matmul_tiles(128, 4096, 12288)
    assert cost["latency_s"] == cost["memory_s"] >= cost["compute_s"]
    assert cost["memory_s"] == pytest.approx(
        2 * (128 * 4096 + 4096 * 12288 + 128 * 12288) / 3.35e12)
    assert best.bm <= 128
    assert all(lat > cost["latency_s"] for t, lat in rank if t.bm == 256)


def test_stage_formula_and_consumer_split():
    """The ring holds as many stages as fit beside the 2048-byte reserve,
    at least two for every bf16 tile; two consumer warpgroups split the
    rows from bm 128, else the columns from bn 128."""
    for bm, bk, bn in TENSOR_CORE.tiles:
        s = tc_stages(bm, bk, bn)
        assert s >= 2 and s * (bm + bn) * bk * 2 <= 232448 - 2048 < \
            (s + 1) * (bm + bn) * bk * 2
    assert tc_consumers(256, 128) == (2, 128, 128)
    assert tc_consumers(64, 256) == (2, 64, 128)
    assert tc_consumers(64, 64) == (1, 64, 64)


def test_every_cuda_core_tile_fits_a_blocks_shared_memory():
    """The fp32 kernel's ring: three stages where they fit, two for the
    bk = 128 tiles of bm + bn = 192, and every tile's ring within the
    232,448 bytes a block may use."""
    for bm, bk, bn in CUDA_CORE.tiles:
        s = cc_stages(bm, bk, bn)
        cost = tile_cost(4096, 4096, 4096, TileConfig(bm, bk, bn),
                         dtype_bytes=4)
        assert s == (2 if bk == 128 and bm + bn == 192 else 3)
        assert cost["smem_bytes"] == s * (bm + bn) * bk * 4 <= 232448
        assert cost["valid"]


#: the fp32 products the models' MLPs run at 32k positions (qwen2-0.5b's
#: up and down projections, recurrentgemma-9b's) and the tile DSE's fp32
#: product
FP32_SHAPES = [(8192, 8192, 8192), (32768, 896, 4864), (32768, 4864, 896),
               (32768, 4096, 12288), (32768, 12288, 4096)]


@pytest.mark.parametrize("m,k,n", FP32_SHAPES)
def test_fp32_pick_is_a_built_tile(m, k, n):
    """At 8192^3 and the models' MLP shapes the CUDA-core model picks a
    tile `matmul_kernel` is built for, within its budgets, compute-bound
    at the fp32 FMA rate."""
    best, cost, ranking = tune_matmul_tiles(m, k, n, dtype_bytes=4)
    assert (best.bm, best.bk, best.bn) in CUDA_CORE.tiles
    assert cost["valid"] and cost["smem_bytes"] <= 232448
    assert len(ranking) == len(CUDA_CORE.tiles)
    assert cost["latency_s"] == cost["compute_s"] >= 2.0 * m * k * n / 67e12


@settings(max_examples=30, deadline=None)
@given(m=st.integers(1, 40000), k=st.integers(1, 20000),
       n=st.integers(1, 160000), dtype_bytes=st.sampled_from([2, 4]))
def test_h100_pick_is_a_kernel_tile_within_budgets(m, k, n, dtype_bytes):
    best, cost, ranking = tune_matmul_tiles(m, k, n,
                                            dtype_bytes=dtype_bytes)
    kernel, chip = ((TENSOR_CORE, H100_TC_TILES) if dtype_bytes == 2
                    else (CUDA_CORE, H100_TILES))
    assert (best.bm, best.bk, best.bn) in kernel.tiles
    assert cost["valid"]
    assert cost["smem_bytes"] <= chip.smem_bytes
    if dtype_bytes == 4:
        regs = chip.thread_tile + chip.reg_overhead
        assert block_threads(best, chip) * regs <= REGS_PER_SM
    else:
        regs = best.bm * best.bn / (128 * tc_consumers(best.bm, best.bn)[0])
    assert regs <= chip.reg_budget <= 255
    assert cost["latency_s"] == min(lat for _, lat in ranking) > 0
    # the compute term never beats the roofline of the product on the
    # datapath the kernel multiplies on: the tensor cores for bf16, fp32
    # FMAs for fp32
    peak = HW().peak_flops if dtype_bytes == 2 else HW().fp32_flops
    assert cost["compute_s"] >= 2.0 * m * k * n / peak
