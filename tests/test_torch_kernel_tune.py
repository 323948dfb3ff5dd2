"""`repro_torch.core.kernel_tune` on the CPU: with the reference's
constants passed in, the port's tile model returns the reference's tile,
cost and ranking exactly; with its Hopper default, every pick is a tile
the CUDA kernel is built for and fits the kernel's shared memory and
register budgets (a property test, like tests/test_property.py).  Exact
equality throughout: the same arithmetic in the same order."""

import itertools

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                       # pragma: no cover - container
    from _hypothesis_fallback import given, settings, strategies as st

from repro.core import kernel_tune as ref_kt
from repro.core.roofline import HW as RefHW
from repro_torch.core.kernel_tune import (H100_TILES, TileChip, TileConfig,
                                          tile_cost, tune_matmul_tiles)
from repro_torch.core.roofline import HW
from repro_torch.kernels.matmul import MATMUL_TILES

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
    for tile in MATMUL_TILES:
        for dtype_bytes in (2, 4):
            assert tile_cost(4096, 4096, 4096, TileConfig(*tile),
                             dtype_bytes=dtype_bytes,
                             chip=H100_TILES)["valid"], tile


def test_h100_chip_is_the_datasheet_fp32_fma_rate():
    assert H100_TILES.peak_flops == HW().fp32_flops == 67e12
    assert H100_TILES.hbm_bw == HW().hbm_bw == 3.35e12
    assert H100_TILES.smem_bytes == 232448 and not H100_TILES.acc_in_smem


def test_tiles_the_budgets_rule_out():
    """Over the shared memory a block may use, or over the registers of
    its threads, a tile is invalid."""
    big = tile_cost(4096, 4096, 4096, TileConfig(128, 512, 128),
                    dtype_bytes=4)
    assert big["smem_bytes"] > H100_TILES.smem_bytes and not big["valid"]
    regs = tile_cost(4096, 4096, 4096, TileConfig(256, 16, 256))
    assert regs["smem_bytes"] <= H100_TILES.smem_bytes
    assert not regs["valid"]                 # 256 accumulators a thread


def test_ties_keep_the_order_of_the_tiles():
    """On a compute-bound shape with no padding all kernel tiles tie; the
    first of `tiles` is picked and the ranking keeps their order."""
    best, _, rank = tune_matmul_tiles(4096, 4096, 4096)
    assert len({lat for _, lat in rank}) == 1
    assert (best.bm, best.bk, best.bn) == MATMUL_TILES[0]
    assert [(t.bm, t.bk, t.bn) for t, _ in rank] == list(MATMUL_TILES)
    rev = tuple(reversed(MATMUL_TILES))
    best, _, _ = tune_matmul_tiles(4096, 4096, 4096, tiles=rev)
    assert (best.bm, best.bk, best.bn) == rev[0]


def test_padding_moves_the_pick():
    """A ragged M of 130 pads 128-row tiles to 256 rows and 64-row ones to
    192: the model picks bm = 64."""
    best, cost, _ = tune_matmul_tiles(130, 4096, 4096)
    assert best.bm == 64
    assert cost["compute_s"] == pytest.approx(
        2 * 192 * 4096 * 4096 / H100_TILES.peak_flops)


@settings(max_examples=30, deadline=None)
@given(m=st.integers(1, 40000), k=st.integers(1, 20000),
       n=st.integers(1, 160000), dtype_bytes=st.sampled_from([2, 4]))
def test_h100_pick_is_a_kernel_tile_within_budgets(m, k, n, dtype_bytes):
    best, cost, ranking = tune_matmul_tiles(m, k, n,
                                            dtype_bytes=dtype_bytes)
    assert (best.bm, best.bk, best.bn) in MATMUL_TILES
    assert cost["valid"]
    assert cost["smem_bytes"] <= H100_TILES.smem_bytes
    regs = (best.bm * best.bn + best.bm * best.bk + best.bk * best.bn) \
        / H100_TILES.threads
    assert regs <= H100_TILES.reg_budget <= 255
    assert cost["latency_s"] == min(lat for _, lat in ranking) > 0
    # the compute term never beats the fp32 FMA roofline of the product
    assert cost["compute_s"] >= 2.0 * m * k * n / HW().fp32_flops
