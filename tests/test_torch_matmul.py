"""`repro_torch.kernels.matmul` on the CPU: its plain version against the
JAX package's oracle (`ref.matmul_ref`) and Pallas kernel (interpret
mode), and the wrapper's contract: each kernel's tile set is the one
`csrc/matmul.cu` is built for, the dispatch by dtype, each kernel's stage
formula (and the CUDA-core kernel's threads and shared memory a tile) as
the tile model has them, and the zero padding that TMA's alignment
needs.

Inputs come from numpy with a seed.  Tolerance: |port - reference| <=
2 gamma_K (|x| @ |y|), gamma_K = K u / (1 - K u) with u = 2^-24 — the
bound of two fp32 sums of the same K products in two orders — plus one
bf16 ulp of the larger magnitude where both sides round to bf16."""

import re
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.core.kernel_tune import (H100_TILES, TileConfig,
                                          block_threads, cc_stages,
                                          tc_stages, tile_cost)
from repro_torch.kernels import build
from repro_torch.kernels.matmul import (CUDA_CORE, DISPATCH, TENSOR_CORE,
                                        kernel_for, matmul, matmul_plain,
                                        tma_operands)

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc" / "matmul.cu")
SHAPES = [(64, 64, 64), (200, 384, 136), (128, 1024, 96), (33, 65, 17)]
TILES = [(64, 128, 64), (128, 64, 128)]
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(m, k, n, dtype, seed=0):
    rng = np.random.default_rng(seed + 7 * m + 3 * k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    y = rng.standard_normal((k, n)).astype(np.float32)
    # both sides see the same values: round to bf16 once, in torch
    xt = torch.from_numpy(x).to(TORCH[dtype])
    yt = torch.from_numpy(y).to(TORCH[dtype])
    return xt, yt


def _assert_within_bound(x, y, got, want):
    """got, want: tensors in the output dtype."""
    k = x.shape[1]
    u = 2.0 ** -24
    rtol = 2 * k * u / (1 - k * u)
    g, w = got.float(), want.float()
    lim = rtol * (x.float().abs() @ y.float().abs())
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
        lim = lim + torch.ldexp(torch.ones_like(lim), e - 8)
    assert bool(((g - w).abs() <= lim).all()), \
        float(((g - w).abs() / lim.clamp_min(1e-38)).max())


def _to_jnp(t):
    return jnp.asarray(t.float().numpy(), JNP[str(t.dtype).split(".")[-1]])


def _from_jnp(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(TORCH[dtype])


@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_matches_oracle(m, k, n, dtype, tiles):
    """The sweep of tests/test_kernels.py, against `ref.matmul_ref`."""
    x, y = _inputs(m, k, n, dtype)
    got = matmul_plain(x, y, bk=tiles[1])
    want = _from_jnp(ref.matmul_ref(_to_jnp(x), _to_jnp(y)), dtype)
    assert got.dtype == TORCH[dtype] and got.shape == (m, n)
    _assert_within_bound(x, y, got, want)


# one case per shape, alternating dtype and tile: each compiles the
# Pallas kernel anew in interpret mode
@pytest.mark.parametrize("m,k,n,dtype,tiles", [
    (64, 64, 64, "float32", (64, 128, 64)),
    (200, 384, 136, "bfloat16", (128, 64, 128)),
    (128, 1024, 96, "float32", (128, 64, 128)),
    (33, 65, 17, "bfloat16", (64, 128, 64)),
])
def test_plain_matches_pallas_kernel(m, k, n, dtype, tiles):
    x, y = _inputs(m, k, n, dtype, seed=1)
    bm, bk, bn = tiles
    want = _from_jnp(ops.matmul(_to_jnp(x), _to_jnp(y), bm=bm, bk=bk,
                                bn=bn, interpret=True), dtype)
    _assert_within_bound(x, y, matmul_plain(x, y, bk=bk), want)


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    x, y = _inputs(70, 90, 50, "float32")
    before = matmul.launches
    got = matmul(x, y, bm=64, bk=16, bn=64, out_dtype=torch.bfloat16)
    assert matmul.launches == before
    assert torch.equal(got, matmul_plain(x, y, bk=16,
                                         out_dtype=torch.bfloat16))


def test_plain_adds_k_tiles_in_order():
    """bk >= K is one tile; the sum over K tiles is the sum of the tiles'
    products, accumulated left to right in fp32."""
    x, y = _inputs(20, 50, 30, "float32", seed=2)
    assert torch.equal(matmul_plain(x, y, bk=64), (x @ y))
    acc = torch.zeros((20, 30))
    for k0 in range(0, 50, 16):
        acc += x[:, k0:k0 + 16] @ y[k0:k0 + 16]
    assert torch.equal(matmul_plain(x, y, bk=16), acc)


@pytest.mark.parametrize("tile", [(32, 32, 32), (256, 64, 256),
                                  (64, 8, 64), (128, 128, 128)])
def test_tile_without_an_instantiation_raises_on_every_device(tile):
    x, y = _inputs(8, 8, 8, "float32")
    with pytest.raises(ValueError, match="no kernel for tile"):
        matmul(x, y, bm=tile[0], bk=tile[1], bn=tile[2])


def _instantiations(macro):
    return [tuple(int(v) for v in m) for m in re.findall(
        rf"^\s*{macro}\((\d+), (\d+), (\d+)\)", CSRC.read_text(),
        re.MULTILINE)]


def test_tile_set_is_the_kernels_instantiations():
    """Each kernel's tiles are its instantiation lines in the source, and
    both keep the two tiles of tests/test_kernels.py."""
    for kernel, macro in ((CUDA_CORE, "MATMUL_TILE"),
                          (TENSOR_CORE, "MATMUL_TC_TILE")):
        built = _instantiations(macro)
        assert set(built) == set(kernel.tiles), kernel.name
        assert len(set(built)) == len(built) == len(kernel.tiles)
        assert set(TILES) <= set(built)
    assert len(CUDA_CORE.tiles) == 15 and len(TENSOR_CORE.tiles) == 16


def test_dispatch_sends_bf16_to_the_tensor_cores():
    assert DISPATCH == {torch.bfloat16: TENSOR_CORE,
                        torch.float32: CUDA_CORE}
    assert kernel_for(torch.bfloat16) is TENSOR_CORE
    assert kernel_for(torch.float32) is CUDA_CORE
    with pytest.raises(TypeError):
        kernel_for(torch.float16)
    # the tensor-core tiles: bm, bn in {64, 128, 256} but 256 x 256, bk
    # in {64, 128}
    assert set(TENSOR_CORE.tiles) == {
        (bm, bk, bn) for bm in (64, 128, 256) for bn in (64, 128, 256)
        for bk in (64, 128) if (bm, bn) != (256, 256)}


def test_stage_formula_matches_the_kernel():
    """The ring's stages: the .cu's constants are the tile model's, and
    every bf16 tile gets at least two stages."""
    text = CSRC.read_text()
    limit = int(re.search(r"kSmemLimit = (\d+);", text).group(1))
    reserve = int(re.search(r"kSmemReserve = (\d+);", text).group(1))
    assert "return (kSmemLimit - kSmemReserve) / ((bm + bn) * bk * 2);" \
        in text
    for bm, bk, bn in TENSOR_CORE.tiles:
        s = tc_stages(bm, bk, bn)
        assert s == (limit - reserve) // ((bm + bn) * bk * 2) >= 2


def test_cuda_core_ring_matches_the_kernel():
    """The CUDA-core tile model's constants are `matmul_kernel`'s: the
    ring's stage formula and depth, the threads a tile (8 x 8 outputs
    each), the registers the launch bound leaves a thread, and so each
    tile's shared memory."""
    text = CSRC.read_text()
    limit = int(re.search(r"kSmemLimit = (\d+);", text).group(1))
    depth = int(re.search(r"kMaxStages = (\d+);", text).group(1))
    per_thread = int(re.search(r"kThreadTile = (\d+);", text).group(1))
    assert "return min_int(kMaxStages, kSmemLimit / ((bm + bn) * bk * 4));" \
        in text
    assert "kThreads = BM * BN / kThreadTile;" in text
    # the launch bound names the threads alone: no register cap under 255
    assert "__launch_bounds__(CcCfg<BM, BK, BN>::kThreads)\n" in text
    assert (H100_TILES.smem_bytes, H100_TILES.stages,
            H100_TILES.thread_tile, H100_TILES.reg_budget) == \
        (limit, depth, per_thread, 255)
    for bm, bk, bn in CUDA_CORE.tiles:
        stages = min(depth, limit // ((bm + bn) * bk * 4))
        t = TileConfig(bm, bk, bn)
        assert cc_stages(bm, bk, bn) == stages >= 2
        assert block_threads(t, H100_TILES) == bm * bn // per_thread
        assert tile_cost(8192, 8192, 8192, t, dtype_bytes=4,
                         chip=H100_TILES)["smem_bytes"] == \
            stages * (bm * bk + bk * bn) * 4 <= limit


@pytest.mark.parametrize("m,k,n", [(33, 65, 17), (200, 384, 136)])
def test_tma_padding_keeps_the_product_bit_for_bit(m, k, n):
    """K (and y's N) zero-padded to a multiple of 8, or the operands copied
    to an aligned start: the plain version of the padded operands, cut to
    N columns, equals the plain version of the originals bit for bit."""
    x, y = _inputs(m, k, n, "bfloat16", seed=3)
    # an unaligned start (one bf16 element past an aligned one)
    xs = torch.empty(m * k + 1, dtype=torch.bfloat16)[1:].view(m, k)
    xs.copy_(x)
    assert xs.data_ptr() % 16
    xp, yp = tma_operands(xs, y)
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    assert xp.shape == (m, kp) and yp.shape == (kp, np_)
    assert xp.data_ptr() % 16 == 0 and yp.data_ptr() % 16 == 0
    assert torch.equal(xp[:, k:], torch.zeros_like(xp[:, k:]))
    assert torch.equal(yp[k:], torch.zeros_like(yp[k:]))
    assert torch.equal(yp[:, n:], torch.zeros_like(yp[:, n:]))
    for bk in (64, 128):
        for od in (torch.float32, torch.bfloat16):
            want = matmul_plain(x, y, bk=bk, out_dtype=od)
            got = matmul_plain(xp, yp, bk=bk, out_dtype=od)[:, :n]
            assert torch.equal(got, want)
    # aligned and a multiple of 8 already: no copy
    xa, ya = tma_operands(y.new_zeros((4, 64)), y.new_zeros((64, 24)))
    assert xa.shape == (4, 64) and ya.shape == (64, 24)


@pytest.mark.parametrize("tile", [(128, 128, 128), (256, 64, 64)])
def test_fp32_at_a_bf16_only_tile_raises(tile):
    """A tile the tensor-core kernel has and the CUDA-core one lacks: bf16
    runs it, fp32 raises, on every device."""
    assert tile in TENSOR_CORE.tiles and tile not in CUDA_CORE.tiles
    x, y = _inputs(8, 8, 8, "float32")
    with pytest.raises(ValueError, match="no kernel for tile"):
        matmul(x, y, bm=tile[0], bk=tile[1], bn=tile[2])
    got = matmul(x.bfloat16(), y.bfloat16(), bm=tile[0], bk=tile[1],
                 bn=tile[2])
    assert torch.equal(got, matmul_plain(x.bfloat16(), y.bfloat16(),
                                         bk=tile[1]))


def test_an_edited_header_rebuilds_both_libraries(tmp_path, monkeypatch):
    """The library names hash each source with the `csrc/*.cuh` it
    includes: an edit to `hopper.cuh` renames the flash, matmul and
    rglru_scan libraries (all three include it) and no other."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    assert build.headers("matmul") == build.headers("flash_attention") == \
        build.headers("rglru_scan") == ("hopper.cuh",)
    assert build.headers("gather_rows") == ()
    before = {n: build.library_path(n) for n in build.SOURCES}
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: build.library_path(n) for n in build.SOURCES}
    changed = {n for n in build.SOURCES if before[n] != after[n]}
    assert changed == {"matmul", "flash_attention", "rglru_scan"}
