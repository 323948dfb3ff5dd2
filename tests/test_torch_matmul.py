"""`repro_torch.kernels.matmul` on the CPU: its plain version against the
JAX package's oracle (`ref.matmul_ref`) and Pallas kernel (interpret
mode), and the wrapper's contract, including that its tile set is the
one `csrc/matmul.cu` is built for.

Inputs come from numpy with a seed.  Tolerance: |port - reference| <=
2 gamma_K (|x| @ |y|), gamma_K = K u / (1 - K u) with u = 2^-24 — the
bound of two fp32 sums of the same K products in two orders — plus one
bf16 ulp of the larger magnitude where both sides round to bf16."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels.matmul import MATMUL_TILES, matmul, matmul_plain

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


def test_tile_set_is_the_kernels_instantiations():
    built = {tuple(int(v) for v in m) for m in re.findall(
        r"^\s*MATMUL_TILE\((\d+), (\d+), (\d+)\)", CSRC.read_text(),
        re.MULTILINE)}
    assert built == set(MATMUL_TILES)
    assert len(MATMUL_TILES) == len(set(MATMUL_TILES))
    # the two tiles of tests/test_kernels.py are among them
    assert set(TILES) <= built
