"""Tests of the port that need an NVIDIA GPU (marker `cuda`).

They skip where `torch.cuda.is_available()` is False.  On a machine with a
GPU and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.multiapp import AppSpec
from repro_torch.core.space import default_space
from repro_torch.kernels.costmodel import FusedTorchScorer
from repro_torch.kernels.flash_attention import (CUDA_CORE, TENSOR_CORE,
                                                 flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.gather import gather_rows, gather_rows_plain
from repro_torch.kernels.matmul import (CUDA_CORE as MM_CUDA_CORE,
                                        TENSOR_CORE as MM_TENSOR_CORE,
                                        kernel_for as mm_kernel_for, matmul,
                                        matmul_plain)
from repro_torch.kernels import rg_lru
from repro_torch.kernels.rg_lru import rglru_scan, rglru_scan_plain
from repro_torch.models import layers as TL
from repro_torch.models.layers import full_precision_products

pytestmark = pytest.mark.cuda

_SMOKE = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64])
@pytest.mark.parametrize("u,o,c", [(280, 2, 1), (900, 21, 4097),
                                   (2304, 44, 65536)])
def test_kernel_bit_equal_to_plain(gpu, dtype, u, o, c):
    rng = np.random.default_rng(u + c)
    table = torch.from_numpy(rng.integers(-2**40, 2**40, size=(u, o))
                             if dtype == torch.int64
                             else rng.standard_normal((u, o))).to(gpu)
    idx = torch.from_numpy(rng.integers(-3, u + 3, size=c)).to(gpu)
    before = gather_rows.launches
    got = gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(got, gather_rows_plain(table, idx))


def test_kernel_refuses_what_it_does_not_take(gpu):
    table = torch.zeros((8, 4), dtype=torch.int64, device=gpu)
    idx = torch.zeros(3, dtype=torch.int64, device=gpu)
    with pytest.raises(TypeError):
        gather_rows(table.float(), idx)
    with pytest.raises(TypeError):
        gather_rows(table, idx.int())
    with pytest.raises(ValueError):
        gather_rows(table.t(), idx)
    with pytest.raises(ValueError):
        gather_rows(table, idx.cpu())


@pytest.mark.parametrize("app", ["resnet", "nasnet"])
def test_scorer_on_the_card_equals_the_cpu(gpu, app):
    spec = AppSpec.from_app(app)
    space = default_space()
    rng = np.random.default_rng(0)
    matrix = space.repair_for_peaks_many(
        space.decode_batch(space.sample_indices(rng, 4096)),
        spec.peak_weight_bits,
        spec.peak_input_bits * int(spec.stream.batch.max())).matrix
    out = {}
    for dev in ("cpu", gpu):
        scorer = FusedTorchScorer(spec.stream, space.hw,
                                  spec.peak_weight_bits, spec.peak_input_bits,
                                  domains=space.domains, device=dev)
        out[str(dev)] = scorer.metrics(matrix)
    (g_cpu, a_cpu), (g_gpu, a_gpu) = out["cpu"], out["cuda"]
    assert (g_cpu > 0).any()
    np.testing.assert_array_equal(g_gpu, g_cpu)
    np.testing.assert_array_equal(a_gpu, a_cpu)


# flash_attention: the sweep of tests/test_kernels.py plus causal Sq != Skv,
# qwen2-0.5b's heads and head dim 128; fp32 to 3e-4, bf16 to 2e-2 (both
# round the output to bf16); bf16 at head dims 64, 128 and 256 runs the
# tensor-core kernel, the rest the CUDA-core one
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,skv,h,kv,hd", [
    (2, 64, 64, 4, 4, 32), (2, 96, 96, 4, 2, 32), (2, 128, 128, 8, 1, 16),
    (2, 80, 48, 4, 4, 32), (2, 48, 80, 4, 2, 16), (1, 300, 300, 14, 2, 64),
    (1, 200, 333, 14, 2, 64), (2, 70, 70, 4, 1, 128),
    (2, 130, 130, 16, 1, 256)])
def test_flash_kernel_matches_plain(gpu, b, sq, skv, h, kv, hd, causal,
                                    dtype):
    rng = np.random.default_rng(sq + skv + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(gpu, dtype) for s in ((b, sq, h, hd), (b, skv, kv, hd),
                                         (b, skv, kv, hd)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 3e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), flash_attention_plain(
        q, k, v, causal=causal).float(), rtol=tol, atol=tol)


def test_flash_kernel_reads_strided_inputs(gpu):
    """q, k, v as slices of one fused [B, S, H + 2 KV, hd] tensor, as a
    projection could leave them: read by stride, not copied."""
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((2, 50, 8, 32)).astype(
        np.float32)).to(gpu)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    torch.testing.assert_close(flash_attention(q, k, v),
                               flash_attention_plain(q, k, v),
                               rtol=3e-4, atol=3e-4)


def test_flash_kernel_refuses_what_it_does_not_take(gpu):
    q = torch.zeros((1, 8, 4, 64), device=gpu)
    k = torch.zeros((1, 8, 2, 64), device=gpu)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError):
        flash_attention(q[..., :48], k[..., :48], k[..., :48])
    with pytest.raises(ValueError):
        flash_attention(torch.zeros((1, 64, 4, 8), device=gpu)
                        .permute(0, 3, 2, 1), k, k)  # hd not contiguous
    with pytest.raises(ValueError):
        flash_attention(q, k.cpu(), k)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros((1, 8, 3, 64), device=gpu),
                        torch.zeros((1, 8, 3, 64), device=gpu))


def _flash_inputs(gpu, shapes, dtype=torch.bfloat16, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(gpu, dtype) for s in shapes]


def _flash_tol_ratio(got, want):
    """The worst |kernel - plain| / (atol + rtol |plain|) over every
    element, with `chip_smoke.FLASH_TOL` (about one bf16 ulp)."""
    atol, rtol = chip_smoke.FLASH_TOL[want.dtype]
    diff = (got.float() - want.float()).abs()
    return float((diff / (atol + rtol * want.float().abs())).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(300, 517), (517, 300)])
def test_flash_tensor_core_at_hd_128_with_sq_not_skv(gpu, sq, skv, causal):
    """32 query heads on 8 KV heads of width 128, on the tensor cores,
    every element within the chip's tolerance."""
    q, k, v = _flash_inputs(gpu, ((2, sq, 32, 128), (2, skv, 8, 128),
                                  (2, skv, 8, 128)), seed=sq)
    before = TENSOR_CORE.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert TENSOR_CORE.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    assert _flash_tol_ratio(got, want) <= 1.0


def test_flash_tensor_core_reads_fused_qkv_slices(gpu):
    """bf16 q, k, v as head slices of one [B, S, H + 2 KV, hd] tensor
    (strides of 18 heads), read in place through TMA."""
    (qkv,) = _flash_inputs(gpu, ((2, 150, 14 + 2 + 2, 64),))
    q, k, v = qkv[:, :, :14], qkv[:, :, 14:16], qkv[:, :, 16:]
    before = TENSOR_CORE.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert TENSOR_CORE.launches == before + 1
    assert _flash_tol_ratio(got, flash_attention_plain(q, k, v)) <= 1.0


def test_flash_tensor_core_refuses_a_misaligned_input(gpu):
    """A view at an odd storage offset has no 16-byte-aligned start, which
    TMA needs: the wrapper raises rather than re-route it."""
    flat = torch.zeros(2 * 64 * 4 * 64 + 8, dtype=torch.bfloat16, device=gpu)
    q = flat[1:1 + 2 * 64 * 4 * 64].view(2, 64, 4, 64)
    (k,) = _flash_inputs(gpu, ((2, 64, 2, 64),))
    before = (TENSOR_CORE.launches, CUDA_CORE.launches)
    with pytest.raises(ValueError):
        flash_attention(q, k, k)
    assert (TENSOR_CORE.launches, CUDA_CORE.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_with_no_keys_gives_zeros(gpu, dtype):
    q, k = _flash_inputs(gpu, ((1, 70, 4, 64), (1, 0, 2, 64)), dtype)
    before = flash_attention.launches
    for causal in (True, False):
        out = flash_attention(q, k, k, causal=causal)
        assert out.dtype == dtype and torch.equal(out, torch.zeros_like(q))
    assert flash_attention.launches == before


def test_flash_counts_each_kernel_and_their_sum(gpu):
    """fp32 and bf16 at head dims 16, 32 on the CUDA cores, bf16 at 64,
    128, 256 on the tensor cores; `flash_attention.launches` counts
    both."""
    for kernel in (CUDA_CORE, TENSOR_CORE):
        kernel.launches = 0
    flash_attention.launches = 0
    calls = [(torch.float32, 64, CUDA_CORE), (torch.float32, 256, CUDA_CORE),
             (torch.bfloat16, 16, CUDA_CORE), (torch.bfloat16, 32, CUDA_CORE),
             (torch.bfloat16, 64, TENSOR_CORE),
             (torch.bfloat16, 128, TENSOR_CORE),
             (torch.bfloat16, 256, TENSOR_CORE)]
    for dtype, hd, kernel in calls:
        before = kernel.launches
        q, k = _flash_inputs(gpu, ((1, 40, 4, hd), (1, 40, 2, hd)), dtype)
        flash_attention(q, k, k)
        assert kernel.launches == before + 1
    torch.cuda.synchronize()
    assert (CUDA_CORE.launches, TENSOR_CORE.launches) == (4, 3)
    assert flash_attention.launches == 7


# rglru_scan: fp32 within a few ulps of the plain version (both fp32, the
# recurrence composed in another order); bf16 within one bf16 ulp
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,w", [(3, 257, 130), (2, 3000, 1024)])
def test_rglru_kernel_matches_plain(gpu, b, s, w, dtype):
    rng = np.random.default_rng(s + w)
    a = torch.from_numpy(rng.uniform(0.6, 0.999, (b, s, w)).astype(
        np.float32)).to(gpu, dtype)
    bb = torch.from_numpy(rng.standard_normal((b, s, w)).astype(
        np.float32)).to(gpu, dtype)
    before = rglru_scan.launches
    got = rglru_scan(a, bb)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 1
    assert got.dtype == dtype and got.shape == a.shape
    tol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-6, 2 ** -7)
    torch.testing.assert_close(got.float(), rglru_scan_plain(a, bb).float(),
                               atol=tol[0], rtol=tol[1])


def test_rglru_kernel_reads_strided_batch_and_seq(gpu):
    """a and b as slices of one [B, S, 2W] tensor: read by stride."""
    rng = np.random.default_rng(1)
    ab = torch.from_numpy(rng.uniform(0.6, 0.999, (2, 300, 256)).astype(
        np.float32)).to(gpu)
    a, bb = ab[..., :128], ab[..., 128:] - 0.8
    torch.testing.assert_close(rglru_scan(a, bb), rglru_scan_plain(a, bb),
                               rtol=1e-5, atol=1e-5)


def test_rglru_kernel_refuses_what_it_does_not_take(gpu):
    a = torch.zeros((1, 8, 64), device=gpu)
    with pytest.raises(ValueError):
        rglru_scan(a, a.cpu())                       # CPU/CUDA mix
    with pytest.raises(ValueError):
        rglru_scan(a.transpose(1, 2), a.transpose(1, 2))  # channel strided
    with pytest.raises(TypeError):
        rglru_scan(a.half(), a.half())
    with pytest.raises(TypeError):
        rglru_scan(a, a.bfloat16())
    with pytest.raises(ValueError):
        rglru_scan(a, a[:, :4])


def _scan_inputs(gpu, b, s, w, dtype, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(0.6, 0.999, (b, s, w)).astype(
        np.float32)).to(gpu, dtype)
    bb = torch.from_numpy(rng.standard_normal((b, s, w)).astype(
        np.float32)).to(gpu, dtype)
    return a, bb


# the bare scan held to chip_smoke.RGLRU_TOL on every element, at widths
# of 4 to 128 slabs; each call counts one launch
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,w", [(3, 257, 130), (2, 3000, 1024),
                                   (1, 1000, 4096)])
def test_rglru_scan_within_the_smoke_tolerance(gpu, b, s, w, dtype):
    a, bb = _scan_inputs(gpu, b, s, w, dtype, s + w)
    res = chip_smoke.rglru_against_plain(a, bb)
    assert res["finite"] and res["tol_ratio"] <= 1.0, res


def test_rglru_slab_reads_strided_and_odd_widths(gpu):
    """Slices of one [B, S, 2W] tensor read by stride in place, and a
    width whose rows are not whole 16 bytes (copied for TMA, the output a
    view of a padded buffer)."""
    a, bb = _scan_inputs(gpu, 2, 300, 512, torch.float32, 2)
    ab = torch.cat([a, bb], dim=-1)
    assert rg_lru.read_in_place(ab[..., 512:])
    got = rglru_scan(ab[..., :512], ab[..., 512:])
    torch.testing.assert_close(got, rglru_scan_plain(a, bb), rtol=2e-5,
                               atol=2e-6)
    a, bb = _scan_inputs(gpu, 3, 257, 130, torch.bfloat16, 3)
    got = rglru_scan(a, bb)
    assert got.shape == (3, 257, 130) and got.stride(1) == 136
    torch.testing.assert_close(got.float(), rglru_scan_plain(a, bb).float(),
                               rtol=2 ** -7, atol=2e-6)


def _gated_inputs(gpu, b, s, w, heads, gate_dtype, head_major,
                  long_memory=False, seed=0):
    g = torch.Generator(device=gpu).manual_seed(seed)
    hd = w // heads

    def logits():
        if head_major:
            return torch.randn((heads, b, s, hd), generator=g,
                               device=gpu).permute(1, 2, 0, 3)
        return torch.randn((b, s, w), generator=g, device=gpu)

    u = torch.rand(w, generator=g, device=gpu)
    a_param = (-9.0 + 1.5 * u if long_memory
               else torch.logit(0.81 + (0.998 - 0.81) * u))
    return (torch.randn((b, s, w), generator=g, device=gpu), logits(),
            logits(), torch.randn((b, s, w), generator=g,
                                  device=gpu).to(gate_dtype),
            0.5 * torch.randn(w, generator=g, device=gpu),
            0.5 * torch.randn(w, generator=g, device=gpu), a_param)


# the gated kernel against its plain version on every element, within
# chip_smoke.GATED_TOL (plus one bf16 ulp on bf16 outputs)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gate_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,w,heads,head_major", [
    (2, 300, 256, 8, True), (2, 300, 256, 8, False), (3, 257, 130, 1, False),
    (1, 2048, 4096, 16, True)])
def test_rglru_gated_kernel_matches_plain(gpu, b, s, w, heads, head_major,
                                          gate_dtype, out_dtype):
    args = _gated_inputs(gpu, b, s, w, heads, gate_dtype, head_major,
                         seed=s + w)
    res = chip_smoke.gated_against_plain(args, out_dtype)
    assert res["finite"] and res["tol_ratio"] <= 1.0, res


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_rglru_gated_kernel_at_long_memory(gpu, out_dtype):
    """a_param at the long-memory end (a 0.998 to 0.9995 at r 0.5), not
    only at the reference's nearly memoryless init."""
    args = _gated_inputs(gpu, 1, 1024, 128, 4, torch.bfloat16, True,
                         long_memory=True, seed=5)
    res = chip_smoke.gated_against_plain(args, out_dtype)
    assert res["finite"] and res["tol_ratio"] <= 1.0, res


def test_rglru_block_train_launches_the_gated_kernel_only(gpu):
    """The block under `use_kernels` on the card: one gated launch, no
    bare scan, and the plain branch's output within the gated tolerance
    carried through `wout`: |got - want| <= (atol + rtol |y|) @ |wout| +
    2 gamma_K (|y| @ |wout|), the second term the two fp32 products'
    rounding (gamma_K = K u, u = 2^-24)."""
    specs = TL.rglru_specs(64, 256, 8, 4)
    p = TL.init_params(specs, torch.Generator(device=gpu).manual_seed(0))
    x = torch.randn((2, 300, 64), generator=torch.Generator(
        device=gpu).manual_seed(1), device=gpu)
    rt = TL.Runtime(compute_dtype=torch.float32, use_kernels=True)
    counts = lambda: (rg_lru.rglru_gated_scan.launches, rglru_scan.launches)
    before = counts()
    with full_precision_products():
        got = TL.rglru_block_train(p, x, n_heads=8, rt=rt)
        torch.cuda.synchronize()
        assert counts() == (before[0] + 1, before[1])
        want = TL.rglru_block_train(p, x, n_heads=8, rt=TL.Runtime(
            compute_dtype=torch.float32))
        y = rg_lru.rglru_gated_scan_plain(
            *TL.rglru_gated_inputs(p, x, n_heads=8, rt=rt), p["ba"],
            p["bi"], p["a_param"], torch.float32)
        atol, rtol = chip_smoke.GATED_TOL
        w = p["wout"].abs()
        lim = ((atol + rtol * y.abs()) @ w
               + 2 * 256 * 2.0 ** -24 * (y.abs() @ w))
    assert bool(((got - want).abs() <= lim).all())


def test_rglru_gated_refuses_what_it_does_not_take(gpu):
    args = list(_gated_inputs(gpu, 1, 8, 64, 2, torch.float32, True))
    mixed = list(args)
    mixed[3] = mixed[3].cpu()
    with pytest.raises(ValueError):
        rg_lru.rglru_gated_scan(*mixed, torch.float32)
    half = list(args)
    half[1] = half[1].half()
    with pytest.raises(TypeError):
        rg_lru.rglru_gated_scan(*half, torch.float32)
    with pytest.raises(TypeError):
        rg_lru.rglru_gated_scan(*args, torch.float16)


# matmul: |kernel - plain| <= 2 gamma_K (|x| @ |y|), gamma_K = K u / (1 - K u)
# with u = 2^-24 (two fp32 sums of the same products in two orders), plus
# one bf16 ulp of the larger magnitude on bf16 outputs (both round once)
def assert_matmul_close(x, y, got, bk, rows=4096):
    k = x.shape[1]
    u = 2.0 ** -24
    rtol = 2 * k * u / (1 - k * u)
    with full_precision_products():
        for i in range(0, x.shape[0], rows):
            want = matmul_plain(x[i:i + rows], y, bk=bk,
                                out_dtype=got.dtype).float()
            g = got[i:i + rows].float()
            lim = rtol * (x[i:i + rows].float().abs() @ y.float().abs())
            if got.dtype == torch.bfloat16:
                _, e = torch.frexp(torch.maximum(g.abs(), want.abs()))
                lim = lim + torch.ldexp(torch.ones_like(lim), e - 8)
            assert bool(torch.isfinite(g).all())
            assert bool(((g - want).abs() <= lim).all()), \
                float(((g - want).abs() / lim.clamp_min(1e-38)).max())


def _matmul_inputs(m, k, n, dtype, device, seed=0):
    rng = np.random.default_rng(seed + m + k + n)
    return (torch.from_numpy(rng.standard_normal((m, k)).astype(
                np.float32)).to(device, dtype),
            torch.from_numpy(rng.standard_normal((k, n)).astype(
                np.float32)).to(device, dtype))


@pytest.mark.parametrize("tiles", [(64, 128, 64), (128, 64, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (200, 384, 136),
                                   (128, 1024, 96), (33, 65, 17)])
def test_matmul_kernel_matches_plain(gpu, m, k, n, dtype, tiles):
    """The sweep of tests/test_kernels.py."""
    x, y = _matmul_inputs(m, k, n, dtype, gpu)
    bm, bk, bn = tiles
    kernel = mm_kernel_for(dtype)
    other = MM_CUDA_CORE if kernel is MM_TENSOR_CORE else MM_TENSOR_CORE
    before = (matmul.launches, kernel.launches, other.launches)
    got = matmul(x, y, bm=bm, bk=bk, bn=bn)
    torch.cuda.synchronize()
    assert (matmul.launches, kernel.launches, other.launches) == \
        (before[0] + 1, before[1] + 1, before[2])
    assert got.dtype == dtype and got.shape == (m, n)
    assert_matmul_close(x, y, got, bk)


@pytest.mark.parametrize(
    "dtype,tile",
    [(torch.float32, t) for t in MM_CUDA_CORE.tiles]
    + [(torch.bfloat16, t) for t in MM_TENSOR_CORE.tiles], ids=str)
def test_matmul_every_tile(gpu, dtype, tile):
    """Every tile each kernel is instantiated for (fp32 on the CUDA cores,
    bf16 on the tensor cores), ragged on all three dims (K and N not
    multiples of 8: the wrapper pads them for TMA), both output dtypes."""
    bm, bk, bn = tile
    x, y = _matmul_inputs(300, 1000, 260, dtype, gpu)
    x, y = x[:, :997].contiguous(), y[:997, :259].contiguous()
    for out_dtype in (torch.float32, torch.bfloat16):
        got = matmul(x, y, bm=bm, bk=bk, bn=bn, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and got.shape == (300, 259)
        assert_matmul_close(x, y, got, bk)


def test_matmul_output_beyond_2_to_the_31(gpu):
    """M * N > 2^31 elements in bf16, on the tensor-core kernel: the
    output is indexed in 64 bits."""
    m, k, n = 32768, 64, 65600
    assert m * n > 2 ** 31
    x, y = _matmul_inputs(m, k, n, torch.bfloat16, gpu)
    before = MM_TENSOR_CORE.launches
    got = matmul(x, y, bm=128, bk=64, bn=128)
    torch.cuda.synchronize()
    assert MM_TENSOR_CORE.launches == before + 1
    assert_matmul_close(x, y, got, 64)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_matmul_all_positive_long_k(gpu, out_dtype):
    """x, y uniform in [0, 1) at (1024, 12288, 1024): no cancellation, so a
    one-sided rounding bias of the tensor cores' accumulation over K =
    12288 shows at its largest against the bound."""
    g = torch.Generator(device=gpu).manual_seed(0)
    x = torch.rand((1024, 12288), generator=g, device=gpu).bfloat16()
    y = torch.rand((12288, 1024), generator=g, device=gpu).bfloat16()
    got = matmul(x, y, bm=128, bk=64, bn=256, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert_matmul_close(x, y, got, 64)


def test_matmul_misaligned_k_runs_on_the_tensor_cores(gpu):
    """K = 1001 (rows of 2002 bytes) and a start 2 bytes past an aligned
    one: the wrapper zero-pads for TMA, and the tensor-core kernel runs."""
    x, y = _matmul_inputs(256, 1001, 192, torch.bfloat16, gpu)
    xs = torch.empty(x.numel() + 1, dtype=x.dtype, device=gpu)[1:]
    xs = xs.view(x.shape)
    xs.copy_(x)
    assert xs.data_ptr() % 16
    before = (MM_TENSOR_CORE.launches, MM_CUDA_CORE.launches)
    got = matmul(xs, y, bm=128, bk=64, bn=128)
    torch.cuda.synchronize()
    assert (MM_TENSOR_CORE.launches, MM_CUDA_CORE.launches) == \
        (before[0] + 1, before[1])
    assert_matmul_close(x, y, got, 64)


def test_matmul_kernel_refuses_what_it_does_not_take(gpu):
    x = torch.zeros((64, 64), device=gpu)
    with pytest.raises(ValueError):
        matmul(x, x, bm=32, bk=32, bn=32)              # no such tile
    with pytest.raises(ValueError):
        matmul(x, x.cpu(), bm=64, bk=64, bn=64)        # CPU/CUDA mix
    with pytest.raises(ValueError):
        matmul(x.t()[:, :32], x, bm=64, bk=64, bn=64)  # shapes, strides
    with pytest.raises(ValueError):
        matmul(x[:, ::2], x[::2], bm=64, bk=64, bn=64)  # not contiguous
    with pytest.raises(TypeError):
        matmul(x.half(), x.half(), bm=64, bk=64, bn=64)
    with pytest.raises(TypeError):
        matmul(x, x.bfloat16(), bm=64, bk=64, bn=64)


def test_dry_run_counts_fake_cuda_tensors_as_fake_cpu(gpu):
    """A tiny dry-run on fake CUDA tensors counts what the same step on
    fake CPU tensors counts."""
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.steps import trace_step

    arch = configs.get_smoke("qwen2-0.5b")
    for shape in (ShapeSpec("p", 64, 2, "prefill"),
                  ShapeSpec("d", 64, 2, "decode")):
        on_cuda, _ = trace_step(arch, shape, device="cuda")
        on_cpu, _ = trace_step(arch, shape, device="cpu")
        assert on_cuda.flops == on_cpu.flops > 0
        assert on_cuda.matmul_flops == on_cpu.matmul_flops > 0
        assert on_cuda.elementwise_flops == on_cpu.elementwise_flops > 0
        assert on_cuda.transcendentals == on_cpu.transcendentals > 0
        assert on_cuda.peak_bytes == on_cpu.peak_bytes > 0
        assert on_cuda.bytes_accessed == on_cpu.bytes_accessed


def test_parallel_study_on_the_card_equals_serial(gpu):
    """workers=2 on the card (spawned workers, each with its own CUDA
    context) gives the workers=1 bytes, and every pool task launched
    gather_rows in its own process."""
    import json

    from repro_torch.dse import SearchBudget, Study

    kw = dict(apps=["ptb", "wdl"], engine="greedy", seed=0, device="cuda",
              budget=SearchBudget.smoke())
    serial = Study(**kw).run()
    pooled = Study(workers=2, **kw)
    res = pooled.run()
    assert json.dumps(res.to_json()) == json.dumps(serial.to_json())
    tasks = pooled.launch_stats["tasks"]
    assert tasks and all(t["pool"] and t["launches"] > 0 for t in tasks)
    assert pooled.launch_stats["workers"] == sum(t["launches"]
                                                 for t in tasks)
