"""Tests of the port that need an NVIDIA GPU (marker `cuda`).

They skip where `torch.cuda.is_available()` is False.  On a machine with a
GPU and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.multiapp import AppSpec
from repro_torch.core.space import default_space
from repro_torch.kernels.costmodel import FusedTorchScorer
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.gather import gather_rows, gather_rows_plain
from repro_torch.kernels.rg_lru import rglru_scan, rglru_scan_plain

pytestmark = pytest.mark.cuda


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
# round the output to bf16)
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


# rglru_scan: fp32 within a few ulps of the plain version (both fp32, the
# carries composed in another order); bf16 within one bf16 ulp
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
