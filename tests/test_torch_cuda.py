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
from repro_torch.kernels.gather import gather_rows, gather_rows_plain

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
