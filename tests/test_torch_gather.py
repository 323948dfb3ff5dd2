"""The port's `gather_rows` against the JAX package's Pallas `gather_rows`.

On the CPU the port's wrapper runs its plain PyTorch version; the Pallas
kernel runs in interpret mode with 64-bit types enabled.  Both must give
the same bits, zero rows for out-of-range indices included.
"""

import jax
import numpy as np
import pytest
import torch

from repro.kernels.costmodel import gather_rows as pallas_gather_rows
from repro_torch.kernels.gather import gather_rows, gather_rows_plain


def _table(rng, dtype, u, o):
    if dtype == "int64":
        return rng.integers(-2**40, 2**40, size=(u, o)).astype(np.int64)
    return rng.standard_normal((u, o))


@pytest.mark.parametrize("dtype", ["int64", "float64"])
@pytest.mark.parametrize("u,o", [(280, 2), (900, 21), (2304, 44)])
@pytest.mark.parametrize("c", [1, 127, 300])
def test_gather_rows_matches_pallas(dtype, u, o, c):
    rng = np.random.default_rng(u * 1000 + o * 10 + c)
    table = _table(rng, dtype, u, o)
    # indices below 0 and at or past U must give zero rows
    idx = rng.integers(-5, u + 5, size=c).astype(np.int64)
    idx[0] = -1 if c > 1 else u
    launches = gather_rows.launches
    with jax.enable_x64(True):
        want = np.asarray(pallas_gather_rows(table, idx, interpret=True))
    got = gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.from_numpy(table).dtype
    assert got.shape == (c, o)
    np.testing.assert_array_equal(got.numpy(), want)     # bit-equal
    assert want.dtype == table.dtype
    # the CPU path runs the plain version and launches no kernel
    assert gather_rows.launches == launches == 0


def test_gather_rows_plain_zero_rows_and_empty_pool():
    table = torch.arange(12, dtype=torch.int64).reshape(4, 3) + 1
    idx = torch.tensor([3, -1, 4, 0, -100, 100], dtype=torch.int64)
    got = gather_rows_plain(table, idx)
    want = torch.tensor([[10, 11, 12], [0, 0, 0], [0, 0, 0], [1, 2, 3],
                         [0, 0, 0], [0, 0, 0]])
    assert torch.equal(got, want)
    empty = gather_rows(table, torch.zeros(0, dtype=torch.int64))
    assert empty.shape == (0, 3)


def test_gather_rows_refuses_tensors_off_the_cpu_and_gpu():
    """A tensor that is not on the CPU goes to the kernel or raises; it
    never falls back to the plain version."""
    table = torch.empty((4, 3), dtype=torch.int64, device="meta")
    idx = torch.empty((2,), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        gather_rows(table, idx)
    with pytest.raises(ValueError, match="CUDA"):
        gather_rows(torch.zeros((4, 3), dtype=torch.int64), idx)
    assert gather_rows.launches == 0
