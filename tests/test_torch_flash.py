"""`repro_torch.kernels.flash_attention` on the CPU: its plain version
against the JAX package's Pallas kernel (interpret mode) and dense oracle,
and the wrapper's contract.

Inputs come from numpy with a seed.  Tolerances are those of
`tests/test_kernels.py`: fp32 3e-4 (two fp32 summation orders over at
most 128 keys), bf16 2e-2 (both sides round the output to bf16, so one
bf16 ulp of an O(1) value)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

TOL = {"float32": dict(rtol=3e-4, atol=3e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# each shape of the sweep of tests/test_kernels.py, both masks and both
# dtypes, plus causal shapes with Sq != Skv in each dtype (both kernels
# mask top-left, so they need not be skipped here).  Each case compiles
# the Pallas kernel anew, so the grid is not a full product.
CASES = [
    (64, 64, 4, 4, 32, True, "float32"),        # MHA
    (96, 96, 4, 2, 32, False, "bfloat16"),      # GQA 2:1
    (128, 128, 8, 1, 16, True, "bfloat16"),     # MQA
    (80, 48, 4, 4, 32, False, "float32"),       # uneven, padded
    (80, 48, 4, 4, 32, True, "float32"),        # causal, Sq > Skv
    (80, 48, 4, 4, 32, True, "bfloat16"),
    (48, 80, 4, 2, 16, True, "bfloat16"),       # causal, Sq < Skv
    (100, 36, 7, 1, 64, True, "float32"),       # qwen2's 7:1 grouping, hd 64
]


def _inputs(b, sq, skv, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kv, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kv, hd)).astype(np.float32))


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(TORCH[dtype]) for a in arrs]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("sq,skv,h,kv,hd,causal,dtype", CASES)
def test_plain_matches_the_pallas_kernel(sq, skv, h, kv, hd, causal, dtype):
    arrs = _inputs(2, sq, skv, h, kv, hd)
    want = ops.flash_attention(*[jnp.asarray(a, JNP[dtype]) for a in arrs],
                               causal=causal, bq=32, bkv=32, interpret=True)
    got = flash_attention_plain(*_torch(arrs, dtype), causal=causal)
    assert got.dtype == TORCH[dtype] and got.shape == (2, sq, h, hd)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("sq,h,kv,hd", [(64, 4, 4, 32), (96, 4, 2, 32),
                                        (128, 8, 1, 16)])
def test_plain_matches_the_dense_oracle_where_sq_equals_skv(sq, h, kv, hd):
    """Causal: where Sq == Skv the oracle's bottom-right mask is the
    kernel's top-left one."""
    arrs = _inputs(2, sq, sq, h, kv, hd, seed=1)
    want = ref.flash_attention_ref(*map(jnp.asarray, arrs), causal=True)
    got = flash_attention_plain(*_torch(arrs, "float32"), causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["float32"])


@pytest.mark.parametrize("sq,skv", [(96, 96), (96, 40)])
def test_plain_in_query_chunks_equals_the_whole(sq, skv):
    """`q_offset` places a chunk of query rows where it sits in the whole,
    so a long sequence can be checked chunk by chunk."""
    q, k, v = _torch(_inputs(2, sq, skv, 4, 2, 16, seed=2), "float32")
    whole = flash_attention_plain(q, k, v, causal=True)
    chunks = torch.cat([flash_attention_plain(q[:, i:i + 32], k, v,
                                              causal=True, q_offset=i)
                        for i in range(0, sq, 32)], dim=1)
    torch.testing.assert_close(chunks, whole, rtol=1e-6, atol=1e-6)


def test_causal_mask_is_top_left():
    """Row i sees keys 0..i, whatever Skv is: with v = key index, the
    first row attends to key 0 alone."""
    q = torch.zeros(1, 3, 1, 16)
    k = torch.zeros(1, 5, 1, 16)
    v = torch.arange(5.0)[None, :, None, None].expand(1, 5, 1, 16)
    out = flash_attention_plain(q, k, v, causal=True)[0, :, 0, 0]
    torch.testing.assert_close(out, torch.tensor([0.0, 0.5, 1.0]))


def test_cpu_tensors_take_the_plain_path_without_a_launch():
    q, k, v = _torch(_inputs(1, 20, 20, 4, 2, 16), "float32")
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before
    assert torch.equal(out, flash_attention_plain(q, k, v, causal=True))


def test_mixed_devices_raise():
    q, k, v = _torch(_inputs(1, 8, 8, 2, 2, 16), "float32")
    with pytest.raises(ValueError):
        flash_attention(q, k.to("meta"), v, causal=True)
    with pytest.raises(ValueError):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
