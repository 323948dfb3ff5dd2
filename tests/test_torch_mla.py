"""The port's multi-head latent attention (MLA, deepseek-v2-lite-16b)
against the JAX package, on the CPU in fp32: the expanded train form, the
weight-absorbed decode over the latent cache, and the cache itself.

Inputs come from numpy with a seed; parameters are the reference's own.
Tolerances are the reference's own: attention 3e-4
(`tests/test_recurrent_blocks.py`, blocked attention against dense), a
block's train form against its decode 2e-4 there too, widened for the
bf16 cache as `tests/test_decode_parity.py` widens it (rtol 2e-2, atol
5e-3); a cache entry within one bf16 rounding (2^-8 relative) of the
reference's, since it is the fp32 value rounded to bf16 once."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

TOL = dict(rtol=3e-4, atol=3e-4)
PARITY_TOL = dict(rtol=2e-2, atol=5e-3)
CACHE_TOL = dict(rtol=2 ** -8, atol=2 ** -8)
DIMS = dict(n_heads=4, kv_lora=32, nope=16, rope_d=8, v_hd=16)
D, EPS, THETA = 64, 1e-6, 1e4


def _params(seed=3):
    specs = JL.mla_specs(D, DIMS["n_heads"], DIMS["kv_lora"], DIMS["nope"],
                         DIMS["rope_d"], DIMS["v_hd"])
    jp = JL.init_params(specs, jax.random.PRNGKey(seed), jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tp


def _x(b, s, seed=5):
    x = np.random.default_rng(seed).standard_normal((b, s, D)).astype(
        np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _kw(**extra):
    return dict(DIMS, rope_theta=THETA, eps=EPS, **extra)


def test_specs_equal_the_reference():
    want = JL.mla_specs(D, 4, 32, 16, 8, 16)
    got = TL.mla_specs(D, 4, 32, 16, 8, 16)
    assert {k: (v.shape, v.axes, v.init) for k, v in got.items()} == \
        {k: (v.shape, v.axes, v.init) for k, v in want.items()}


@pytest.mark.parametrize("kv_block", [1024, 8])
def test_train_form_matches_the_reference(kv_block):
    """One KV block, and several (with a padded tail at S 21)."""
    jp, tp = _params()
    jx, tx = _x(2, 21)
    want = JL.mla_attention_train(
        jp, jx, rt=JL.Runtime(compute_dtype=jnp.float32,
                              attn_kv_block=kv_block), **_kw())
    got = TL.mla_attention_train(
        tp, tx, rt=TL.Runtime(compute_dtype=torch.float32,
                              attn_kv_block=kv_block), **_kw())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _decode_both(jp, tp, jx, tx, steps, max_len):
    jrt = JL.Runtime(compute_dtype=jnp.float32)
    trt = TL.Runtime(compute_dtype=torch.float32)
    B, R, L = jx.shape[0], DIMS["rope_d"], DIMS["kv_lora"]
    jc = {"ckv": jnp.zeros((B, max_len, L), jnp.bfloat16),
          "krope": jnp.zeros((B, max_len, R), jnp.bfloat16)}
    tc = {"ckv": torch.zeros((B, max_len, L), dtype=torch.bfloat16),
          "krope": torch.zeros((B, max_len, R), dtype=torch.bfloat16)}
    outs = []
    for t in range(steps):
        want, jc = JL.mla_attention_decode(jp, jx[:, t:t + 1], jc,
                                           jnp.int32(t), rt=jrt, **_kw())
        got, tc = TL.mla_attention_decode(tp, tx[:, t:t + 1], tc,
                                          torch.tensor(t), rt=trt, **_kw())
        outs.append((got, want))
    return outs, jc, tc


def test_decode_and_latent_cache_match_the_reference():
    """Eight absorbed decode steps: each output within the attention
    tolerance, the bf16 latent cache (ckv [B, S, kv_lora], krope
    [B, S, rope_d]) within one bf16 rounding, its unwritten slots zero."""
    jp, tp = _params()
    jx, tx = _x(2, 8, seed=6)
    outs, jc, tc = _decode_both(jp, tp, jx, tx, steps=8, max_len=12)
    for got, want in outs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key, width in (("ckv", DIMS["kv_lora"]), ("krope", DIMS["rope_d"])):
        assert tc[key].dtype == torch.bfloat16
        assert tuple(tc[key].shape) == (2, 12, width)
        np.testing.assert_allclose(tc[key].float().numpy(),
                                   np.asarray(jc[key], np.float32),
                                   **CACHE_TOL)
        assert not tc[key][:, 8:].any()


def test_decode_computes_the_expanded_attention():
    """The absorbed decode over the latent cache against the expanded
    train form on the same sequence, step by step."""
    _, tp = _params(seed=4)
    _, tx = _x(1, 10, seed=8)
    trt = TL.Runtime(compute_dtype=torch.float32)
    full = TL.mla_attention_train(tp, tx, rt=trt, **_kw())
    cache = {"ckv": torch.zeros((1, 16, DIMS["kv_lora"]),
                                dtype=torch.bfloat16),
             "krope": torch.zeros((1, 16, DIMS["rope_d"]),
                                  dtype=torch.bfloat16)}
    rows = []
    for t in range(10):
        y, cache = TL.mla_attention_decode(tp, tx[:, t:t + 1], cache,
                                           torch.tensor(t), rt=trt, **_kw())
        rows.append(y[:, 0])
    np.testing.assert_allclose(torch.stack(rows, 1).numpy(), full.numpy(),
                               **PARITY_TOL)


def test_cache_specs_are_the_latent_cache():
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import DecoderLM

    model = DecoderLM(get_arch("deepseek-v2-lite-16b"))
    specs = model.cache_specs(2, 256)
    assert len(specs) == 27
    assert all(set(c) == {"ckv", "krope"} for c in specs)
    assert specs[0]["ckv"].shape == (2, 256, 512)
    assert specs[0]["krope"].shape == (2, 256, 64)
    assert specs[0]["ckv"].dtype == "bf16"
    # (512 + 64) x 2 B a token and layer, against GQA's 2 x 16 x 128 x 2 B
    per_token = sum(math.prod(s.shape[2:]) * 2 for s in specs[0].values())
    assert per_token == (512 + 64) * 2 < 2 * 16 * 128 * 2

