"""`repro_torch.kernels.rg_lru` and the port's RG-LRU and local-attention
layers on the CPU, against the JAX package.

Inputs come from numpy with a seed and go through both packages.  The
scan is held to the tolerances of `tests/test_kernels.py` (rtol/atol
2e-4: fp32 recurrences composed in another order); the layers, fp32 on
both sides, to 2e-5 (the same arithmetic in another summation order),
and the RG-LRU block, whose scan composes 2^k-step maps in another order
than `associative_scan`, to 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models import layers as JL
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rg_lru import rglru_scan, rglru_scan_plain
from repro_torch.models import layers as TL

JRT = JL.Runtime(compute_dtype=jnp.float32)
TRT = TL.Runtime(compute_dtype=torch.float32)
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=2e-5, atol=2e-5)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


def _scan_inputs(b, s, w, seed=0):
    """a drawn in (0.6, 0.999) as in the sweep of tests/test_kernels.py."""
    r = _rng(seed)
    return (r.uniform(0.6, 0.999, (b, s, w)).astype(np.float32),
            r.standard_normal((b, s, w)).astype(np.float32))


# ---------------------------------------------------------------- the scan

@pytest.mark.parametrize("b,s,w", [(1, 64, 128), (2, 100, 160),
                                   (3, 257, 130), (2, 1, 8)])
def test_scan_matches_the_sequential_reference(b, s, w):
    a, bb = _scan_inputs(b, s, w, seed=s)
    got = rglru_scan(torch.from_numpy(a), torch.from_numpy(bb))
    want = ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(bb))
    assert got.dtype == torch.float32 and got.shape == (b, s, w)
    _close(got, want, **SCAN_TOL)


def test_scan_long_decay_is_stable():
    """The 1024-step decay case of tests/test_kernels.py: a = 0.999, b = 1;
    every step, not only the last, against the sequential reference."""
    a = np.full((1, 1024, 128), 0.999, np.float32)
    bb = np.ones((1, 1024, 128), np.float32)
    got = rglru_scan(torch.from_numpy(a), torch.from_numpy(bb))
    want = ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(bb))
    assert bool(torch.isfinite(got).all())
    _close(got, want, **SCAN_TOL)


def test_scan_bf16_returns_bf16_from_fp32_math():
    a, bb = _scan_inputs(2, 50, 16, seed=3)
    ta, tb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, bb))
    got = rglru_scan(ta, tb)
    want = ref.rglru_scan_ref(jnp.asarray(ta.float().numpy(), jnp.bfloat16),
                              jnp.asarray(tb.float().numpy(), jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, want, rtol=2 ** -7, atol=1e-6)


# each case compiles the Pallas kernel anew: two of the sweep and the decay
@pytest.mark.parametrize("b,s,w,bs,bw,decay", [(2, 100, 160, 32, 128, False),
                                               (3, 257, 130, 64, 256, False),
                                               (1, 1024, 128, 256, 128, True)])
def test_plain_matches_the_pallas_kernel(b, s, w, bs, bw, decay):
    if decay:
        a = np.full((b, s, w), 0.999, np.float32)
        bb = np.ones((b, s, w), np.float32)
    else:
        a, bb = _scan_inputs(b, s, w, seed=1)
    want = ops.rglru_scan(jnp.asarray(a), jnp.asarray(bb), bs=bs, bw=bw,
                          interpret=True)
    got = rglru_scan_plain(torch.from_numpy(a), torch.from_numpy(bb))
    _close(got, want, **SCAN_TOL)


def test_cpu_tensors_take_the_plain_path_without_a_launch():
    a, bb = map(torch.from_numpy, _scan_inputs(1, 20, 8))
    before = rglru_scan.launches
    out = rglru_scan(a, bb)
    assert rglru_scan.launches == before
    assert torch.equal(out, rglru_scan_plain(a, bb))


def test_mixed_devices_raise():
    a, bb = map(torch.from_numpy, _scan_inputs(1, 8, 4))
    with pytest.raises(ValueError):
        rglru_scan(a, bb.to("meta"))
    with pytest.raises(ValueError):
        rglru_scan(a.to("meta"), bb.to("meta"))


# -------------------------------------------------------- flash at hd 256

def test_flash_plain_matches_the_pallas_kernel_at_head_dim_256():
    """recurrentgemma's attention heads: 16 query heads on one KV head of
    width 256, causal, bf16 (one bf16 ulp, as tests/test_kernels.py)."""
    r = _rng(4)
    q, k, v = (r.standard_normal(s).astype(np.float32)
               for s in ((1, 48, 4, 256), (1, 48, 1, 256), (1, 48, 1, 256)))
    want = ops.flash_attention(*[jnp.asarray(x, jnp.bfloat16)
                                 for x in (q, k, v)],
                               causal=True, bq=16, bkv=16, interpret=True)
    got = flash_attention_plain(*[torch.from_numpy(x).to(torch.bfloat16)
                                  for x in (q, k, v)], causal=True)
    _close(got, np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)


# ------------------------------------------------------------------ layers

def _rglru_params(d=16, w=32, h=2, conv=4, seed=5):
    specs = JL.rglru_specs(d, w, h, conv)
    p = JL.init_params(specs, jax.random.PRNGKey(seed))
    r = _rng(seed)     # non-zero biases, so the bias paths are checked
    p = {k: (jnp.asarray(r.standard_normal(v.shape).astype(np.float32))
             * 0.1 if k in ("conv_b", "ba", "bi") else v)
         for k, v in p.items()}
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def test_rglru_specs_equal_the_reference():
    want = JL.rglru_specs(64, 96, 4, 4)
    got = TL.rglru_specs(64, 96, 4, 4)
    assert list(got) == list(want)
    for k in want:
        assert dataclasses.astuple(got[k]) == dataclasses.astuple(want[k])


@pytest.mark.parametrize("with_prefix", [False, True])
def test_causal_conv1d(with_prefix):
    r = _rng(6)
    x = r.standard_normal((2, 9, 32)).astype(np.float32)
    w = r.standard_normal((4, 32)).astype(np.float32)
    b = r.standard_normal(32).astype(np.float32)
    pre = r.standard_normal((2, 3, 32)).astype(np.float32) \
        if with_prefix else None
    want = JL._causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             prefix=None if pre is None else jnp.asarray(pre))
    got = TL._causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b),
                            prefix=None if pre is None
                            else torch.from_numpy(pre))
    _close(got, want)


def test_rglru_gates():
    jp, tp = _rglru_params()
    x = _rng(7).standard_normal((2, 9, 32)).astype(np.float32)
    jr, ji = JL._rglru_gates(jp, jnp.asarray(x), 2)
    tr, ti = TL._rglru_gates(tp, torch.from_numpy(x), 2)
    _close(tr, jr)
    _close(ti, ji)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_rglru_block_train_both_branches(use_kernels):
    jp, tp = _rglru_params()
    x = _rng(8).standard_normal((2, 37, 16)).astype(np.float32) * 0.5
    want = JL.rglru_block_train(jp, jnp.asarray(x), n_heads=2, rt=JRT)
    got = TL.rglru_block_train(
        tp, torch.from_numpy(x), n_heads=2,
        rt=dataclasses.replace(TRT, use_kernels=use_kernels))
    _close(got, want, **BLOCK_TOL)


def test_rglru_block_decode_steps():
    """Nine decode steps from a zero state, output and state each step."""
    jp, tp = _rglru_params(seed=9)
    xs = _rng(9).standard_normal((9, 2, 1, 16)).astype(np.float32) * 0.5
    js = {"h": jnp.zeros((2, 32)), "conv": jnp.zeros((2, 3, 32))}
    ts = {"h": torch.zeros((2, 32)), "conv": torch.zeros((2, 3, 32))}
    for x in xs:
        jy, js = JL.rglru_block_decode(jp, jnp.asarray(x), js, n_heads=2,
                                       rt=JRT)
        ty, ts = TL.rglru_block_decode(tp, torch.from_numpy(x), ts,
                                       n_heads=2, rt=TRT)
        _close(ty, jy)
        _close(ts["h"], js["h"])
        _close(ts["conv"], js["conv"])
        assert ts["h"].dtype == ts["conv"].dtype == torch.float32


@pytest.mark.parametrize("s,window", [(11, 16), (16, 16), (37, 16),
                                      (37, 5)])
def test_local_block_attention(s, window):
    """S < window (one block of S rows), S == window, and S > window with
    S not a multiple of it (a padded last block)."""
    r = _rng(10)
    q = r.standard_normal((2, s, 4, 16)).astype(np.float32)
    k = r.standard_normal((2, s, 1, 16)).astype(np.float32)
    v = r.standard_normal((2, s, 1, 16)).astype(np.float32)
    want = JL.local_block_attention(*map(jnp.asarray, (q, k, v)), window)
    got = TL.local_block_attention(*map(torch.from_numpy, (q, k, v)), window)
    assert got.shape == (2, s, 4, 16)
    _close(got, want)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_gqa_attention_train_with_a_window(use_kernels):
    """The reference's branch order: a window shorter than S takes
    local-block attention, whatever `use_kernels` says."""
    specs = JL.gqa_specs(32, 4, 1, 8, qkv_bias=False)
    jp = JL.init_params(specs, jax.random.PRNGKey(11))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = _rng(11).standard_normal((2, 21, 32)).astype(np.float32)
    kw = dict(n_heads=4, n_kv=1, hd=8, rope_theta=1e4, window=8)
    want = JL.gqa_attention_train(
        jp, jnp.asarray(x), rt=dataclasses.replace(JRT, use_pallas=False),
        **kw)
    got = TL.gqa_attention_train(
        tp, torch.from_numpy(x),
        rt=dataclasses.replace(TRT, use_kernels=use_kernels), **kw)
    _close(got, want)
