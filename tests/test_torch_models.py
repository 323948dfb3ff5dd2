"""The port's configs and dense-decoder layers against the JAX package, on
the CPU in fp32.

Inputs come from numpy with a seed and go through both packages.  Layer
outputs agree to 2e-5 (the same fp32 arithmetic in another summation
order); the decode paths, which keep the KV cache in bf16 as the
reference does, to 1e-4."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm

JRT = JL.Runtime(compute_dtype=jnp.float32)
TRT = TL.Runtime(compute_dtype=torch.float32)
TOL = dict(rtol=2e-5, atol=2e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_configs_equal_the_reference_field_for_field(name):
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    for get in ("get_arch", "get_smoke"):
        want = dataclasses.asdict(getattr(jconfigs, get)(name))
        got = dataclasses.asdict(getattr(tconfigs, get)(name))
        assert got == want
    assert tconfigs.get_arch(name).param_count() == \
        jconfigs.get_arch(name).param_count()


def test_shapes_equal_the_reference():
    assert [dataclasses.asdict(s) for s in tconfigs.SHAPES] == \
        [dataclasses.asdict(s) for s in jconfigs.SHAPES]
    assert tconfigs.shape_by_name("prefill_32k").seq_len == 32768


# ------------------------------------------------------------------- layers

def test_rms_norm():
    r = _rng(1)
    (jx, tx), (js, ts) = _both(r.standard_normal((2, 5, 24)).astype(
        np.float32)), _both(r.standard_normal(24).astype(np.float32))
    _close(TL.rms_norm(tx, ts, 1e-6), JL.rms_norm(jx, js, 1e-6))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    r = _rng(2)
    jx, tx = _both(r.standard_normal((2, 7, 3, 16)).astype(np.float32))
    jc, js = JL.rope_cos_sin(jnp.arange(7)[None, :], 16, theta)
    tc, ts = TL.rope_cos_sin(torch.arange(7)[None, :], 16, theta)
    _close(tc, jc)
    _close(ts, js)
    _close(TL.apply_rope(tx, tc, ts), JL.apply_rope(jx, jc, js))


@pytest.mark.parametrize("sq,skv,kw", [
    (19, 19, dict(causal=True)), (19, 19, dict(causal=False)),
    (19, 19, dict(causal=True, kv_block=8)),       # ragged last block
    (19, 19, dict(causal=False, kv_block=8)),
    (4, 10, dict(causal=True, kv_block=4)),        # Sq < Skv, top-left
    (12, 5, dict(causal=True, kv_block=2)),        # Sq > Skv
])
def test_blocked_attention(sq, skv, kw):
    r = _rng(3)
    jq, tq = _both(r.standard_normal((2, sq, 6, 16)).astype(np.float32))
    jk, tk = _both(r.standard_normal((2, skv, 2, 16)).astype(np.float32))
    jv, tv = _both(r.standard_normal(tk.shape).astype(np.float32))
    _close(TL.blocked_attention(tq, tk, tv, **kw),
           JL.blocked_attention(jq, jk, jv, **kw))


def test_full_precision_products_is_scoped():
    """The serving steps switch off TF32 and bf16 reductions for their
    own products only: the caller's settings come back after the block."""
    mm = torch.backends.cuda.matmul
    saved = (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction)
    try:
        mm.allow_tf32 = mm.allow_bf16_reduced_precision_reduction = True
        with TL.full_precision_products():
            assert not mm.allow_tf32
            assert not mm.allow_bf16_reduced_precision_reduction
        assert mm.allow_tf32 and mm.allow_bf16_reduced_precision_reduction
    finally:
        mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction = saved


def test_kv_cache_write_in_place():
    r = _rng(4)
    jc, tc = _both(np.zeros((2, 6, 2, 8), np.float32))
    jn, tn = _both(r.standard_normal((2, 1, 2, 8)).astype(np.float32))
    want = JL.kv_cache_write(jc.astype(jnp.bfloat16), jn, 3, JRT)
    tcb = tc.to(torch.bfloat16)
    got = TL.kv_cache_write(tcb, tn, torch.tensor(3))
    assert got is tcb and got.dtype == torch.bfloat16
    _close(got, want, rtol=0, atol=0)


def _gqa_params(d=32, h=4, kv=2, hd=8, seed=5):
    specs = JL.gqa_specs(d, h, kv, hd, qkv_bias=True)
    p = JL.init_params(specs, jax.random.PRNGKey(seed))
    r = _rng(seed)     # non-zero biases, so the bias path is checked
    p = {k: (jnp.asarray(r.standard_normal(v.shape).astype(np.float32))
             * 0.1 if k.startswith("b") else v) for k, v in p.items()}
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("use_kernels", [False, True])
def test_gqa_attention_train_both_branches(use_kernels):
    jp, tp = _gqa_params()
    jx, tx = _both(_rng(6).standard_normal((2, 13, 32)).astype(np.float32))
    kw = dict(n_heads=4, n_kv=2, hd=8, rope_theta=1e4)
    want = JL.gqa_attention_train(
        jp, jx, rt=dataclasses.replace(JRT, use_pallas=use_kernels), **kw)
    got = TL.gqa_attention_train(
        tp, tx, rt=dataclasses.replace(TRT, use_kernels=use_kernels), **kw)
    _close(got, want)


@pytest.mark.parametrize("window", [0, 4])
def test_gqa_attention_decode(window):
    """Eleven decode steps from an empty cache; with a window the cache is
    a 4-slot ring buffer that wraps twice."""
    jp, tp = _gqa_params(seed=7)
    xs = _rng(8).standard_normal((11, 2, 1, 32)).astype(np.float32)
    s_max = window or 16
    jc = {n: jnp.zeros((2, s_max, 2, 8), jnp.bfloat16) for n in "kv"}
    tc = {n: torch.zeros((2, s_max, 2, 8), dtype=torch.bfloat16)
          for n in "kv"}
    kw = dict(n_heads=4, n_kv=2, hd=8, rope_theta=1e4, window=window)
    for pos, x in enumerate(xs):
        jy, jc = JL.gqa_attention_decode(jp, jnp.asarray(x), jc,
                                         jnp.int32(pos), rt=JRT, **kw)
        ty, tc = TL.gqa_attention_decode(tp, torch.from_numpy(x), tc,
                                         torch.tensor(pos), rt=TRT, **kw)
        _close(ty, jy, rtol=1e-4, atol=1e-4)
    for n in "kv":
        _close(tc[n], jc[n], rtol=0, atol=0)


def test_swiglu():
    specs = JL.swiglu_specs(24, 40)
    jp = JL.init_params(specs, jax.random.PRNGKey(9))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    jx, tx = _both(_rng(9).standard_normal((2, 5, 24)).astype(np.float32))
    _close(TL.swiglu(tp, tx, TRT), JL.swiglu(jp, jx, JRT))


def test_cross_entropy_and_vocab_padding():
    r = _rng(10)
    jl, tl = _both(r.standard_normal((2, 6, 512)).astype(np.float32) * 3)
    jt, tt = _both(r.integers(0, 512, (2, 6)))
    _close(tlm.cross_entropy(tl, tt), jlm.cross_entropy(jl, jt, JRT))
    for v in (512, 151936, 151655):
        assert tlm.padded_vocab(v) == jlm.padded_vocab(v)


def test_init_params_rules():
    """The reference's init rules, from a torch.Generator: ones, zeros,
    and normal with std min(0.02, 1/sqrt(fan_in))."""
    specs = {"w": TL.Spec((4096, 64), ("a", "b")),
             "s": TL.Spec((64,), ("b",), "ones"),
             "z": TL.Spec((64,), ("b",), "zeros", "bf16")}
    p = TL.init_params(specs, torch.Generator().manual_seed(0))
    assert p["w"].dtype == torch.float32 and p["z"].dtype == torch.bfloat16
    assert torch.equal(p["s"], torch.ones(64))
    assert torch.equal(p["z"], torch.zeros(64, dtype=torch.bfloat16))
    assert math.isclose(float(p["w"].std()), min(0.02, 1 / 64), rel_tol=0.02)
    again = TL.init_params(specs, torch.Generator().manual_seed(0))
    assert torch.equal(p["w"], again["w"])


@pytest.mark.parametrize("name", ["qwen2.5-3b", "mistral-nemo-12b",
                                  "internvl2-1b"])
def test_dense_decoders_forward_match_the_reference(name):
    """qwen2.5 (head dim 24), mistral-nemo (untied head, no bias) and
    internvl2 (a patch-embedding prefix) at smoke size, fp32."""
    from repro.launch.steps import build_model
    from repro_torch.convert import decoder_params_from_numpy
    jcfg, tcfg = jconfigs.get_smoke(name), tconfigs.get_smoke(name)
    jm, tm = build_model(jcfg), tlm.DecoderLM(tcfg)
    jp = jm.init(jax.random.PRNGKey(3), JRT)
    tp = decoder_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp))
    r = _rng(11)
    batch = {"tokens": r.integers(0, jcfg.vocab_size, (2, 9))}
    if jcfg.frontend == "vit_stub":
        batch["patch_embeds"] = r.standard_normal(
            (2, jcfg.num_patches, jcfg.d_model)).astype(np.float32)
    want = jm.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()}, JRT)
    got = tm.forward(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                     TRT)
    _close(got, want, rtol=2e-4, atol=2e-4)


def test_build_model_builds_every_arch():
    """`build_model` gives the encoder-decoder an `EncDecLM`
    (`tests/test_torch_encdec.py`) and every other arch a `DecoderLM`
    (xLSTM's blocks included, `tests/test_torch_xlstm.py`); the
    encoder-decoder's training loss is the reference's
    (`tests/test_torch_train.py` holds its gradients too)."""
    from repro.launch.steps import build_model as jbuild
    from repro_torch.convert import encdec_params_from_numpy
    from repro_torch.launch.steps import build_model
    from repro_torch.models.encdec import EncDecLM
    assert "mlstm" in tlm.DecoderLM(
        tconfigs.get_smoke("xlstm-1.3b")).param_specs()["layers"][0]
    tcfg = tconfigs.get_smoke("whisper-medium")
    model = build_model(tcfg)
    assert isinstance(model, EncDecLM)
    assert isinstance(build_model(tconfigs.get_smoke("qwen2-0.5b")),
                      tlm.DecoderLM)
    jm = jbuild(jconfigs.get_smoke("whisper-medium"))
    jp = jm.init(jax.random.PRNGKey(0), JRT)
    r = _rng(12)
    batch = {"tokens": r.integers(0, tcfg.vocab_size, (2, 9)),
             "frames": r.standard_normal(
                 (2, tcfg.encoder_seq, tcfg.d_model)).astype(np.float32)}
    want = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}, JRT)
    got = model.loss(encdec_params_from_numpy(tcfg, jax.tree.map(
        np.asarray, jp)), {k: torch.from_numpy(v) for k, v in
                           batch.items()}, TRT)
    assert got.dim() == 0 and got.dtype == torch.float32
    assert abs(float(got) / float(want) - 1) <= 1e-5
