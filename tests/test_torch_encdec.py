"""whisper-medium's encoder-decoder (`repro_torch.models.encdec`), its
layers, `blocked_attention`'s window / query offset / cache length and the
f8 KV cache, against the JAX package on the CPU.

Inputs come from numpy with a seed (the f8 decode's from the reference's
key) and go through both packages at smoke size (`get_smoke`: 2 + 2
layers, d 64) in fp32.  Layers agree to 1e-5, the model to the 2e-4 of
`tests/test_torch_models.py`'s forwards, the bf16 caches within one bf16
rounding, and the forward-vs-decode parity to the reference's own
tolerances (`tests/test_decode_parity.py`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import encdec as jencdec
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.convert import (decoder_params_from_numpy,
                                 encdec_params_from_numpy, tree_from_numpy)
from repro_torch.launch import serve as tserve
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm

NAME = "whisper-medium"
JRT = JL.Runtime(compute_dtype=jnp.float32)
TRT = TL.Runtime(compute_dtype=torch.float32)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_ROUNDING = dict(rtol=2 ** -7, atol=1e-6)     # one bf16 rounding apart
PARITY_TOL = dict(rtol=2e-2, atol=5e-3)           # tests/test_decode_parity


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or LAYER_TOL))


def _bf16_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_the_reference(dtype):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = _rng(0).standard_normal((2, 7, 64)).astype(np.float32) * 3 + 1
    s, b = _rng(1).standard_normal(64), _rng(2).standard_normal(64)
    want = JL.layer_norm(jnp.asarray(x, jd), jnp.asarray(s, jnp.float32),
                         jnp.asarray(b, jnp.float32), 1e-5)
    got = TL.layer_norm(torch.from_numpy(x).to(td),
                        torch.tensor(s, dtype=torch.float32),
                        torch.tensor(b, dtype=torch.float32), 1e-5)
    assert got.dtype == td
    if dtype == "float32":
        _close(got, want)
    else:       # the same fp32 value rounded to bf16: at most one rounding
        _close(got, np.asarray(want, np.float32), **BF16_ROUNDING)


def test_gelu_mlp_matches_the_reference():
    d, f = 64, 128
    r = _rng(3)
    p = {"w1": r.standard_normal((d, f)) * 0.1, "b1": r.standard_normal(f),
         "w2": r.standard_normal((f, d)) * 0.1, "b2": r.standard_normal(d)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = r.standard_normal((2, 5, d)).astype(np.float32)
    want = JL.gelu_mlp({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), JRT)
    got = TL.gelu_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x), TRT)
    _close(got, want)
    assert TL.gelu_mlp_specs(d, f) == {
        k: TL.Spec(v.shape, v.axes, v.init, v.dtype)
        for k, v in JL.gelu_mlp_specs(d, f).items()}


# (Sq, Skv, causal, window, q_offset, kv_len, kv_block): every mask alone
# and together; kv_len 5 with blocks of 4 leaves the third block fully
# masked, and window 3 at q_offset 20 fully masks the first blocks
MASK_CASES = [
    (6, 16, True, 0, 10, None, 4),
    (6, 16, True, 3, 10, None, 4),
    (1, 12, False, 0, 0, 5, 4),
    (3, 12, True, 3, 4, 7, 4),
    (5, 23, False, 0, 0, 9, 8),
    (4, 24, True, 3, 20, 22, 4),
    (1, 16, False, 0, 0, 16, 1024),
]


@pytest.mark.parametrize("case", MASK_CASES, ids=str)
def test_blocked_attention_masks_match_the_reference(case):
    sq, skv, causal, window, q_offset, kv_len, kv_block = case
    r = _rng(4)
    q = r.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = r.standard_normal((2, skv, 2, 16)).astype(np.float32)
    v = r.standard_normal((2, skv, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_block=kv_block)
    want = JL.blocked_attention(
        *map(jnp.asarray, (q, k, v)), **kw,
        kv_len=None if kv_len is None else jnp.int32(kv_len))
    got = TL.blocked_attention(
        *map(torch.from_numpy, (q, k, v)), **kw,
        kv_len=None if kv_len is None else torch.tensor(kv_len))
    _close(got, want)


def test_blocked_attention_masks_that_mask_nothing_change_nothing():
    """The defaults leave every existing caller as it was: a `kv_len` of
    the whole cache, a window past it and a zero offset give the default
    call's output bit for bit."""
    r = _rng(5)
    q, k, v = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
               for s in ((2, 9, 4, 16), (2, 9, 2, 16), (2, 9, 2, 16)))
    for causal in (True, False):
        base = TL.blocked_attention(q, k, v, causal=causal, kv_block=4)
        same = TL.blocked_attention(q, k, v, causal=causal, kv_block=4,
                                    window=64, q_offset=0,
                                    kv_len=torch.tensor(9))
        assert torch.equal(base, same)


# ------------------------------------------------------------------- model

@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jconfigs.get_smoke(NAME), tconfigs.get_smoke(NAME)
    jm, tm = jencdec.EncDecLM(jcfg), tencdec.EncDecLM(tcfg)
    jp = jm.init(jax.random.PRNGKey(0), JRT)
    tp = encdec_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp))
    return jcfg, jm, jp, tcfg, tm, tp


def _inputs(cfg, B=2, S=9, seed=0):
    r = _rng(seed)
    frames = r.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    tokens = r.integers(0, cfg.vocab_size, (B, S))
    return frames, tokens


def test_params_and_caches_have_the_references_layout(models):
    jcfg, jm, jp, tcfg, tm, tp = models
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tp))[0])
    assert len(want) == len(got)
    for path, leaf in want:
        assert got[path].shape == leaf.shape
    jc, tc = jm.cache_specs(2, 16), tm.cache_specs(2, 16)
    assert set(tc) == set(jc) == {"k", "v", "xk", "xv"}
    for key in jc:
        assert tc[key].shape == jc[key].shape
        assert tc[key].axes == jc[key].axes
    cache = tm.init_cache(2, 16, TRT)
    assert all(c.dtype == torch.bfloat16 and not c.any()
               for c in cache.values())


def test_encode_matches_the_reference(models):
    jcfg, jm, jp, tcfg, tm, tp = models
    frames, _ = _inputs(tcfg)
    want = jm.encode(jp, jnp.asarray(frames), JRT)
    got = tm.encode(tp, torch.from_numpy(frames), TRT)
    _close(got, want, **MODEL_TOL)


@pytest.mark.parametrize("last_only", [False, True])
def test_forward_matches_the_reference(models, last_only):
    jcfg, jm, jp, tcfg, tm, tp = models
    frames, tokens = _inputs(tcfg)
    want = jm.forward(jp, {"frames": jnp.asarray(frames),
                           "tokens": jnp.asarray(tokens, jnp.int32)}, JRT,
                      last_only=last_only)
    got = tm.forward(tp, {"frames": torch.from_numpy(frames),
                          "tokens": torch.from_numpy(tokens)}, TRT,
                     last_only=last_only)
    assert tuple(got.shape) == want.shape
    _close(got, want, **MODEL_TOL)


def _ref_filled_cache(jm, jp, frames, B, max_len):
    """The reference's cache with its cross caches filled from its
    encoder: each layer's `xattn` k and v projections of `encode(frames)`,
    in the cache's bf16."""
    cfg = jm.cfg
    enc = jm.encode(jp, frames, JRT)
    hd = cfg.resolved_head_dim
    xa = jp["decoder"]["xattn"]
    cache = jm.init_cache(B, max_len, JRT)
    for key, w, b in (("xk", "wk", "bk"), ("xv", "wv", "bv")):
        cache[key] = jnp.stack([
            jencdec._proj(enc, xa[w][i], xa[b][i], cfg.num_kv_heads, hd,
                          JRT).astype(jnp.bfloat16)
            for i in range(cfg.num_layers)])
    return cache


def _port_filled_cache(tm, tp, frames, B, max_len):
    """The port's counterpart of `_ref_filled_cache`."""
    cfg = tm.cfg
    enc = tm.encode(tp, frames, TRT)
    hd = cfg.resolved_head_dim
    xa = tp["decoder"]["xattn"]
    cache = tm.init_cache(B, max_len, TRT)
    for key, w, b in (("xk", "wk", "bk"), ("xv", "wv", "bv")):
        cache[key] = torch.stack([
            tencdec._proj(enc, xa[w][i], xa[b][i], cfg.num_kv_heads, hd,
                          TRT).to(torch.bfloat16)
            for i in range(cfg.num_layers)])
    return cache


@pytest.mark.parametrize("cross", ["zero", "filled"])
def test_decode_steps_match_the_reference(models, cross):
    """Logits and the returned caches step by step: with the reference's
    zeroed cross caches (its server's) and with cross caches filled from
    the encoder (the same bf16 numbers handed to both)."""
    jcfg, jm, jp, tcfg, tm, tp = models
    frames, tokens = _inputs(tcfg, S=6)
    B, max_len = 2, 16
    if cross == "zero":
        jc, tc = jm.init_cache(B, max_len, JRT), tm.init_cache(B, max_len,
                                                               TRT)
    else:
        jc = _ref_filled_cache(jm, jp, jnp.asarray(frames), B, max_len)
        tc = tree_from_numpy(jax.tree.map(np.asarray, jc))
        assert bool(tc["xk"].any())
    for pos in range(tokens.shape[1]):
        tok = tokens[:, pos:pos + 1]
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok, jnp.int32),
                                jnp.int32(pos), JRT)
        tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                 torch.tensor(pos), TRT)
        assert tl.dtype == torch.float32
        _close(tl, jl, **MODEL_TOL)
        # k and v are written in place; the cross caches pass through
        assert all(tc2[k] is tc[k] for k in tc)
    for key in ("k", "v"):
        _close(tc[key], np.asarray(jc[key], np.float32), **BF16_ROUNDING)
    for key in ("xk", "xv"):
        np.testing.assert_array_equal(_bf16_np(tc[key]),
                                      np.asarray(jc[key], np.float32))


def test_forward_vs_decode_parity_with_filled_cross_caches(models):
    """The decode loop over cross caches filled from `encode(frames)`
    gives the forward's logits over the same frames and tokens, at the
    reference's parity tolerances; the reference holds it too."""
    jcfg, jm, jp, tcfg, tm, tp = models
    frames, tokens = _inputs(tcfg, S=12, seed=7)
    B, S, v = 2, 12, tcfg.vocab_size
    full = tm.forward(tp, {"frames": torch.from_numpy(frames),
                           "tokens": torch.from_numpy(tokens)}, TRT)
    cache = _port_filled_cache(tm, tp, torch.from_numpy(frames), B, 32)
    steps = []
    for t in range(S):
        lg, cache = tm.decode_step(tp, cache,
                                   torch.from_numpy(tokens[:, t:t + 1]),
                                   torch.tensor(t), TRT)
        steps.append(lg[:, 0])
    dec = torch.stack(steps, 1)
    _close(dec[..., :v], full[..., :v].numpy(), **PARITY_TOL)

    jfull = jm.forward(jp, {"frames": jnp.asarray(frames),
                            "tokens": jnp.asarray(tokens, jnp.int32)}, JRT)
    jc = _ref_filled_cache(jm, jp, jnp.asarray(frames), B, 32)
    jsteps = []
    for t in range(S):
        lg, jc = jm.decode_step(jp, jc, jnp.asarray(tokens[:, t:t + 1],
                                                    jnp.int32),
                                jnp.int32(t), JRT)
        jsteps.append(np.asarray(lg[:, 0]))
    np.testing.assert_allclose(np.stack(jsteps, 1)[..., :v],
                               np.asarray(jfull)[..., :v], **PARITY_TOL)


def test_served_tokens_are_the_references():
    """`serve_requests` through `EncDecLM` (zeroed cross caches, as the
    reference's server) on the reference's weights."""
    prompts = [[3, 17, 42, 9], [5, 11], [100, 200, 300, 7, 8]]
    want = jserve.serve_requests(jconfigs.get_smoke(NAME), prompts,
                                 batch=2, max_new=5, max_len=32)
    cfg = tconfigs.get_smoke(NAME)
    jp = jencdec.EncDecLM(jconfigs.get_smoke(NAME)).init(
        jax.random.PRNGKey(0), JRT)
    tp = encdec_params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
    got = tserve.serve_requests(cfg, prompts, batch=2, max_new=5,
                                max_len=32, device="cpu", params=tp)
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(len(r.generated) == 5 for r in got)


def test_convert_checks_the_stacks_depth(models):
    jcfg, jm, jp, tcfg, tm, tp = models
    tree = jax.tree.map(np.asarray, jp)
    with pytest.raises(ValueError, match="decoder"):
        encdec_params_from_numpy(
            dataclasses.replace(tcfg, num_layers=3), tree)


# ---------------------------------------------------------------- f8 cache

def test_init_cache_under_f8_makes_the_kv_leaves_f8():
    """Every leaf whose spec says bf16 becomes f8 e4m3fn; recurrent state
    keeps its fp32; an unknown kv_dtype raises."""
    f8 = TL.Runtime(compute_dtype=torch.float32, kv_dtype="f8")
    rg = tlm.DecoderLM(tconfigs.get_smoke("recurrentgemma-9b"))
    for layer, specs in zip(rg.init_cache(1, 8, f8), rg.cache_specs(1, 8)):
        for key, t in layer.items():
            assert t.dtype == (torch.float8_e4m3fn if specs[key].dtype ==
                               "bf16" else torch.float32)
    assert {t.dtype for layer in rg.init_cache(1, 8, f8)
            for t in layer.values()} == {torch.float8_e4m3fn, torch.float32}
    wh = tencdec.EncDecLM(tconfigs.get_smoke(NAME))
    assert {t.dtype for t in wh.init_cache(1, 8, f8).values()} == {
        torch.float8_e4m3fn}
    with pytest.raises(ValueError, match="kv_dtype"):
        rg.init_cache(1, 8, TL.Runtime(kv_dtype="int4"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_f8_cache_write_is_bit_equal_to_the_references_cast(dtype):
    """The write through `uint8` views puts `jnp.astype(float8_e4m3fn)`'s
    bits in the slot, over rounding ties, subnormals, the e4m3 range's
    end and past it (XLA's NaN, where torch's own cast saturates), and
    leaves every other slot as it was."""
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    r = _rng(6)
    vals = np.concatenate([
        r.standard_normal(220) * 4, r.standard_normal(100) * 1e-2,
        r.standard_normal(50) * 300,
        [0.0, -0.0, 2 ** -10, 3 * 2 ** -11, 1.0625, 1.1875, 448, 464, 465,
         -465, 500, 1e5, np.inf, -np.inf]]).astype(np.float32)
    new = vals[: 2 * 3 * 64].reshape(2, 1, 3, 64)
    want = np.asarray(jax.jit(lambda a: a.astype(jnp.float8_e4m3fn))(
        jnp.asarray(new, jd))).view(np.uint8)
    init = r.integers(0, 120, (2, 5, 3, 64)).astype(np.uint8)
    cache = torch.from_numpy(init.copy()).view(torch.float8_e4m3fn)
    out = TL.kv_cache_write(cache, torch.from_numpy(new).to(td),
                            torch.tensor(3))
    assert out is cache and cache.dtype == torch.float8_e4m3fn
    bits = cache.view(torch.uint8).numpy()
    np.testing.assert_array_equal(bits[:, 3:4], want)
    np.testing.assert_array_equal(np.delete(bits, 3, axis=1),
                                  np.delete(init, 3, axis=1))


def test_f8_decode_matches_the_reference():
    """qwen2.5-32b's smoke decode over an f8 KV cache (the reference's
    dry-run cache: every bf16 leaf f8), fp32 compute, a few steps from the
    reference's key: logits within 2e-4 (the attention weights rounded to
    f8, as the reference's `p.astype(v.dtype)` rounds them), every cache
    byte equal, layer by layer."""
    name = "qwen2.5-32b"
    jcfg, tcfg = jconfigs.get_smoke(name), tconfigs.get_smoke(name)
    jrt = JL.Runtime(compute_dtype=jnp.float32, kv_dtype="f8")
    trt = TL.Runtime(compute_dtype=torch.float32, kv_dtype="f8")
    jm, tm = jlm.DecoderLM(jcfg), tlm.DecoderLM(tcfg)
    key = jax.random.PRNGKey(7)
    jp = jm.init(key, jrt)
    tp = decoder_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp))
    B, S, max_len = 2, 6, 16
    tokens = np.array(jax.random.randint(key, (B, S), 0, jcfg.vocab_size))
    jc = jax.tree.map(
        lambda s: jnp.zeros(s.shape, jnp.float8_e4m3fn if s.dtype == "bf16"
                            else s.resolved_dtype(jnp.bfloat16)),
        jm.cache_specs(B, max_len), is_leaf=lambda x: isinstance(x, JL.Spec))
    tc = tm.init_cache(B, max_len, trt)
    for pos in range(S):
        tok = tokens[:, pos:pos + 1]
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok, jnp.int32),
                                jnp.int32(pos), jrt)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                torch.tensor(pos), trt)
        _close(tl, jl, **MODEL_TOL)
    # the reference's decode cache is a list of one-unit layers
    assert len(jc) == len(tc)
    for jlayer, tlayer in zip(jc, tc):
        for key, t in tlayer.items():
            assert t.dtype == torch.float8_e4m3fn
            np.testing.assert_array_equal(
                t.view(torch.uint8).numpy(),
                np.asarray(jlayer[0][key]).view(np.uint8))
