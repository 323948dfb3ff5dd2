"""The port's recurrentgemma-9b (the Griffin hybrid: RG-LRU and
local-attention layers) against the JAX package, on the CPU: the smoke
config with fp32 compute and the reference's own initialised weights,
carried across by `decoder_params_from_numpy`.

Tolerances: forward, prefill and decode logits 2e-4 (the same fp32
arithmetic in another summation order, through four layers); forward
against decode within the port rtol/atol 3e-3, as the window case of
`tests/test_decode_parity.py` (the decode path keeps K and V in a bf16
cache); served tokens exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models.layers import Runtime as JRuntime
from repro_torch import configs as tconfigs
from repro_torch.convert import decoder_params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models.layers import Runtime as TRuntime

NAME = "recurrentgemma-9b"
JRT = JRuntime(compute_dtype=jnp.float32)
TRT = TRuntime(compute_dtype=torch.float32)
TOL = dict(rtol=2e-4, atol=2e-4)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9]]


def _pair(num_layers=None, seed=0):
    jcfg, tcfg = jconfigs.get_smoke(NAME), tconfigs.get_smoke(NAME)
    if num_layers is not None:
        jcfg = dataclasses.replace(jcfg, num_layers=num_layers)
        tcfg = dataclasses.replace(tcfg, num_layers=num_layers)
    jm = jsteps.build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed), JRT)
    tp = decoder_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp))
    return jcfg, jm, jp, tcfg, tsteps.build_model(tcfg), tp


@pytest.fixture(scope="module")
def models():
    return _pair()


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _layout(tree):
    return [(k, v.shape, v.dtype)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("num_layers,kinds", [
    (4, ["rglru", "rglru", "local_attn", "rglru"]),
    (7, ["rglru", "rglru", "local_attn"] * 2 + ["rglru"])])
def test_converted_params_have_the_ports_layout(num_layers, kinds):
    """4 layers: two groups of one repeat; 7 layers: the unit repeats
    twice, so the reference stacks its leaves and the converter slices
    them, one dict per layer."""
    jcfg, jm, jp, tcfg, tm, tp = _pair(num_layers)
    assert tm.kinds == kinds
    assert [g.repeats for g in jm.groups] == \
        ([1, 1] if num_layers == 4 else [2, 1])
    fresh = tm.init(torch.Generator().manual_seed(0), TRT)
    assert _layout(tp) == _layout(fresh)
    rg = tp["layers"][3]["rglru"]
    assert rg["wa"].shape == rg["wi"].shape == (4, 16, 16)
    assert rg["conv_w"].shape == (4, 64) and rg["a_param"].shape == (64,)
    if num_layers == 7:    # layer 3 is repeat 1 of the stacked group's unit 0
        np.testing.assert_array_equal(
            rg["wa"].numpy(), np.asarray(jp["groups"][0][0]["rglru"]["wa"][1]))


@pytest.mark.parametrize("num_layers", [4, 7])
@pytest.mark.parametrize("kernels", [False, True])
def test_forward_logits_match_the_reference(num_layers, kernels):
    """S 37 > local window 16: the local layers take local-block
    attention, the RG-LRU layers the scan (its kernel wrapper under
    `use_kernels`)."""
    jcfg, jm, jp, _, tm, tp = _pair(num_layers)
    tok = _tokens(jcfg, 2, 37)
    want = jm.forward(jp, {"tokens": jnp.asarray(tok)},
                      dataclasses.replace(JRT, use_pallas=kernels))
    got = tm.forward(tp, {"tokens": torch.from_numpy(tok)},
                     dataclasses.replace(TRT, use_kernels=kernels))
    assert got.shape == want.shape == (2, 37, tm.v_pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seq", [12, 29])
def test_prefill_step_last_logits_match_the_reference(models, seq):
    """Within the window (flash's path under kernels) and beyond it."""
    jcfg, jm, jp, _, tm, tp = models
    tok = _tokens(jcfg, 3, seq, seed=1)
    want = jsteps.make_prefill_step(jm, JRT)(jp, {"tokens": jnp.asarray(tok)})
    rt = dataclasses.replace(TRT, use_kernels=True)
    got = tsteps.make_prefill_step(tm, rt)(tp,
                                          {"tokens": torch.from_numpy(tok)})
    assert got.shape == (3, tm.v_pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_cache_dtypes_and_ring_size(models):
    _, _, _, tcfg, tm, _ = models
    cache = tm.init_cache(2, 40, TRT)
    assert [sorted(c) for c in cache] == [["conv", "h"], ["conv", "h"],
                                         ["k", "v"], ["conv", "h"]]
    assert cache[0]["h"].shape == (2, 64) and \
        cache[0]["conv"].shape == (2, 3, 64)
    assert cache[0]["h"].dtype == cache[0]["conv"].dtype == torch.float32
    # local attention keeps min(local_window, max_len) slots, in bf16
    assert cache[2]["k"].shape == (2, 16, 1, 16)
    assert cache[2]["k"].dtype == torch.bfloat16
    assert tm.init_cache(1, 8, TRT)[2]["v"].shape == (1, 8, 1, 16)


def test_decode_steps_match_the_reference(models):
    """20 steps against a 16-slot ring: the window wraps."""
    jcfg, jm, jp, _, tm, tp = models
    tok = _tokens(jcfg, 2, 20, seed=2)
    jc = jm.init_cache(2, 32, JRT)
    tc = tm.init_cache(2, 32, TRT)
    step = tsteps.make_serve_step(tm, TRT)
    for t in range(tok.shape[1]):
        want, jc = jm.decode_step(jp, jc, jnp.asarray(tok[:, t:t + 1]),
                                  jnp.int32(t), JRT)
        got, tc = step(tp, tc, torch.from_numpy(tok[:, t:t + 1]),
                       torch.tensor(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_vs_decode_across_the_window(models):
    """S 24 > local window 16, so decode runs the ring buffer
    (tests/test_decode_parity.py:54-74)."""
    _, _, _, tcfg, tm, tp = models
    tok = torch.from_numpy(_tokens(tcfg, 1, 24, seed=7))
    full = tm.forward(tp, {"tokens": tok}, TRT)
    cache = tm.init_cache(1, 24, TRT)
    steps = []
    for t in range(tok.shape[1]):
        lg, cache = tm.decode_step(tp, cache, tok[:, t:t + 1],
                                   torch.tensor(t), TRT)
        steps.append(lg[:, 0])
    v = tcfg.vocab_size
    np.testing.assert_allclose(torch.stack(steps, 1)[..., :v].numpy(),
                               full[..., :v].numpy(), rtol=3e-3, atol=3e-3)


def test_serve_requests_generate_the_references_tokens(models):
    jcfg, _, _, tcfg, _, tp = models
    want = jserve.serve_requests(jcfg, PROMPTS, batch=2, max_new=5,
                                 max_len=64)
    got = tserve.serve_requests(tcfg, PROMPTS, batch=2, max_new=5,
                                max_len=64, device="cpu", params=tp)
    assert [r.prompt for r in got] == PROMPTS
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(len(r.generated) == 5 for r in got)


def test_serve_cli_on_the_cpu(capsys):
    tserve.main(["--arch", NAME, "--smoke", "--device", "cpu",
                 "--requests", "3", "--batch", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 12 tokens" in out


def test_input_specs_and_runtime_of_the_serving_cells():
    cfg = tconfigs.get_arch(NAME)
    pre = tconfigs.shape_by_name("prefill_32k")
    assert tsteps.input_specs(cfg, pre) == {
        "tokens": ((32, 32768), torch.int64)}
    rt = tsteps.make_runtime(cfg, pre, use_kernels=True)
    assert rt.param_dtype == torch.bfloat16 and rt.use_kernels
    model = tsteps.build_model(cfg)
    assert model.kinds.count("rglru") == 26
    assert model.kinds.count("local_attn") == 12
