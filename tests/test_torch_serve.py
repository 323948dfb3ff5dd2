"""The port's serving path against the JAX package, on the CPU: qwen2-0.5b's
smoke config with fp32 compute and the reference's own initialised
weights, carried across by `decoder_params_from_numpy`.

Tolerances: forward and prefill logits 2e-4 (the same fp32 arithmetic in
another summation order, through two layers); forward against decode
within the port rtol 2e-2 / atol 5e-3, as `tests/test_decode_parity.py`
(the decode path keeps K and V in a bf16 cache); served tokens exactly."""

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

NAME = "qwen2-0.5b"
JRT = JRuntime(compute_dtype=jnp.float32)
TRT = TRuntime(compute_dtype=torch.float32)
TOL = dict(rtol=2e-4, atol=2e-4)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9]]          # tests/test_system.py


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jconfigs.get_smoke(NAME), tconfigs.get_smoke(NAME)
    jm = jsteps.build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0), JRT)
    tp = decoder_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp))
    return jcfg, jm, jp, tcfg, tsteps.build_model(tcfg), tp


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def test_converted_params_have_the_ports_layout(models):
    _, _, _, tcfg, tm, tp = models
    fresh = tm.init(torch.Generator().manual_seed(0), TRT)
    assert len(tp["layers"]) == tcfg.num_layers
    flat = jax.tree_util.tree_leaves_with_path
    assert [(k, v.shape, v.dtype) for k, v in flat(tp)] == \
        [(k, v.shape, v.dtype) for k, v in flat(fresh)]


@pytest.mark.parametrize("kernels", [False, True])
def test_forward_logits_match_the_reference(models, kernels):
    jcfg, jm, jp, _, tm, tp = models
    tok = _tokens(jcfg, 2, 12)
    want = jm.forward(jp, {"tokens": jnp.asarray(tok)},
                      dataclasses.replace(JRT, use_pallas=kernels))
    got = tm.forward(tp, {"tokens": torch.from_numpy(tok)},
                     dataclasses.replace(TRT, use_kernels=kernels))
    assert got.shape == want.shape == (2, 12, tm.v_pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_step_last_logits_match_the_reference(models):
    jcfg, jm, jp, _, tm, tp = models
    tok = _tokens(jcfg, 3, 17, seed=1)
    want = jsteps.make_prefill_step(jm, JRT)(jp, {"tokens": jnp.asarray(tok)})
    rt = dataclasses.replace(TRT, use_kernels=True)
    got = tsteps.make_prefill_step(tm, rt)(tp,
                                          {"tokens": torch.from_numpy(tok)})
    assert got.shape == (3, tm.v_pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_steps_match_the_reference(models):
    jcfg, jm, jp, _, tm, tp = models
    tok = _tokens(jcfg, 2, 6, seed=2)
    jc = jm.init_cache(2, 16, JRT)
    tc = tm.init_cache(2, 16, TRT)
    step = tsteps.make_serve_step(tm, TRT)
    for t in range(tok.shape[1]):
        want, jc = jm.decode_step(jp, jc, jnp.asarray(tok[:, t:t + 1]),
                                  jnp.int32(t), JRT)
        got, tc = step(tp, tc, torch.from_numpy(tok[:, t:t + 1]),
                       torch.tensor(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_vs_decode_parity(models):
    _, _, _, tcfg, tm, tp = models
    tok = torch.from_numpy(_tokens(tcfg, 2, 12, seed=7))
    full = tm.forward(tp, {"tokens": tok}, TRT)
    cache = tm.init_cache(2, 32, TRT)
    steps = []
    for t in range(tok.shape[1]):
        lg, cache = tm.decode_step(tp, cache, tok[:, t:t + 1],
                                   torch.tensor(t), TRT)
        steps.append(lg[:, 0])
    v = tcfg.vocab_size
    np.testing.assert_allclose(torch.stack(steps, 1)[..., :v].numpy(),
                               full[..., :v].numpy(), rtol=2e-2, atol=5e-3)


def test_serve_requests_generate_the_references_tokens(models):
    jcfg, _, _, tcfg, _, tp = models
    want = jserve.serve_requests(jcfg, PROMPTS, batch=2, max_new=5,
                                 max_len=64)
    got = tserve.serve_requests(tcfg, PROMPTS, batch=2, max_new=5,
                                max_len=64, device="cpu", params=tp)
    assert [r.request_id for r in got] == [0, 1, 2]
    assert [r.prompt for r in got] == PROMPTS
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(len(r.generated) == 5 and r.latency_s > 0 for r in got)


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
    dec = tsteps.input_specs(cfg, tconfigs.shape_by_name("decode_32k"))
    assert dec["token"] == ((128, 1), torch.int64)
    rt = tsteps.make_runtime(cfg, pre, use_kernels=True)
    assert rt.param_dtype == torch.bfloat16 and rt.use_kernels
    train = tsteps.make_runtime(cfg, tconfigs.shape_by_name("train_4k"))
    assert train.param_dtype == torch.float32 and not train.use_kernels
    wcfg = tconfigs.get_arch("whisper-medium")
    assert tsteps.input_specs(wcfg, pre) == {
        "frames": ((32, 1500, 1024), torch.bfloat16),
        "tokens": ((32, 32768), torch.int64)}


def test_serve_cli_serves_whisper_on_the_cpu(capsys):
    """The CLI serves the encoder-decoder's smoke model through
    `EncDecLM`."""
    tserve.main(["--arch", "whisper-medium", "--smoke", "--device", "cpu",
                 "--requests", "3", "--batch", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 12 tokens" in out


def test_serve_refuses_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.serve_requests(tconfigs.get_smoke(NAME), PROMPTS, device="cuda")
