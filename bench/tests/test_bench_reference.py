"""The plain references compute the served function: at test widths, in
float32, they agree with the port's own forward run in float32 on the
same weights, capacity drops included; and their capacity rule is the
one stated."""

import json

import pytest
import torch

from _tiny import DATA, TINY

from bench import harness, spec
from bench.reference import _common


def _cell(config):
    cfg = json.loads((DATA / f"{config}.json").read_text())
    ref = spec.load_module(spec.ROOT / "bench" / "reference"
                           / f"{cfg['reference']}.py", cfg["reference"])
    return spec.Cell(name="t", chips=1, config=cfg,
                     traffic={"name": "t", "batch": 2, "seq": 64}, limits={},
                     reference=ref, end_to_end=[], per_layer=[], readers={})


@pytest.mark.parametrize("config", list(TINY))
@pytest.mark.parametrize("seed", [1, 2])
def test_reference_equals_port_in_fp32(config, seed):
    from repro_torch.launch.steps import build_model, make_prefill_step
    from repro_torch.models.layers import Runtime
    cell = _cell(config)
    cfg = cell.config
    arch = harness.port_arch(cfg)
    model = build_model(arch)
    gen = torch.Generator().manual_seed(seed)
    params = harness.make_params(model.param_specs(), gen, torch.bfloat16)
    tokens = torch.randint(0, cfg["vocab_size"], (2, 64), generator=gen)
    rt = Runtime(compute_dtype=torch.float32, param_dtype=torch.float32,
                 moe_group_size=cfg["moe_group_size"])
    p32 = _common.upcast(params)
    port = make_prefill_step(model, rt)(p32, {"tokens": tokens})
    kept = []
    ref = cell.reference.last_logits(cfg, params, tokens, kept=kept)
    routed = 2 * 64 * cfg["num_experts_per_tok"] * (
        cfg["num_hidden_layers"] - cfg.get("first_k_dense_replace", 0))
    assert sum(kept) < routed              # some pairs were dropped
    got = port[:, :cfg["vocab_size"]]
    assert torch.allclose(got, ref, rtol=1e-4, atol=1e-5 * ref.abs().max())


@pytest.mark.parametrize("factor", [1, 40])
def test_deepseek_rope_scaling_is_plain_rope_or_refused(factor):
    """YaRN at factor 1 is plain RoPE, so the reference gives the logits of
    `rope_scaling` null; a larger factor, which it does not compute, is
    refused."""
    from repro_torch.launch.steps import build_model
    cell = _cell("deepseek-tiny")
    cfg, ref = cell.config, cell.reference
    gen = torch.Generator().manual_seed(3)
    model = build_model(harness.port_arch(cfg))
    params = harness.make_params(model.param_specs(), gen, torch.bfloat16)
    tokens = torch.randint(0, cfg["vocab_size"], (1, 32), generator=gen)
    yarn = dict(cfg, rope_scaling={
        "beta_fast": 32, "beta_slow": 1, "factor": factor, "mscale": 0.707,
        "mscale_all_dim": 0.707, "original_max_position_embeddings": 16,
        "type": "yarn"})
    if factor != 1:
        with pytest.raises(ValueError, match="rope_scaling factor"):
            ref.last_logits(yarn, params, tokens)
        return
    assert torch.equal(ref.last_logits(yarn, params, tokens),
                       ref.last_logits(cfg, params, tokens))


def test_capacity_rule():
    assert _common.capacity(4096, 8, 64, 1.25) == 640
    assert _common.capacity(4096, 6, 64, 1.25) == 480
    assert _common.capacity(64, 2, 8, 1.25) == 24
    assert _common.capacity(8, 1, 64, 1.25) == 8


def test_moe_keeps_each_experts_first_pairs_in_token_order():
    """Against a loop over the pairs: each expert keeps its first `cap`
    (token, choice) pairs in token order."""
    g = torch.Generator().manual_seed(3)
    d, n_exp, top_k, n_tok = 8, 4, 2, 32
    p = {"router": torch.randn(d, n_exp, generator=g),
         "we1": torch.randn(n_exp, d, 6, generator=g),
         "we3": torch.randn(n_exp, d, 6, generator=g),
         "we2": torch.randn(n_exp, 6, d, generator=g)}
    x = torch.randn(n_tok, d, generator=g)
    x[:, 0] += 3.0                 # a skewed router: drops are certain
    kept = []
    got = _common.moe(x, p, top_k=top_k, normalize=True, group_size=16,
                      factor=1.0, r=lambda t: t, kept=kept)
    probs = torch.softmax(x @ p["router"], -1)
    gate, expert = torch.topk(probs, top_k, -1)
    gate = gate / gate.sum(-1, keepdim=True)
    cap = _common.capacity(16, top_k, n_exp, 1.0)
    want = torch.zeros_like(x)
    n_kept = []
    for g0 in (0, 16):
        seen = [0] * n_exp
        n_kept.append(0)
        for t in range(g0, g0 + 16):
            for j in range(top_k):
                e = int(expert[t, j])
                seen[e] += 1
                if seen[e] > cap:
                    continue
                n_kept[-1] += 1
                h = torch.nn.functional.silu(x[t] @ p["we1"][e]) \
                    * (x[t] @ p["we3"][e])
                want[t] += gate[t, j] * (h @ p["we2"][e])
    assert kept == n_kept and sum(kept) < n_tok * top_k
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
