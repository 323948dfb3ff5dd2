"""`bench/flops.py` equals `torch.utils.flop_counter.FlopCounterMode` over
the plain references' products at test widths, for both attention kinds
(multi-head and latent) and both expert layouts."""

import functools
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _tiny import DATA, TINY

from bench import flops, spec
from bench.reference import _common


def _params(cell):
    from bench import harness
    model, _ = harness.build_step(cell)
    gen = torch.Generator().manual_seed(5)
    return harness.make_params(model.param_specs(), gen, torch.bfloat16)


@pytest.mark.parametrize("config", list(TINY))
@pytest.mark.parametrize("batch,seq", [(1, 24), (2, 40)])
def test_prefill_flops_equal_counted(config, batch, seq, monkeypatch):
    cfg = json.loads((DATA / f"{config}.json").read_text())
    ref = spec.load_module(spec.ROOT / "bench" / "reference"
                           / f"{cfg['reference']}.py", cfg["reference"])
    cell = spec.Cell(name="t", chips=1, config=cfg,
                     traffic={"name": "t", "batch": batch, "seq": seq},
                     limits={}, reference=ref, end_to_end=[], per_layer=[],
                     readers={})
    params = _params(cell)
    # one query a block: the reference multiplies exactly the causal pairs
    monkeypatch.setattr(ref, "causal_attention", functools.partial(
        _common.causal_attention, q_block=1))
    tokens = torch.randint(0, cfg["vocab_size"], (batch, seq),
                           generator=torch.Generator().manual_seed(6))
    kept = []
    with FlopCounterMode(display=False) as counter:
        ref.last_logits(cfg, params, tokens, kept=kept)
    want = flops.prefill_flops(cfg, batch, seq, pairs=sum(kept))
    assert counter.get_total_flops() == want["total"]


@pytest.mark.parametrize("config", list(TINY))
def test_attention_core_equals_counted(config):
    cfg = json.loads((DATA / f"{config}.json").read_text())
    h = cfg["num_attention_heads"]
    if cfg.get("kv_lora_rank"):
        dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
        dv = cfg["v_head_dim"]
    else:
        dqk = dv = cfg["hidden_size"] // h
    b, s = 2, 33
    q, k = torch.randn(b, s, h, dqk), torch.randn(b, s, h, dqk)
    v = torch.randn(b, s, h, dv)
    with FlopCounterMode(display=False) as counter:
        _common.causal_attention(q, k, v, lambda t: t, q_block=1)
    want = flops.attention_core(cfg, b, s)["flops"] / cfg["num_hidden_layers"]
    assert counter.get_total_flops() == want


def test_published_counts():
    """The benchmark's configurations at their cells' shapes (the
    predictions' base in PERF.md)."""
    root = spec.ROOT / "bench" / "configs"
    olmoe = json.loads((root / "olmoe-1b-7b.json").read_text())
    ds = json.loads((root / "deepseek-v2-lite-16b.json").read_text())
    assert flops.prefill_flops(olmoe, 4, 2048)["total"] == pytest.approx(
        1.873e13, rel=0.001)
    assert flops.prefill_flops(olmoe, 1, 32768)["total"] == pytest.approx(
        1.409e14, rel=0.001)
    assert flops.attention_core(olmoe, 1, 32768)["flops"] == pytest.approx(
        7.037e13, rel=0.001)
    assert flops.prefill_flops(ds, 1, 8192)["total"] == pytest.approx(
        4.600e13, rel=0.001)
