"""Plain float32 reference of OLMoE (arXiv:2409.02060) as the benchmark
serves it: last-position logits of a causal prefill.

The published model, with the choices its config file states: RMSNorm
before attention and before the mixture of experts, residual adds;
multi-head attention with rotate-half RoPE (theta `rope_theta`) on q and
k, scale 1/sqrt(head dim); a mixture of `num_experts` SwiGLU experts of
width `intermediate_size`, top `num_experts_per_tok` of a softmax router,
gates renormalised where `norm_topk_prob`, routed in groups of
`moe_group_size` tokens with `capacity_factor` (`_common.moe`); a final
RMSNorm and an untied head.  Departures from the published model are the
config file's `departures` (the served model has no QK-norm).

Weights are read from the tree the benchmark made (bf16), one layer at a
time in fp32, so the reference fits beside them.
"""

from __future__ import annotations

import torch

from bench.reference._common import (
    causal_attention, embed_and_head, fp32_products, moe, rms_norm, rope,
    rounder, upcast)

__all__ = ["last_logits"]


def last_logits(cfg, params, tokens: torch.Tensor, precision: str = "fp32",
                kept: list | None = None) -> torch.Tensor:
    """Logits [B, vocab_size] (fp32) of the last position of each prompt in
    tokens [B, S].  `precision` "fp8" rounds every product's operands to
    fp8 (the control); `kept` collects the MoE pairs kept a group."""
    r = rounder(precision)
    kept = [] if kept is None else kept
    d, n_h = cfg["hidden_size"], cfg["num_attention_heads"]
    n_kv, hd = cfg["num_key_value_heads"], cfg["hidden_size"] // n_h
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    b, s = tokens.shape
    with torch.no_grad(), fp32_products():
        x, head = embed_and_head(params, tokens, cfg["vocab_size"])
        for layer in params["layers"]:
            lp = upcast(layer)
            a = lp["attn"]
            h = rms_norm(x, lp["ln1"], eps)
            q = rope((r(h) @ r(a["wq"])).view(b, s, n_h, hd), theta)
            k = rope((r(h) @ r(a["wk"])).view(b, s, n_kv, hd), theta)
            v = (r(h) @ r(a["wv"])).view(b, s, n_kv, hd)
            # query head i reads key / value head i // (n_h / n_kv)
            k, v = (t.repeat_interleave(n_h // n_kv, dim=2) for t in (k, v))
            o = causal_attention(q, k, v, r).reshape(b, s, n_h * hd)
            x = x + r(o) @ r(a["wo"])
            h = rms_norm(x, lp["ln2"], eps).reshape(b * s, d)
            x = x + moe(h, lp["moe"], top_k=cfg["num_experts_per_tok"],
                        normalize=cfg["norm_topk_prob"],
                        group_size=cfg["moe_group_size"],
                        factor=cfg["capacity_factor"], r=r,
                        kept=kept).view(b, s, d)
            del lp, a, h, q, k, v, o
        h = rms_norm(x[:, -1], params["final_norm"].float(), eps)
        return head(h, r)
