"""Plain float32 reference of DeepSeek-V2 (arXiv:2405.04434; the Lite
model's config.json) as the benchmark serves it: last-position logits of
a causal prefill.

The published model, with the choices its config file states: RMSNorm
before attention and before the feed-forward, residual adds.  Multi-head
latent attention without a query latent (`q_lora_rank` null): q = x wq
per head of `qk_nope_head_dim` + `qk_rope_head_dim`; x wdkv gives the
latent c (`kv_lora_rank`, RMS-normed) and one RoPE key shared by the
heads; c wukv gives each head's k_nope and v (`v_head_dim`); rotate-half
RoPE (theta `rope_theta`) on q's and the shared key's rope dims; scale
1/sqrt(nope + rope); causal softmax.  The first `first_k_dense_replace`
layers have a SwiGLU of `intermediate_size`; the others a mixture of
`n_routed_experts` SwiGLU experts of `moe_intermediate_size`, top
`num_experts_per_tok` of a softmax router, gates not renormalised
(`norm_topk_prob` false), routed in groups of `moe_group_size` tokens with
`capacity_factor` (`_common.moe`), plus `n_shared_experts` shared ones
(one SwiGLU of their summed width).  A final RMSNorm and an untied head.
Departures from the published model are the config file's `departures`.
`rope_scaling` is YaRN at `factor` 1, which is plain RoPE: its interpolated
and extrapolated frequencies coincide and both of its mscales are 1.  A
larger factor is refused, not computed.

Weights are read from the tree the benchmark made (bf16), one layer at a
time in fp32, so the reference fits beside them (the model's fp32
weights alone would take 64.8 GB).
"""

from __future__ import annotations

import torch

from bench.reference._common import (
    causal_attention, embed_and_head, fp32_products, moe, rms_norm, rope,
    rounder, swiglu, upcast)

__all__ = ["last_logits"]


def last_logits(cfg, params, tokens: torch.Tensor, precision: str = "fp32",
                kept: list | None = None) -> torch.Tensor:
    """Logits [B, vocab_size] (fp32) of the last position of each prompt in
    tokens [B, S].  `precision` "fp8" rounds every product's operands to
    fp8 (the control); `kept` collects the MoE pairs kept a group."""
    scaling = cfg.get("rope_scaling")
    if scaling is not None and scaling.get("factor", 1) != 1:
        raise ValueError(f"rope_scaling factor {scaling['factor']}: only "
                         "plain RoPE (YaRN at factor 1) is computed here")
    r = rounder(precision)
    kept = [] if kept is None else kept
    d, n_h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope_d = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    lora, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    b, s = tokens.shape
    with torch.no_grad(), fp32_products():
        x, head = embed_and_head(params, tokens, cfg["vocab_size"])
        for layer in params["layers"]:
            lp = upcast(layer)
            a = lp["attn"]
            h = rms_norm(x, lp["ln1"], eps)
            q = (r(h) @ r(a["wq"])).view(b, s, n_h, nope + rope_d)
            ckv = r(h) @ r(a["wdkv"])
            c = rms_norm(ckv[..., :lora], a["kv_norm"], eps)
            kv = (r(c) @ r(a["wukv"])).view(b, s, n_h, nope + dv)
            k_rope = rope(ckv[..., lora:][:, :, None, :], theta)
            q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], -1)
            k = torch.cat([kv[..., :nope],
                           k_rope.expand(b, s, n_h, rope_d)], -1)
            o = causal_attention(q, k, kv[..., nope:], r)
            x = x + r(o.reshape(b, s, n_h * dv)) @ r(a["wo"])
            h = rms_norm(x, lp["ln2"], eps).reshape(b * s, d)
            if "moe" in lp:
                m = lp["moe"]
                y = moe(h, m, top_k=cfg["num_experts_per_tok"],
                        normalize=cfg["norm_topk_prob"],
                        group_size=cfg["moe_group_size"],
                        factor=cfg["capacity_factor"], r=r, kept=kept)
                y = y + swiglu(h, m["shared"]["w1"], m["shared"]["w3"],
                               m["shared"]["w2"], r)
            else:
                mlp = lp["mlp"]
                y = swiglu(h, mlp["w1"], mlp["w3"], mlp["w2"], r)
            x = x + y.view(b, s, d)
            del lp, a, h, q, k, kv, ckv, c, o, y
        h = rms_norm(x[:, -1], params["final_norm"].float(), eps)
        return head(h, r)
