"""Useful operations of a decoder's prefill forward, from its published
configuration.

Counted: the matrix products at the published widths, two FLOPs a
multiply-add.  Each token's projections, router and feed-forward; of a
mixture of experts only the experts a token is routed to (`pairs`, by
default every token's `num_experts_per_tok`); attention's score and
value products over the causal pairs only (query i sees keys 0..i); the
output head for the last position of each prompt alone, since a prefill
step returns only the sampler's input.  Not counted: norms, softmax,
RoPE, the gate's and the activation's elementwise work, the embedding
gather, and whatever an implementation adds (padded vocabulary, empty
expert slots, masked blocks).  So a share of the peak taken from these
counts is a share of useful work.

The keys read are the published `config.json`'s: `hidden_size`,
`num_hidden_layers`, `num_attention_heads`, `num_key_value_heads`,
`head_dim` (else hidden / heads), `vocab_size`, `intermediate_size`;
with experts `num_experts` or `n_routed_experts`, `num_experts_per_tok`,
`moe_intermediate_size` (else `intermediate_size` is the expert width),
`n_shared_experts`, `first_k_dense_replace` (leading dense layers of
width `intermediate_size`); with latent attention `kv_lora_rank`,
`qk_nope_head_dim`, `qk_rope_head_dim`, `v_head_dim`, `q_lora_rank`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = ["causal_pairs", "prefill_flops", "attention_core"]


def causal_pairs(seq: int) -> int:
    """(query, key) pairs a causal prompt of `seq` tokens attends."""
    return seq * (seq + 1) // 2


def _experts(cfg: Dict[str, Any]) -> int:
    return int(cfg.get("n_routed_experts") or cfg.get("num_experts") or 0)


def attention_core(cfg: Dict[str, Any], batch: int, seq: int) -> Dict[str,
                                                                     float]:
    """Score and value products of every layer over the causal pairs, and
    the bytes a fused attention kernel must move: q, k and v read once
    and the output written once, in bf16 (`flops`, `bytes`)."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    kv = cfg.get("num_key_value_heads") or h
    if cfg.get("kv_lora_rank"):
        dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
        dv, kv = cfg["v_head_dim"], h
    else:
        dqk = dv = cfg.get("head_dim") or d // h
    layers = cfg["num_hidden_layers"]
    flops = 2 * batch * causal_pairs(seq) * h * (dqk + dv) * layers
    nbytes = 2 * batch * seq * (h * dqk + kv * dqk + kv * dv + h * dv) * layers
    return {"flops": float(flops), "bytes": float(nbytes)}


def prefill_flops(cfg: Dict[str, Any], batch: int, seq: int,
                  pairs: Optional[int] = None) -> Dict[str, float]:
    """Useful FLOPs of one prefill forward over `batch` prompts of `seq`
    tokens, by part, and their `total`.  `pairs` is the number of
    (token, routed expert) pairs computed in all MoE layers together,
    by default every token's top-k in every MoE layer."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    kv = cfg.get("num_key_value_heads") or h
    layers = cfg["num_hidden_layers"]
    tokens = batch * seq
    if cfg.get("kv_lora_rank"):
        nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
        lora, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]
        q_lora = cfg.get("q_lora_rank") or 0
        q = (d * q_lora + q_lora * h * (nope + rope)) if q_lora \
            else d * h * (nope + rope)
        proj = q + d * (lora + rope) + lora * h * (nope + dv) + h * dv * d
    else:
        hd = cfg.get("head_dim") or d // h
        proj = d * h * hd + 2 * d * kv * hd + h * hd * d
    out = {"attention_projections": 2.0 * tokens * proj * layers,
           "attention_core": attention_core(cfg, batch, seq)["flops"]}
    n_exp = _experts(cfg)
    if n_exp:
        dense = int(cfg.get("first_k_dense_replace") or 0)
        moe_layers = layers - dense
        f_e = cfg.get("moe_intermediate_size") or cfg["intermediate_size"]
        top_k = cfg["num_experts_per_tok"]
        if pairs is None:
            pairs = tokens * top_k * moe_layers
        shared = int(cfg.get("n_shared_experts") or 0) * f_e
        out["router"] = 2.0 * tokens * d * n_exp * moe_layers
        out["experts"] = 2.0 * pairs * 3 * d * f_e
        out["shared_experts"] = 2.0 * tokens * 3 * d * shared * moe_layers
        out["dense_mlp"] = 2.0 * tokens * 3 * d * cfg["intermediate_size"] \
            * dense if cfg.get("moe_intermediate_size") else 0.0
    else:
        out["dense_mlp"] = 2.0 * tokens * 3 * d * cfg["intermediate_size"] \
            * layers
    out["head"] = 2.0 * batch * d * cfg["vocab_size"]
    out["total"] = sum(out.values())
    return out
