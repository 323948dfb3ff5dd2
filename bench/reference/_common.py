"""Plain float32 building blocks of the bench's references.

Written from the models' published descriptions and the served
configuration's stated choices (its config file), with plain `torch`
operations.  Nothing here imports `jax`, the JAX package or the port.

Every product takes a rounding `r` of both of its operands: the identity
for the reference itself, and a round trip through fp8 e4m3 with one
scale a tensor for the control that stands in for a lower-precision
program (`rounder`).  TF32 is off while a reference runs
(`fp32_products`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator

import torch
import torch.nn.functional as F

__all__ = ["rounder", "fp32_products", "rms_norm", "rope", "causal_attention",
           "swiglu", "capacity", "moe", "upcast", "embed_and_head"]

Round = Callable[[torch.Tensor], torch.Tensor]

# the largest finite e4m3 value
_E4M3_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to fp8 e4m3 under one scale that maps its largest
    magnitude to e4m3's largest finite value, and back to fp32."""
    scale = torch.clamp_min(t.detach().abs().amax().float() / _E4M3_MAX,
                            1e-30)
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def rounder(precision: str) -> Round:
    """The rounding applied to every product's operands: `fp32` (none) or
    `fp8` (e4m3, one scale a tensor)."""
    if precision == "fp32":
        return lambda t: t
    if precision == "fp8":
        return _fp8
    raise ValueError(f"precision {precision!r}: not fp32 or fp8")


@contextlib.contextmanager
def fp32_products() -> Iterator[None]:
    """Products in full float32 (no TF32), the previous settings restored
    after."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32)
    mm.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = saved


def upcast(tree):
    """A copy of a tree of weights (dicts and lists of tensors) in fp32."""
    if isinstance(tree, dict):
        return {k: upcast(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [upcast(v) for v in tree]
    return tree.float()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x [B, S, H, D] at positions 0..S-1, the
    rotate-half form (the first half of each head's dims paired with the
    second), frequencies theta^(-2i/D), angles in fp32."""
    seq, dim = x.shape[1], x.shape[-1]
    freqs = theta ** (-torch.arange(0, dim, 2, dtype=torch.float32,
                                    device=x.device) / dim)
    ang = torch.arange(seq, device=x.device).float()[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :dim // 2], x[..., dim // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     r: Round, q_block: int = 1024) -> torch.Tensor:
    """softmax(q k^T / sqrt(d_qk), causal) v for q, k [B, S, H, d_qk] and
    v [B, S, H, d_v]; query block i0:i1 against keys 0:i1, so only the
    blocks' causal part is multiplied and memory stays O(q_block x S)."""
    seq, d_qk = q.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(d_qk)
    out = []
    for i0 in range(0, seq, q_block):
        i1 = min(seq, i0 + q_block)
        q_t = r(q[:, i0:i1]).transpose(1, 2)            # [B, H, q, d_qk]
        k_t = r(k[:, :i1]).permute(0, 2, 3, 1)          # [B, H, d_qk, k]
        s = (q_t @ k_t) * scale
        qi = torch.arange(i0, i1, device=q.device)[:, None]
        kj = torch.arange(i1, device=q.device)[None, :]
        p = torch.softmax(s.masked_fill(kj > qi, float("-inf")), dim=-1)
        out.append((r(p) @ r(v[:, :i1]).transpose(1, 2)).transpose(1, 2))
    return torch.cat(out, dim=1)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor, r: Round) -> torch.Tensor:
    """(silu(x w1) * (x w3)) w2."""
    h = F.silu(r(x) @ r(w1)) * (r(x) @ r(w3))
    return r(h) @ r(w2)


def capacity(group: int, top_k: int, n_experts: int, factor: float) -> int:
    """Slots each expert has in a routing group: group * top_k / experts *
    factor, rounded up, then up to a multiple of 8, and at least 8."""
    cap = math.ceil(group * top_k / n_experts * factor)
    return max(8, -(-cap // 8) * 8)


def moe(x: torch.Tensor, p: Dict[str, torch.Tensor], *, top_k: int,
        normalize: bool, group_size: int, factor: float, r: Round,
        kept: list) -> torch.Tensor:
    """Token-choice top-k mixture of experts over x [T, d] with capacity
    dropping.

    Each token's router probabilities are the softmax of x router; its
    `top_k` largest are its experts and gates (the gates renormalised to
    sum to 1 where `normalize`).  Tokens are routed in consecutive groups
    of `group_size` (all of them where there are fewer).  In a group, the
    (token, expert) pairs are taken token by token, and each expert keeps
    its first `capacity(...)` pairs in that order; a pair past it is
    dropped and adds nothing.  A token's output is the
    gate-weighted sum of its kept experts' SwiGLU outputs.  `kept`
    collects the number of pairs kept in each group."""
    n_tok, n_exp = x.shape[0], p["router"].shape[1]
    probs = torch.softmax(r(x) @ r(p["router"]), dim=-1)
    gate, expert = torch.topk(probs, top_k, dim=-1)
    if normalize:
        gate = gate / gate.sum(-1, keepdim=True)
    group = min(group_size, n_tok)
    cap = capacity(group, top_k, n_exp, factor)
    out = torch.zeros_like(x)
    for g0 in range(0, n_tok, group):
        e = expert[g0:g0 + group].reshape(-1)         # token-major pairs
        w = gate[g0:g0 + group].reshape(-1)
        tok = g0 + torch.arange(e.numel(), device=x.device) // top_k
        # each pair's place among its expert's pairs, in token order
        order = torch.argsort(e, stable=True)
        per_expert = torch.bincount(e, minlength=n_exp)
        first = torch.cumsum(per_expert, 0) - per_expert
        place = torch.empty_like(e)
        place[order] = torch.arange(e.numel(), device=x.device) \
            - first[e[order]]
        keep = place < cap
        # the kept pairs grouped by expert, in token order within each
        kept_order = order[keep[order]]
        counts = torch.bincount(e[kept_order], minlength=n_exp).tolist()
        kept.append(sum(counts))
        for ex, sel in enumerate(torch.split(kept_order, counts)):
            if sel.numel() == 0:
                continue
            rows = tok[sel]
            y = swiglu(x[rows], p["we1"][ex], p["we3"][ex], p["we2"][ex], r)
            out.index_add_(0, rows, y * w[sel, None])
    return out


def embed_and_head(params, tokens: torch.Tensor, vocab: int):
    """The embedding rows of `tokens` in fp32, and a function from the
    last position's hidden state to the logits over the `vocab` published
    ids (the stored table may hold padding rows past them)."""
    x = params["embed"][tokens].float()

    def head(h: torch.Tensor, r: Round) -> torch.Tensor:
        return r(h) @ r(params["lm_head"][:, :vocab].float())
    return x, head
