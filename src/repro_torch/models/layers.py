"""Model-zoo layers of the port, cut to what a dense GQA decoder needs:
RMSNorm, RoPE, blocked (online-softmax) attention, GQA attention for a
full sequence and for one decode step with a KV cache, and the SwiGLU MLP
— plain functions on tensors over per-layer parameter dicts.

Conventions (those of `repro.models.layers`)
-------------------------------------------
* Parameters are declared as `Spec`s (shape + logical axes + init), so a
  reference parameter tree converts leaf for leaf (`repro_torch.convert`).
* Mixed precision: projections take their inputs in the compute dtype and
  accumulate in fp32 (`torch.matmul`); norm and softmax math is fp32.  A
  bf16 product leaves cuBLAS rounded to bf16 once, where the reference
  keeps it in fp32 up to its cast.  The serving steps run under
  `full_precision_products`, so an fp32 product is full fp32 (no TF32)
  and a bf16 product is reduced in fp32.
* Attention is written in the grouped GQA form (no KV head repetition), so
  decode-time KV caches stay at `num_kv_heads` width.
* Layouts are the reference's: q `[B, S, H, hd]`, k/v `[B, S, KV, hd]`,
  `wq` `[d, H*hd]`.

MLA, MoE, RG-LRU, mLSTM/sLSTM, local-block attention and the GELU MLP are
ported in a later slice (see ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Any

__all__ = ["Runtime", "Spec", "init_params", "full_precision_products",
           "rms_norm", "rope_cos_sin", "apply_rope", "blocked_attention",
           "kv_cache_write", "gqa_specs", "gqa_project", "gqa_out",
           "gqa_attention_train", "gqa_attention_decode", "swiglu_specs",
           "swiglu"]


@contextlib.contextmanager
def full_precision_products() -> Iterator[None]:
    """cuBLAS products at the reference's precision inside the block, the
    caller's settings restored after it.  Both compute dtypes need both
    flags: fp32 products (the fp32 projections, and the attention scores
    and values of `blocked_attention` and the decode step at any compute
    dtype) run without TF32, which keeps about three decimal digits; bf16
    products (the bf16 projections) reduce their split-K partials in
    fp32, not bf16.  The settings do nothing on the CPU."""
    mm = torch.backends.cuda.matmul
    saved = (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction)
    mm.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction = saved


def not_ported(what: str):
    return NotImplementedError(f"{what} is ported in a later slice, see "
                               "ROADMAP.md")


# ============================================================ runtime/context

@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution knobs threaded through every layer.

    `use_kernels` is the counterpart of the reference's `use_pallas`: when
    set, full-sequence attention goes through the hand-written kernel
    `kernels.flash_attention` instead of `blocked_attention`.  The
    reference's mesh, sharding rules and remat policy have no counterpart
    on one GPU."""

    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    use_kernels: bool = False
    attn_kv_block: int = 1024
    kv_dtype: str = "bf16"              # bf16 | f8 (f8: a later slice)


# ================================================================ param specs

@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"            # normal | zeros | ones | rglru_a | small
    dtype: Optional[str] = None     # None -> param_dtype; "bf16" | "f32"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    def resolved_dtype(self, default: torch.dtype) -> torch.dtype:
        if self.dtype == "bf16":
            return torch.bfloat16
        if self.dtype == "f32":
            return torch.float32
        return default


def map_specs(fn, tree):
    """`tree` (nested dicts and lists) with every `Spec` replaced by
    `fn(spec)`, visited in order."""
    if isinstance(tree, Spec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    return [map_specs(fn, t) for t in tree]


def init_params(specs, generator: torch.Generator,
                param_dtype: torch.dtype = torch.float32) -> Params:
    """Random parameters by the reference's rules: zeros, ones, the RG-LRU
    logit init, and normal with std `min(scale, 1/sqrt(fan_in))` (scale
    0.02, or 0.006 for "small").  The numbers come from `generator` (on
    the device it was made for), so they are not the reference's."""
    dev = generator.device

    def draw(spec: Spec) -> torch.Tensor:
        dt = spec.resolved_dtype(param_dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=dev)
        if spec.init == "rglru_a":
            u = torch.empty(spec.shape, dtype=torch.float32, device=dev)
            u.uniform_(0.9 ** 2, 0.999 ** 2, generator=generator)
            return (torch.log(u) - torch.log1p(-u)).to(dt)
        scale = 0.02 if spec.init == "normal" else 0.006
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = min(scale, 1.0 / math.sqrt(max(fan_in, 1)))
        return (torch.randn(spec.shape, generator=generator,
                            dtype=torch.float32, device=dev) * std).to(dt)

    return map_specs(draw, specs)


def cd_matmul(x: torch.Tensor, w: torch.Tensor, cd: torch.dtype
              ) -> torch.Tensor:
    """`x @ w` with both operands in the compute dtype; fp32 result."""
    return torch.matmul(x.to(cd), w.to(cd)).float()


# ================================================================= norms/rope

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * scale.float()
    return y.to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [..., S] -> cos/sin [..., S, dim//2] (fp32)."""
    freqs = theta ** (-torch.arange(0, dim, 2, dtype=torch.float32,
                                    device=positions.device) / dim)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [B, S, H, hd] (rotate-half convention); cos/sin [B, S, hd//2]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ======================================================== blocked attention

def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B,Sq,KV,G,hd] x k [B,Skv,KV,hd] -> scores [B,KV,G,Sq,Skv] fp32."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())


def _gqa_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p [B,KV,G,Sq,Skv] x v [B,Skv,KV,hd] -> [B,Sq,KV,G,hd] fp32; `p`
    is rounded to v's dtype first, as in the reference."""
    return torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(),
                        v.float())


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool, kv_block: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV blocks (the plain version of the
    flash kernel's algorithm, written with tensor ops).

    q [B, Sq, H, hd]; k, v [B, Skv, KV, hd].  The causal mask is `i >= j`
    (top-left).  Memory stays O(Sq x kv_block).  The reference's window,
    query offset and padded-cache length come with the slices that call
    them (local attention, the padded decode cache)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = (q * scale).reshape(B, Sq, KV, G, hd)
    dev = q.device
    q_pos = torch.arange(Sq, device=dev)

    m = torch.full((B, KV, G, Sq), -math.inf, device=dev)
    l = torch.zeros((B, KV, G, Sq), device=dev)
    acc = torch.zeros((B, Sq, KV, G, v.shape[-1]), device=dev)
    for j0 in range(0, Skv, kv_block):
        kj, vj = k[:, j0:j0 + kv_block], v[:, j0:j0 + kv_block]
        s = _gqa_scores(qg, kj)                          # [B,KV,G,Sq,kb]
        if causal:
            kv_pos = j0 + torch.arange(kj.shape[1], device=dev)
            s = s.masked_fill(q_pos[:, None] < kv_pos[None, :], -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + _gqa_values(p, vj)
        m = m_new
    l_t = torch.clamp_min(l.permute(0, 3, 1, 2)[..., None], 1e-30)
    return (acc / l_t).reshape(B, Sq, H, -1).to(q.dtype)


def kv_cache_write(cache: torch.Tensor, new: torch.Tensor, pos: int
                   ) -> torch.Tensor:
    """Write `new` [B, 1, ...] into `cache` [B, S, ...] at seq position
    `pos`, in place (the reference returns a new buffer; writing in place
    saves a copy of the whole cache per layer and step)."""
    cache[:, pos:pos + 1] = new.to(cache.dtype)
    return cache


# ========================================================== GQA attention

def gqa_specs(d: int, n_heads: int, n_kv: int, hd: int,
              qkv_bias: bool) -> Dict[str, Spec]:
    s = {
        "wq": Spec((d, n_heads * hd), ("embed", "qkv_fused")),
        "wk": Spec((d, n_kv * hd), ("embed", "qkv_fused")),
        "wv": Spec((d, n_kv * hd), ("embed", "qkv_fused")),
        "wo": Spec((n_heads * hd, d), ("qkv_fused", "embed")),
    }
    if qkv_bias:
        s["bq"] = Spec((n_heads * hd,), ("qkv_fused",), "zeros")
        s["bk"] = Spec((n_kv * hd,), ("qkv_fused",), "zeros")
        s["bv"] = Spec((n_kv * hd,), ("qkv_fused",), "zeros")
    return s


def gqa_project(p: Params, x: torch.Tensor, n_heads: int, n_kv: int,
                hd: int, rt: Runtime
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    cd = rt.compute_dtype
    B, S, _ = x.shape

    def proj(w, b, n):
        y = cd_matmul(x, w, cd)
        if b is not None:
            y = y + b.float()
        return y.to(cd).reshape(B, S, n, hd)

    q = proj(p["wq"], p.get("bq"), n_heads)
    k = proj(p["wk"], p.get("bk"), n_kv)
    v = proj(p["wv"], p.get("bv"), n_kv)
    return q, k, v


def gqa_out(p: Params, attn: torch.Tensor, rt: Runtime) -> torch.Tensor:
    B, S, H, hd = attn.shape
    y = cd_matmul(attn.reshape(B, S, H * hd), p["wo"], rt.compute_dtype)
    return y.to(rt.compute_dtype)


def gqa_attention_train(p: Params, x: torch.Tensor, *, n_heads: int,
                        n_kv: int, hd: int, rope_theta: float, rt: Runtime,
                        causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    B, S, _ = x.shape
    q, k, v = gqa_project(p, x, n_heads, n_kv, hd, rt)
    pos = torch.arange(S, device=x.device)[None, :]
    cos, sin = rope_cos_sin(pos, hd, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if window and window < S:
        raise not_ported("local_block_attention")
    if rt.use_kernels:
        from repro_torch.kernels.flash_attention import flash_attention
        o = flash_attention(q, k, v, causal=causal)
    else:
        o = blocked_attention(q, k, v, causal=causal,
                              kv_block=rt.attn_kv_block)
    return gqa_out(p, o, rt)


def gqa_attention_decode(p: Params, x: torch.Tensor,
                         cache: Dict[str, torch.Tensor], pos: int, *,
                         n_heads: int, n_kv: int, hd: int, rope_theta: float,
                         rt: Runtime, window: int = 0
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode with a statically-sized KV cache.

    cache = {"k": [B, S_max, KV, hd], "v": ...}, written in place; `pos`
    (an int) is the position of the new token.  For window attention the
    cache is a ring buffer of `window` slots."""
    B = x.shape[0]
    q, k_new, v_new = gqa_project(p, x, n_heads, n_kv, hd, rt)
    cos, sin = rope_cos_sin(torch.full((1, 1), pos, device=x.device), hd,
                            rope_theta)
    q = apply_rope(q, cos, sin)
    k_new = apply_rope(k_new, cos, sin)
    S_max = cache["k"].shape[1]
    slot = pos % S_max if window else pos
    k = kv_cache_write(cache["k"], k_new, slot)
    v = kv_cache_write(cache["v"], v_new, slot)

    G = n_heads // n_kv
    qg = (q * (1.0 / math.sqrt(hd))).reshape(B, 1, n_kv, G, hd)
    s = _gqa_scores(qg, k)                                # [B,KV,G,1,S]
    kv_pos = torch.arange(S_max, device=x.device)
    if window:
        # ring buffer: slot idx holds absolute position base+idx (idx <= cur)
        # or base-S_max+idx (idx > cur); valid iff 0 <= abs_pos <= pos
        cur = pos % S_max
        base = pos - cur
        abs_pos = torch.where(kv_pos <= cur, base + kv_pos,
                              base - S_max + kv_pos)
        valid = (abs_pos >= 0) & (abs_pos <= pos)
    else:
        valid = kv_pos <= pos
    s = s.masked_fill(~valid, -math.inf)
    p_attn = torch.softmax(s, dim=-1)
    o = _gqa_values(p_attn, v).reshape(B, 1, n_heads, hd)
    y = gqa_out(p, o.to(rt.compute_dtype), rt)
    return y, {"k": k, "v": v}


# ===================================================================== MLPs

def swiglu_specs(d: int, f: int) -> Dict[str, Spec]:
    return {
        "w1": Spec((d, f), ("embed", "ff")),
        "w3": Spec((d, f), ("embed", "ff")),
        "w2": Spec((f, d), ("ff", "embed")),
    }


def swiglu(p: Params, x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    cd = rt.compute_dtype
    g = cd_matmul(x, p["w1"], cd)
    u = cd_matmul(x, p["w3"], cd)
    h = (F.silu(g) * u).to(cd)
    return cd_matmul(h, p["w2"], cd).to(cd)
