"""Decoder language model of the port, assembled from
`repro_torch.models.layers`.

The reference scans over pattern groups with each unit's parameters
stacked along a `repeats` axis; here PyTorch runs eagerly, so the model
is a Python loop over layers, each with its own parameter dict:

    {"embed": [V_pad, d], "final_norm": [d], ("lm_head": [d, V_pad],)
     "layers": [{"ln1", "attn": {wq, wk, wv, wo, (bq, bk, bv)}, "ln2",
                 "mlp": {w1, w3, w2}}, ...]}

(an "rglru" layer holds "rglru" in place of "attn"; an MoE layer holds
"moe": {router, we1, we3, we2, ("shared": {w1, w3, w2})} in place of
"mlp"; with MLA, "attn" is {wq, wdkv, wukv, wo, kv_norm}; an "mlstm"
layer is {"ln1", "mlstm"}, with no "ln2" or MLP; an "slstm" layer holds
"slstm" in place of "attn" and a SwiGLU of `_slstm_ff_dim(d)`).
`repro_torch.convert.decoder_params_from_numpy` carries a reference
parameter tree into this layout.  Supported: dense GQA decoders (qwen2*,
mistral-nemo), the VLM stub (internvl2: a patch-embedding prefix), the
Griffin hybrid (recurrentgemma: RG-LRU and local-attention layers) and
the MoE decoders (olmoe; deepseek-v2-lite: MLA, shared experts and a
leading dense layer) and xLSTM (mLSTM and sLSTM blocks); the
encoder-decoder (whisper) is `repro_torch.models.encdec.EncDecLM`.

Training: `DecoderLM.loss` is the reference's next-token cross-entropy,
and `Runtime.remat` recomputes activations per reference *unit* (one
repeat of a group's pattern, or a group of one repeat as a whole:
`units`), as the reference checkpoints its scan bodies.  The optimizer
decays a leaf by its rank in the reference's layout, where a group of
several repeats stacks its leaves (`DecoderLM.decay_mask`).

The full-sequence forward opens `obs` spans: `lm.embed`, `layer` for each
block (its self time the norms and residual adds), `mlp` for a dense
feed-forward, and `lm.head`; `layers` opens those of the attention and
the MoE block.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch import obs
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import Runtime, Spec

Params = Any

__all__ = ["DecoderLM", "Group", "plan_groups", "padded_vocab",
           "cross_entropy", "remat_unit", "DOTS_SAVED"]


@dataclasses.dataclass(frozen=True)
class Group:
    """A pattern group: `unit` (tuple of block kinds) repeated `repeats`
    times."""

    unit: Tuple[str, ...]
    repeats: int


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  rt: Runtime = Runtime()) -> torch.Tensor:
    """Per-token cross-entropy [B, S] in fp32, the reference's expressions:
    the max detached (`stop_gradient`), the exp-sum in fp32, and the
    label's logit contracted out of the logits by a one-hot in their dtype
    (the reference's largest training tensor, `[B, S, V]`, and its
    2 B S V FLOPs).  The one-hot is `jax.nn.one_hot`'s form
    (`layers.one_hot`), on the logits' vocab shards over a mesh.  The
    contraction's one product a row is exact, so its result in the
    logits' dtype is the reference's fp32 one."""
    m = logits.detach().amax(dim=-1, keepdim=True).float()
    ex_sum = torch.exp(logits.float() - m).sum(dim=-1)
    lse = torch.log(ex_sum) + m[..., 0]
    oh = L.one_hot(targets, logits.shape[-1], logits.dtype)
    oh = rt.shard(oh, "batch", None, "vocab")
    ll = torch.einsum("bsv,bsv->bs", logits, oh).float()
    return lse - ll


def plan_groups(cfg: ArchConfig) -> List[Group]:
    n = cfg.num_layers
    groups: List[Group] = []
    if cfg.moe is not None and cfg.moe.first_dense:
        groups.append(Group(("attn_dense",) * cfg.moe.first_dense, 1))
        n -= cfg.moe.first_dense
    unit = cfg.block_pattern
    r, rem = divmod(n, len(unit))
    if r:
        groups.append(Group(unit, r))
    if rem:
        groups.append(Group(unit[:rem], 1))
    return groups


# ==================================================================== remat

# the products `Runtime(remat="dots")` saves: those without batch
# dimensions, the counterpart of the reference's
# `dots_with_no_batch_dims_saveable` (a projection `[B, S, d] @ [d, f]`
# reaches aten as `mm`, a biased one as `addmm`); `bmm` (attention scores
# and values, the MoE experts' and the RG-LRU gates' einsums) and every
# other op are recomputed in the backward
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in DOTS_SAVED:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat_unit(fn, remat: str, *args):
    """`fn(*args)` under the activation-recompute policy `remat`: "none"
    runs it, "full" saves only its inputs and recomputes it in the
    backward (`jax.checkpoint`), "dots" saves the products of
    `DOTS_SAVED` and recomputes the rest.  Outside a forward that needs
    gradients every policy is the call itself."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if remat == "full":
        return ckpt.checkpoint(fn, *args, use_reentrant=False)
    if remat == "dots":
        return ckpt.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"remat {remat!r}: not one of none, full, dots")


# =========================================================== block dispatch

def _check_block(kind: str) -> None:
    if kind not in ("attn", "attn_dense", "local_attn", "rglru", "mlstm",
                    "slstm"):
        raise ValueError(kind)


def _slstm_ff_dim(d: int) -> int:
    """The SwiGLU width after an sLSTM block: 4 d / 3 rounded up to a
    multiple of 128."""
    return -(-int(4 * d / 3) // 128) * 128


def _mla_kw(cfg: ArchConfig) -> Dict[str, Any]:
    m = cfg.mla
    return dict(n_heads=cfg.num_heads, kv_lora=m.kv_lora_rank,
                nope=m.qk_nope_head_dim, rope_d=m.qk_rope_head_dim,
                v_hd=m.v_head_dim, rope_theta=cfg.rope_theta,
                eps=cfg.norm_eps)


def block_specs(cfg: ArchConfig, kind: str) -> Dict[str, Any]:
    _check_block(kind)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if kind == "mlstm":
        return {"ln1": Spec((d,), ("embed",), "ones"),
                "mlstm": L.mlstm_specs(d, cfg.num_heads)}
    if kind == "slstm":
        return {"ln1": Spec((d,), ("embed",), "ones"),
                "slstm": L.slstm_specs(d, cfg.num_heads),
                "ln2": Spec((d,), ("embed",), "ones"),
                "mlp": L.swiglu_specs(d, _slstm_ff_dim(d))}
    if kind == "rglru":
        mixer = {"rglru": L.rglru_specs(d, cfg.lru_width or d, cfg.num_heads,
                                        cfg.conv1d_width)}
    elif cfg.mla is not None:
        m = cfg.mla
        mixer = {"attn": L.mla_specs(d, cfg.num_heads, m.kv_lora_rank,
                                     m.qk_nope_head_dim, m.qk_rope_head_dim,
                                     m.v_head_dim)}
    else:
        mixer = {"attn": L.gqa_specs(d, cfg.num_heads, cfg.num_kv_heads, hd,
                                     cfg.qkv_bias)}
    if kind == "attn_dense":
        ff = {"mlp": L.swiglu_specs(
            d, cfg.moe.dense_d_ff if cfg.moe else cfg.d_ff)}
    elif cfg.moe is not None and kind != "rglru":
        ff = {"moe": L.moe_specs(d, cfg.moe.num_experts, cfg.moe.d_expert,
                                 cfg.moe.num_shared)}
    else:
        ff = {"mlp": L.swiglu_specs(d, cfg.d_ff)}
    return {
        "ln1": Spec((d,), ("embed",), "ones"),
        **mixer,
        "ln2": Spec((d,), ("embed",), "ones"),
        **ff,
    }


def _feed_forward(cfg: ArchConfig, p: Params, h: torch.Tensor,
                  rt: Runtime) -> torch.Tensor:
    if "moe" in p:
        m = cfg.moe
        return L.moe_block(p["moe"], h, n_experts=m.num_experts,
                           top_k=m.top_k, capacity_factor=m.capacity_factor,
                           normalize_gates=m.norm_topk_prob, rt=rt)
    with obs.span("mlp"):
        return L.swiglu(p["mlp"], h, rt)


def block_apply_train(cfg: ArchConfig, kind: str, p: Params,
                      x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    _check_block(kind)
    with obs.span("layer"):
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        xkw = dict(n_heads=cfg.num_heads, eps=cfg.norm_eps, rt=rt)
        if kind == "mlstm":
            return x + L.mlstm_block_train(p["mlstm"], h, **xkw)
        if kind == "slstm":
            x = x + L.slstm_block_train(p["slstm"], h, **xkw)
        elif kind == "rglru":
            x = x + L.rglru_block_train(p["rglru"], h,
                                        n_heads=cfg.num_heads, rt=rt)
        elif cfg.mla is not None:
            x = x + L.mla_attention_train(p["attn"], h, rt=rt,
                                          **_mla_kw(cfg))
        else:
            x = x + L.gqa_attention_train(
                p["attn"], h, n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
                hd=cfg.resolved_head_dim, rope_theta=cfg.rope_theta, rt=rt,
                causal=True,
                window=cfg.local_window if kind == "local_attn" else 0)
        h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + _feed_forward(cfg, p, h2, rt)


def block_cache_specs(cfg: ArchConfig, kind: str, batch: int,
                      max_len: int) -> Dict[str, Spec]:
    """A layer's decode state: the bf16 KV cache of an attention layer (a
    ring of `min(local_window, max_len)` slots for local attention; with
    MLA the latent `ckv` and the RoPE key `krope`), or the fp32 recurrent
    state of an RG-LRU, mLSTM (the matrix memory C, its normaliser n and
    stabiliser m) or sLSTM (h, c, n, m) layer."""
    _check_block(kind)
    if kind == "mlstm":
        uhd = 2 * cfg.d_model // cfg.num_heads
        return {"C": Spec((batch, cfg.num_heads, uhd, uhd),
                          ("batch", None, None, "mlstm_state"), "zeros",
                          "f32"),
                "n": Spec((batch, cfg.num_heads, uhd),
                          ("batch", None, "mlstm_state"), "zeros", "f32"),
                "m": Spec((batch, cfg.num_heads), ("batch", None), "zeros",
                          "f32")}
    if kind == "slstm":
        return {k: Spec((batch, cfg.d_model), ("batch", None), "zeros",
                        "f32") for k in ("h", "c", "n", "m")}
    if kind == "rglru":
        w = cfg.lru_width or cfg.d_model
        return {"h": Spec((batch, w), ("batch", "lru"), "zeros", "f32"),
                "conv": Spec((batch, cfg.conv1d_width - 1, w),
                             ("batch", None, "lru"), "zeros", "f32")}
    if cfg.mla is not None:
        m = cfg.mla
        axes = ("batch", "kv_seq", None)
        return {"ckv": Spec((batch, max_len, m.kv_lora_rank), axes, "zeros",
                            "bf16"),
                "krope": Spec((batch, max_len, m.qk_rope_head_dim), axes,
                              "zeros", "bf16")}
    s_len = min(cfg.local_window, max_len) if kind == "local_attn" \
        else max_len
    shape = (batch, s_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    axes = ("batch", "kv_seq", "kv_heads", None)
    return {"k": Spec(shape, axes, "zeros", "bf16"),
            "v": Spec(shape, axes, "zeros", "bf16")}


def block_apply_decode(cfg: ArchConfig, kind: str, p: Params,
                       x: torch.Tensor, cache: Dict[str, torch.Tensor],
                       pos: torch.Tensor, rt: Runtime
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    _check_block(kind)
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    xkw = dict(n_heads=cfg.num_heads, eps=cfg.norm_eps, rt=rt)
    if kind == "mlstm":
        a, cache = L.mlstm_block_decode(p["mlstm"], h, cache, **xkw)
        return x + a, cache
    if kind == "slstm":
        a, cache = L.slstm_block_decode(p["slstm"], h, cache, **xkw)
    elif kind == "rglru":
        a, cache = L.rglru_block_decode(p["rglru"], h, cache,
                                        n_heads=cfg.num_heads, rt=rt)
    elif cfg.mla is not None:
        a, cache = L.mla_attention_decode(p["attn"], h, cache, pos, rt=rt,
                                          **_mla_kw(cfg))
    else:
        a, cache = L.gqa_attention_decode(
            p["attn"], h, cache, pos, n_heads=cfg.num_heads,
            n_kv=cfg.num_kv_heads, hd=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta, rt=rt,
            window=cfg.local_window if kind == "local_attn" else 0)
    x = x + a
    h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _feed_forward(cfg, p, h2, rt), cache


# ================================================================= the model

def padded_vocab(v: int) -> int:
    """The vocabulary padded to a multiple of 256, as the reference pads
    its embedding; padded logit columns are masked before any softmax."""
    return -(-v // 256) * 256


class DecoderLM(nn.Module):
    """Decoder LM over an explicit parameter dict (see the module note).

    The module holds the architecture, not the weights: `init` makes a
    parameter dict and every call takes one, as the reference's pure
    functions do, so converted reference weights and random ones go
    through the same code."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.groups = plan_groups(cfg)
        self.kinds = [kind for g in self.groups for _ in range(g.repeats)
                      for kind in g.unit]
        self.v_pad = padded_vocab(cfg.vocab_size)

    def units(self) -> List[Tuple[int, int]]:
        """The reference's scan units as `(first layer, layer count)`: one
        repeat of a group's pattern, in order (a group of one repeat is
        one unit as a whole, as the reference runs it)."""
        out, i = [], 0
        for g in self.groups:
            for _ in range(g.repeats):
                out.append((i, len(g.unit)))
                i += len(g.unit)
        return out

    # ----------------------------------------------------------- param specs
    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        specs: Dict[str, Any] = {
            "embed": Spec((self.v_pad, cfg.d_model), ("vocab", "embed")),
            "final_norm": Spec((cfg.d_model,), ("embed",), "ones"),
            "layers": [block_specs(cfg, kind) for kind in self.kinds],
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = Spec((cfg.d_model, self.v_pad),
                                    ("embed", "vocab"))
        return specs

    def decay_mask(self) -> Dict[str, Any]:
        """The parameter tree's layout with a bool a leaf: whether the
        reference's AdamW decays it, i.e. whether it has two dimensions or
        more in the reference's layout, where a group of several repeats
        stacks its leaves on a leading axis (a norm scale of such a group
        is 2-D there and decayed; one of a group of one repeat is not)."""
        specs = self.param_specs()
        mask = L.map_specs(lambda s: len(s.shape) >= 2, specs)
        layers = []
        for g in self.groups:
            stacked = int(g.repeats > 1)
            for _ in range(g.repeats):
                for _kind in g.unit:
                    layers.append(L.map_specs(
                        lambda s, k=stacked: len(s.shape) + k >= 2,
                        specs["layers"][len(layers)]))
        mask["layers"] = layers
        return mask

    def init(self, generator: torch.Generator, rt: Runtime) -> Params:
        """Random parameters on the generator's device."""
        return L.init_params(self.param_specs(), generator, rt.param_dtype)

    # -------------------------------------------------------------- forward
    def _embed(self, params: Params, tokens: torch.Tensor, rt: Runtime
               ) -> torch.Tensor:
        """Embedding rows in the compute dtype; the hybrid family
        (recurrentgemma) scales them by sqrt(d_model) rounded to that
        dtype, as the reference does."""
        x = L.embed_rows(params["embed"], tokens).to(rt.compute_dtype)
        if self.cfg.family == "hybrid":
            x = x * float(torch.tensor(math.sqrt(self.cfg.d_model),
                                       dtype=rt.compute_dtype))
        return x

    def _embed_inputs(self, params: Params, batch: Dict[str, torch.Tensor],
                      rt: Runtime) -> torch.Tensor:
        with obs.span("lm.embed"):
            x = self._embed(params, batch["tokens"], rt)
            if self.cfg.frontend == "vit_stub" and "patch_embeds" in batch:
                x = torch.cat([batch["patch_embeds"].to(rt.compute_dtype),
                               x], dim=1)
            return rt.shard(x, "batch", None, None)

    def _logits(self, params: Params, x: torch.Tensor, rt: Runtime
                ) -> torch.Tensor:
        """Final norm and the vocab projection; fp32 [B, S, V_pad]."""
        x = L.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        head = (params["embed"].t() if self.cfg.tie_embeddings
                else params["lm_head"])
        return self._mask_pad(L.cd_matmul(x, head, rt.compute_dtype))

    def forward(self, params: Params, batch: Dict[str, torch.Tensor],
                rt: Runtime, last_only: bool = False) -> torch.Tensor:
        """Full-sequence forward -> logits [B, S_total, V_pad] in the
        compute dtype (or [B, 1, V_pad] when `last_only`: serving prefill
        needs only the sampler's input, and the full logits of a 32k
        sequence take GBs)."""
        x = self._embed_inputs(params, batch, rt)
        for first, n in self.units():
            x = remat_unit(self._unit, rt.remat, x,
                           params["layers"][first:first + n],
                           self.kinds[first:first + n], rt)
        if last_only:
            x = x[:, -1:]
        with obs.span("lm.head"):
            logits = self._logits(params, x, rt).to(rt.compute_dtype)
        return rt.shard(logits, "batch", None, "vocab")

    def _unit(self, x: torch.Tensor, layers: List[Params], kinds: List[str],
              rt: Runtime) -> torch.Tensor:
        for kind, p in zip(kinds, layers):
            x = block_apply_train(self.cfg, kind, p, x, rt)
        return x

    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             rt: Runtime) -> torch.Tensor:
        """Next-token cross-entropy (fp32, 0-d): the VLM prefix sliced
        away, the mean over `loss_mask` (its first column dropped with the
        shift) where the batch has one, else over every position."""
        logits = self.forward(params, batch, rt)
        tok = batch["tokens"]
        prefix = logits.shape[1] - tok.shape[1]         # vlm patch positions
        logits = logits[:, prefix:]
        nll = cross_entropy(logits[:, :-1], tok[:, 1:], rt)
        mask = batch.get("loss_mask")
        if mask is not None:
            m = mask[:, 1:].float()
            return (nll * m).sum() / torch.clamp_min(m.sum(), 1.0)
        return nll.mean()

    def _mask_pad(self, logits: torch.Tensor) -> torch.Tensor:
        if self.v_pad == self.cfg.vocab_size:
            return logits
        pad = torch.arange(self.v_pad, device=logits.device) \
            >= self.cfg.vocab_size
        return logits.masked_fill(pad, -1e9)

    # --------------------------------------------------------------- decode
    def cache_specs(self, batch: int, max_len: int) -> List[Dict[str, Spec]]:
        return [block_cache_specs(self.cfg, kind, batch, max_len)
                for kind in self.kinds]

    def init_cache(self, batch: int, max_len: int, rt: Runtime,
                   device: torch.device | str = "cpu"
                   ) -> List[Dict[str, torch.Tensor]]:
        """Zeroed per-layer decode states, as in the reference: KV caches
        in bf16 (or f8 under `Runtime(kv_dtype="f8")`, the reference's
        dry-run cache), which the decode step writes in place, and fp32
        recurrent states, which it replaces."""
        return L.zeros_cache(self.cache_specs(batch, max_len), rt, device)

    def decode_step(self, params: Params,
                    cache: List[Dict[str, torch.Tensor]],
                    token: torch.Tensor, pos: torch.Tensor, rt: Runtime
                    ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
        """One decode step: token [B, 1] int64, `pos` its position (a 0-d
        int64 tensor on the device).  Returns fp32 logits [B, 1, V_pad]
        and the caches."""
        x = rt.shard(self._embed(params, token, rt), "batch", None, None)
        new_caches = []
        for kind, p, c in zip(self.kinds, params["layers"], cache):
            x, c = block_apply_decode(self.cfg, kind, p, x, c, pos, rt)
            new_caches.append(c)
        return (rt.shard(self._logits(params, x, rt), "batch", None,
                         "vocab"), new_caches)
