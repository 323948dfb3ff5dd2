"""Encoder-decoder transformer of the port (whisper-medium's backbone), the
twin of `repro.models.encdec`.

The conv frontend is a stub, as in the reference: the inputs are frame
embeddings `[B, S_enc, D]` (what the two conv layers would make of the
mel spectrogram).  Encoder: bidirectional MHA and a GELU MLP with learned
positions.  Decoder: causal self-attention, cross-attention to the
encoder's output and a GELU MLP.  LayerNorm and MHA (`num_kv_heads ==
num_heads`), biases on q, k and v.

The parameters keep the reference's layout, each stack's leaves stacked
on its layers:

    {"embed": [V_pad, d], "enc_pos": [S_enc, d], "dec_pos": [32768, d],
     "encoder": {ln1_s, ln1_b, attn: {wq, wk, wv, wo, bq, bk, bv},
                 ln2_s, ln2_b, mlp: {w1, b1, w2, b2}}  (each [L, ...]),
     "decoder": {... as the encoder's, and lnx_s, lnx_b, xattn},
     "enc_norm_s", "enc_norm_b", "dec_norm_s", "dec_norm_b"}

and the layers run as the reference's scan (`layers.scan`), so the
frontend traces the serving code itself.  The decode cache is
`{"k", "v": [L, B, max_len, KV, hd], "xk", "xv": [L, B, S_enc, KV, hd]}`
in bf16; the decode writes `k` and `v` in place and passes the cross
caches on unchanged.  Nothing in the reference fills the cross caches:
its `init_cache` zeroes them and its server never runs the encoder.
`repro_torch.convert.encdec_params_from_numpy` carries a reference
parameter tree into this layout.  Training: `EncDecLM.loss` is the
reference's plain mean of the next-token cross-entropy, and under
`Runtime(remat="full")` each layer of both scans is recomputed in the
backward, as the reference checkpoints its scan bodies; "dots" recomputes
nothing here, as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.frontend.trace import dynamic_slice_in_dim
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import Runtime, Spec
from repro_torch.models.lm import (DecoderLM, cross_entropy, padded_vocab,
                                   remat_unit)

Params = Any

__all__ = ["EncDecLM"]


def _attn_block_specs(cfg: ArchConfig, cross: bool) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    s: Dict[str, Any] = {
        "ln1_s": Spec((d,), ("embed",), "ones"),
        "ln1_b": Spec((d,), ("embed",), "zeros"),
        "attn": L.gqa_specs(d, cfg.num_heads, cfg.num_kv_heads, hd, True),
    }
    if cross:
        s["lnx_s"] = Spec((d,), ("embed",), "ones")
        s["lnx_b"] = Spec((d,), ("embed",), "zeros")
        s["xattn"] = L.gqa_specs(d, cfg.num_heads, cfg.num_kv_heads, hd,
                                 True)
    s["ln2_s"] = Spec((d,), ("embed",), "ones")
    s["ln2_b"] = Spec((d,), ("embed",), "zeros")
    s["mlp"] = L.gelu_mlp_specs(d, cfg.d_ff)
    return s


def _proj(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
          n: int, hd: int, rt: Runtime,
          axes: Tuple[Optional[str], ...] = ("batch",)) -> torch.Tensor:
    """One projection split into heads; `axes` the placement it takes
    first over a mesh whose `qkv_fused` split cuts a head
    (`layers.split_heads`)."""
    cd = rt.compute_dtype
    y = L.cd_matmul(x, w, cd)
    if b is not None:
        y = y + b.float()
    y = rt.shard(y.to(cd), "batch", None, "qkv_fused")
    return L.split_heads(y, n, hd, rt, *axes)


def _mha(p: Params, xq: torch.Tensor, xkv: torch.Tensor, cfg: ArchConfig,
         rt: Runtime, causal: bool) -> torch.Tensor:
    """Whisper attention: no RoPE (learned absolute positions), always
    `blocked_attention`, as in the reference (no kernel)."""
    hd = cfg.resolved_head_dim
    if xq is xkv:
        q, k, v = L.gqa_project(p, xq, cfg.num_heads, cfg.num_kv_heads, hd,
                                rt)
    else:
        q = _proj(xq, p["wq"], p.get("bq"), cfg.num_heads, hd, rt,
                  ("batch", "attn_seq"))
        k = _proj(xkv, p["wk"], p.get("bk"), cfg.num_kv_heads, hd, rt)
        v = _proj(xkv, p["wv"], p.get("bv"), cfg.num_kv_heads, hd, rt)
    q = rt.shard(q, "batch", "attn_seq")
    o = L.blocked_attention(q, k, v, causal=causal, kv_block=rt.attn_kv_block)
    o = rt.shard(o, "batch", "attn_seq")
    return L.gqa_out(p, o, rt)


def _remat_body(body, rt: Runtime):
    """A scan body under `rt.remat`: only "full" recomputes it, as the
    reference checkpoints its encoder and decoder bodies under "full"
    alone."""
    if rt.remat != "full":
        return body
    return lambda x, p: remat_unit(body, "full", x, p)


class EncDecLM(nn.Module):
    """Encoder-decoder LM over an explicit parameter dict (see the module
    note); like `DecoderLM`, the module holds the architecture and every
    call takes the weights."""

    _mask_pad = DecoderLM._mask_pad

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.v_pad = padded_vocab(cfg.vocab_size)

    # ----------------------------------------------------------- param specs
    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        d = cfg.d_model
        return {
            "embed": Spec((self.v_pad, d), ("vocab", "embed")),
            "enc_pos": Spec((cfg.encoder_seq, d), (None, "embed"), "small"),
            # the largest decode/prefill length (32k): whisper's 448-token
            # table extended as long-form serving resizes it
            "dec_pos": Spec((32768, d), (None, "embed"), "small"),
            "encoder": L.stack_specs(_attn_block_specs(cfg, cross=False),
                                     cfg.encoder_layers),
            "decoder": L.stack_specs(_attn_block_specs(cfg, cross=True),
                                     cfg.num_layers),
            "enc_norm_s": Spec((d,), ("embed",), "ones"),
            "enc_norm_b": Spec((d,), ("embed",), "zeros"),
            "dec_norm_s": Spec((d,), ("embed",), "ones"),
            "dec_norm_b": Spec((d,), ("embed",), "zeros"),
        }

    def init(self, generator: torch.Generator, rt: Runtime) -> Params:
        """Random parameters on the generator's device."""
        return L.init_params(self.param_specs(), generator, rt.param_dtype)

    # --------------------------------------------------------------- encoder
    def encode(self, params: Params, frames: torch.Tensor, rt: Runtime
               ) -> torch.Tensor:
        """Frames [B, S_enc, D] -> the encoder's output [B, S_enc, D] in
        the compute dtype."""
        cfg, cd = self.cfg, rt.compute_dtype
        eps = cfg.norm_eps
        S = frames.shape[1]
        x = rt.shard(frames.to(cd) + params["enc_pos"][:S].to(cd),
                     "batch", None, None)

        def body(x, p):
            h = L.layer_norm(x, p["ln1_s"], p["ln1_b"], eps)
            x = x + _mha(p["attn"], h, h, cfg, rt, causal=False)
            h = L.layer_norm(x, p["ln2_s"], p["ln2_b"], eps)
            x = x + L.gelu_mlp(p["mlp"], h, rt)
            return x, None

        x, _ = L.scan(_remat_body(body, rt), x, params["encoder"])
        return L.layer_norm(x, params["enc_norm_s"], params["enc_norm_b"],
                            eps)

    # --------------------------------------------------------------- decoder
    def forward(self, params: Params, batch: Dict[str, torch.Tensor],
                rt: Runtime, last_only: bool = False) -> torch.Tensor:
        """{"frames": [B, S_enc, D], "tokens": [B, S]} -> logits [B, S,
        V_pad] in the compute dtype ([B, 1, V_pad] when `last_only`)."""
        cfg, cd = self.cfg, rt.compute_dtype
        eps = cfg.norm_eps
        enc_out = self.encode(params, batch["frames"], rt)
        tok = batch["tokens"]
        S = tok.shape[1]
        x = L.embed_rows(params["embed"], tok).to(cd)
        x = rt.shard(x + params["dec_pos"][:S].to(cd), "batch", None, None)

        def body(x, p):
            h = L.layer_norm(x, p["ln1_s"], p["ln1_b"], eps)
            x = x + _mha(p["attn"], h, h, cfg, rt, causal=True)
            h = L.layer_norm(x, p["lnx_s"], p["lnx_b"], eps)
            x = x + _mha(p["xattn"], h, enc_out, cfg, rt, causal=False)
            h = L.layer_norm(x, p["ln2_s"], p["ln2_b"], eps)
            x = x + L.gelu_mlp(p["mlp"], h, rt)
            return x, None

        x, _ = L.scan(_remat_body(body, rt), x, params["decoder"])
        if last_only:
            x = x[:, -1:]
        x = L.layer_norm(x, params["dec_norm_s"], params["dec_norm_b"], eps)
        logits = L.cd_matmul(x, params["embed"].t(), cd)
        return rt.shard(self._mask_pad(logits.to(cd)), "batch", None,
                        "vocab")

    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             rt: Runtime) -> torch.Tensor:
        """Next-token cross-entropy (fp32, 0-d), a plain mean over every
        position, as in the reference (no mask)."""
        logits = self.forward(params, batch, rt)
        return cross_entropy(logits[:, :-1], batch["tokens"][:, 1:],
                             rt).mean()

    def decay_mask(self) -> Dict[str, Any]:
        """Whether AdamW decays each leaf: the reference's rule, two
        dimensions or more (the layout is the reference's)."""
        return L.map_specs(lambda s: len(s.shape) >= 2, self.param_specs())

    # ---------------------------------------------------------------- decode
    def cache_specs(self, batch: int, max_len: int) -> Dict[str, Spec]:
        """The decoder's self-attention KV cache and the cross-attention
        KV of the (stubbed) encoder's output, stacked on the layers."""
        cfg = self.cfg
        hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
        per_layer = {
            "k": Spec((batch, max_len, kv, hd),
                      ("batch", "kv_seq", None, None), "zeros", "bf16"),
            "v": Spec((batch, max_len, kv, hd),
                      ("batch", "kv_seq", None, None), "zeros", "bf16"),
            "xk": Spec((batch, cfg.encoder_seq, kv, hd),
                       ("batch", None, None, None), "zeros", "bf16"),
            "xv": Spec((batch, cfg.encoder_seq, kv, hd),
                       ("batch", None, None, None), "zeros", "bf16"),
        }
        return L.stack_specs(per_layer, cfg.num_layers)

    def init_cache(self, batch: int, max_len: int, rt: Runtime,
                   device: torch.device | str = "cpu"
                   ) -> Dict[str, torch.Tensor]:
        """Zeroed caches, as the reference's (cross caches included)."""
        return L.zeros_cache(self.cache_specs(batch, max_len), rt, device)

    def decode_step(self, params: Params, cache: Dict[str, torch.Tensor],
                    token: torch.Tensor, pos: torch.Tensor, rt: Runtime
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One decode step: token [B, 1] int64, `pos` its position (a 0-d
        int64 tensor on the device).  Returns fp32 logits [B, 1, V_pad]
        and the caches: `k` and `v` written in place at `pos`, `xk` and
        `xv` as they came."""
        cfg, cd = self.cfg, rt.compute_dtype
        eps = cfg.norm_eps
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        x = L.embed_rows(params["embed"], token).to(cd)
        x = x + dynamic_slice_in_dim(params["dec_pos"], pos, 1, 0).to(cd)
        x = rt.shard(x, "batch", None, None)

        def body(x, pc):
            p, c = pc
            h = L.layer_norm(x, p["ln1_s"], p["ln1_b"], eps)
            q, k_new, v_new = L.gqa_project(p["attn"], h, H, KV, hd, rt,
                                            q_axes=("batch",))
            k = L.kv_cache_write(c["k"], k_new, pos)
            v = L.kv_cache_write(c["v"], v_new, pos)
            k = rt.shard(k, "batch", "kv_seq")
            v = rt.shard(v, "batch", "kv_seq")
            o = L.blocked_attention(q, k.to(cd), v.to(cd), causal=False,
                                    kv_block=rt.attn_kv_block,
                                    kv_len=pos + 1)
            x = x + L.gqa_out(p["attn"], o, rt)
            h = L.layer_norm(x, p["lnx_s"], p["lnx_b"], eps)
            # the cross k and v projections are made and dropped, as in
            # the reference (its cross caches are inputs)
            qx, _, _ = L.gqa_project(p["xattn"], h, H, KV, hd, rt,
                                     q_axes=("batch",))
            ox = L.blocked_attention(qx, c["xk"].to(cd), c["xv"].to(cd),
                                     causal=False, kv_block=rt.attn_kv_block)
            x = x + L.gqa_out(p["xattn"], ox, rt)
            h = L.layer_norm(x, p["ln2_s"], p["ln2_b"], eps)
            x = x + L.gelu_mlp(p["mlp"], h, rt)
            return x, {"k": k, "v": v, "xk": c["xk"], "xv": c["xv"]}

        x, new_cache = L.scan(body, x, (params["decoder"], cache))
        x = L.layer_norm(x, params["dec_norm_s"], params["dec_norm_b"], eps)
        logits = L.cd_matmul(x, params["embed"].t(), cd)
        return (rt.shard(self._mask_pad(logits), "batch", None, "vocab"),
                new_cache)
