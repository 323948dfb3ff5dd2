"""Model-zoo layers of the port, what every arch of the zoo needs: RMSNorm
and LayerNorm, RoPE, blocked (online-softmax: causal, window, query
offset, padded-cache length) and local-block attention, GQA attention and
multi-head latent attention (MLA) for a full sequence and for one decode
step with a KV cache (bf16, or f8 under `Runtime(kv_dtype="f8")`), the
SwiGLU and GELU MLPs, the token-choice MoE block, the RG-LRU recurrent
block and the mLSTM and sLSTM blocks, and `scan`, the reference's
`lax.scan` over stacked layers — plain functions on tensors over
parameter dicts.

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
* The full-sequence attention and the MoE block open `obs` spans (`attn`,
  `attn.core`, `moe`, `moe.route`, `moe.dispatch`, `moe.experts`,
  `moe.combine`, `moe.shared`), and `_moe_dispatch` counts the expert
  slots and the pairs dropped at capacity (`moe.pairs_routed`,
  `moe.slots`, `moe.pairs_dropped`).  With `obs` off a span is a shared
  null context and nothing is counted.

"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from repro_torch import obs
from repro_torch.distributed.sharding import AxisRules, shard_constraint
from repro_torch.frontend.trace import (index_from_end, nested_jit, node_of,
                                        scan_slices, scan_stack, tracing)

Params = Any

__all__ = ["Runtime", "no_kernel_backward", "Spec", "init_params",
           "full_precision_products", "stack_specs", "zeros_cache",
           "KV_DTYPES", "scan", "rms_norm", "layer_norm", "rope_cos_sin",
           "apply_rope", "blocked_attention", "local_block_attention",
           "f8_bits", "kv_cache_write", "gelu_mlp_specs", "gelu_mlp",
           "gqa_specs", "gqa_project", "gqa_out", "gqa_attention_train",
           "gqa_attention_decode", "mla_specs", "mla_attention_train",
           "mla_attention_decode", "swiglu_specs", "swiglu", "moe_specs",
           "moe_capacity", "moe_route", "one_hot", "moe_slots",
           "assert_unique_slots", "moe_block", "rglru_specs",
           "rglru_scan_inputs", "rglru_gated_inputs", "rglru_output",
           "rglru_block_train", "rglru_block_decode", "mlstm_specs",
           "mlstm_block_train", "mlstm_block_decode", "slstm_specs",
           "slstm_block_train", "slstm_block_decode"]


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


# ============================================================ runtime/context

@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution knobs threaded through every layer.

    `use_kernels` is the counterpart of the reference's `use_pallas`: when
    set, full-sequence attention within the window goes through the
    hand-written kernel `kernels.flash_attention` instead of
    `blocked_attention`, and the RG-LRU block's gates, decay, scan and
    gating through `kernels.rg_lru.rglru_gated_scan` instead of tensor ops
    around the scan's plain version.  `moe_group_size` is the number of
    tokens the MoE block routes together (the execution DSE's
    `moe_group_size`).  `mlstm_chunk` is the chunk length of the mLSTM's
    chunkwise form.  `remat` is the activation-recompute policy of a
    training forward (`none | full | dots`, the reference's): "full"
    checkpoints each of the reference's scan units
    (`torch.utils.checkpoint`), "dots" saves only the products without
    batch dimensions (`mm`, `addmm`) and recomputes the rest.  `mesh` (a
    `DeviceMesh`) and `rules` (`distributed.AxisRules`) are the
    reference's: `shard` redistributes a DTensor to the rules' placements
    and leaves a plain tensor as it is.  The models call it at the
    counterparts of the reference's `rt.shard` sites, so a step on
    DTensors over a mesh (`launch.steps.trace_step(mesh=...)`) is laid
    out as the reference's, and every step on plain tensors is unchanged.
    The kernels have no backward: under `use_kernels` a forward that
    needs gradients raises (the reference trains with `use_pallas=False`
    as well), and they take no DTensor (`no_kernel_on_dtensor`)."""

    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    use_kernels: bool = False
    attn_kv_block: int = 1024
    moe_group_size: int = 4096          # tokens routed together (GShard G)
    mlstm_chunk: int = 256
    kv_dtype: str = "bf16"              # bf16 | f8 (`KV_DTYPES`)
    remat: str = "none"                 # none | full | dots
    mesh: Any = None                    # torch.distributed DeviceMesh
    rules: Optional[AxisRules] = None

    def axis_size(self, name: str) -> int:
        """How many parts the rules split the logical axis `name` into on
        the mesh (1 without a mesh)."""
        if self.mesh is None or self.rules is None:
            return 1
        axes = self.rules.get(name)
        if axes is None:
            return 1
        names = tuple(self.mesh.mesh_dim_names)
        axes = (axes,) if isinstance(axes, str) else axes
        return math.prod(self.mesh.size(names.index(a)) for a in axes)

    def shard(self, x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
        if self.mesh is None or self.rules is None:
            return x
        return shard_constraint(
            x, self.rules, *axes, *[None] * (x.ndim - len(axes)),
            mesh=self.mesh)


def no_kernel_backward(what: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need the backward of the kernel `what`:
    grad is enabled and an input requires grad.  The kernels are called
    through ctypes, so their outputs carry no `grad_fn`, and the inputs
    would silently get no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward: under Runtime(use_kernels=True) its "
            "inputs would get no gradient.  Train with use_kernels=False, "
            "as the reference trains without Pallas (use_pallas=False).")


def no_kernel_on_dtensor(what: str, *tensors: torch.Tensor) -> None:
    """Raise if a kernel `what` would get a DTensor: a kernel reads the
    memory of the tensor it is given, and a DTensor's is one rank's shard
    (the reference's Pallas calls are not partitioned either).  Run a
    placed step with `use_kernels=False`, or on the placed leaves'
    `to_local()` tensors."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(
            f"{what} got a DTensor: the kernel would read one rank's shard "
            "as the whole tensor.  Over a mesh run the plain path "
            "(Runtime(use_kernels=False)) or the placed leaves' "
            "to_local() tensors.")


def shard_count(x: torch.Tensor, dim: int) -> int:
    """The number of parts a DTensor's placements split dimension `dim`
    into (1 for a plain tensor)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return 1
    dim %= x.ndim
    return math.prod(x.device_mesh.size(i)
                     for i, p in enumerate(x.placements)
                     if p.is_shard() and p.dim == dim)


def split_heads(y: torch.Tensor, n: int, hd: int, rt: "Runtime",
                *axes: Optional[str]) -> torch.Tensor:
    """y [B, S, n * hd] -> [B, S, n, hd].  Over a mesh whose placement of
    the fused dimension cuts a head in two (n not a multiple of its
    shards), y first takes the placement `axes` of the reference's next
    constraint on this tensor: GSPMD reshards there silently, DTensor
    refuses to unflatten an uneven split."""
    if n % shard_count(y, -1):
        y = rt.shard(y, *axes)
    return y.reshape(y.shape[0], y.shape[1], n, hd)


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


def stack_specs(specs, n: int, axis_name: Optional[str] = "layers"):
    """Prepend a stacking dimension of `n` to every `Spec` (the
    reference's scan-over-layers parameters and caches)."""
    return map_specs(lambda s: Spec((n,) + s.shape, (axis_name,) + s.axes,
                                    s.init, s.dtype), specs)


# the KV cache's dtype by `Runtime.kv_dtype` (the reference's dry-run gives
# an f8 cache the e4m3 format: `launch/steps.py` of the JAX package)
KV_DTYPES = {"bf16": torch.bfloat16, "f8": torch.float8_e4m3fn}


def zeros_cache(specs, rt: "Runtime", device) -> Any:
    """Zeroed decode caches from their specs: every leaf whose spec says
    bf16 (a KV cache) in `rt.kv_dtype`'s dtype, every other leaf (fp32
    recurrent state) in its own."""
    if rt.kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype {rt.kv_dtype!r}: not one of "
                         f"{sorted(KV_DTYPES)}")
    kv = KV_DTYPES[rt.kv_dtype]
    return map_specs(
        lambda s: torch.zeros(s.shape, device=device, dtype=kv if s.dtype ==
                              "bf16" else s.resolved_dtype(torch.bfloat16)),
        specs)


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


def cd_matmul(x: torch.Tensor, w: torch.Tensor, cd: torch.dtype, *,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`x @ w` with both operands in the compute dtype; the result in
    `out_dtype` (fp32 by default; the compute dtype keeps the product as
    cuBLAS returns it)."""
    return torch.matmul(x.to(cd), w.to(cd)).to(out_dtype)


def f32_matmul(x: torch.Tensor, w: torch.Tensor, cd: torch.dtype
               ) -> torch.Tensor:
    """`x @ w` with both operands rounded to the compute dtype and the
    product in fp32 (exact products, fp32 sums): the reference's
    `preferred_element_type=f32` where it keeps the result in fp32 (in
    float64 at a float64 compute dtype)."""
    acc = acc_dtype(cd)
    return torch.matmul(x.to(cd).to(acc), w.to(cd).to(acc))


# ================================================================= norms/rope

def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a layer's fp32 math runs in: fp32, or float64 for float64
    inputs (a yardstick evaluated in float64)."""
    return torch.promote_types(dtype, torch.float32)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    x32 = x.to(acc_dtype(x.dtype))
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * scale.to(x32.dtype)
    return y.to(x.dtype)


def _var(x: torch.Tensor) -> torch.Tensor:
    """`jnp.var(x, axis=-1, keepdims=True)`'s decomposition: the mean, the
    centred squares summed, over N."""
    centred = x - x.mean(dim=-1, keepdim=True)
    return centred.square().sum(dim=-1, keepdim=True) / x.shape[-1]


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in fp32 as the reference writes it: the mean, `jnp.var`
    (`_var`, a nested `jit` to the frontend), rsqrt, scale and bias."""
    x32 = x.to(acc_dtype(x.dtype))
    mu = x32.mean(dim=-1, keepdim=True)
    var = nested_jit("var", _var, x32)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * scale.to(x32.dtype) + bias.to(x32.dtype)
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
                      *, causal: bool, window: int = 0, q_offset: int = 0,
                      kv_block: int = 1024,
                      kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Online-softmax attention over KV blocks (the plain version of the
    flash kernel's algorithm, written with tensor ops).

    q [B, Sq, H, hd]; k, v [B, Skv, KV, hd].  `q_offset` is the absolute
    position of q[0]; the causal mask is `q_offset + i >= j`.  `window >
    0` limits attention to the last `window` positions; `kv_len` (a 0-d
    tensor on the device) masks the tail of a statically padded KV cache.
    K and V are padded to a multiple of `kv_block` and the padded tail is
    masked, as in the reference: the values are those of the unpadded
    keys, the work (and the products a traced graph sees) is the
    reference's.  Memory stays O(Sq x kv_block).  The loop is the
    reference's scan: the KV blocks are its xs (`scan_slices`), the block
    counter a 0-d carry, and the mask is made from ones and and-ed every
    block in the reference's order (causal, window, `kv_len`, pad), so a
    traced graph is the reference's vertex for vertex.

    On DTensors (a step over a mesh) the attention runs on each rank's
    rows of q (`_attention_on_local_rows`)."""
    if _is_dtensor(q):
        if _is_dtensor(kv_len):             # a replicated position
            kv_len = kv_len.full_tensor()
        return _attention_on_local_rows(
            functools.partial(blocked_attention, causal=causal,
                              window=window, kv_block=kv_block,
                              kv_len=kv_len),
            q, k, v, q_offset)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = (q * scale).reshape(B, Sq, KV, G, hd)
    nblk = -(-Skv // kv_block)
    pad = nblk * kv_block - Skv
    if pad:
        k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
    kb = k.reshape(B, nblk, kv_block, KV, hd).transpose(0, 1)
    vb = v.reshape(B, nblk, kv_block, KV, hd_v).transpose(0, 1)
    dev = q.device
    q_pos = torch.arange(Sq, device=dev)
    if q_offset:
        q_pos = q_offset + q_pos

    m = torch.full((B, KV, G, Sq), -math.inf, device=dev)
    l = torch.zeros((B, KV, G, Sq), device=dev)
    acc = torch.zeros((B, Sq, KV, G, hd_v), device=dev)
    j = torch.zeros((), dtype=torch.int64, device=dev)
    for kj, vj in scan_slices(kb, vb):
        s = _gqa_scores(qg, kj)                          # [B,KV,G,Sq,kb]
        kv_pos = j * kv_block + torch.arange(kv_block, device=dev)
        mask = torch.ones((Sq, kv_block), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (q_pos[:, None] >= kv_pos[None, :])
        if window:
            mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
        if kv_len is not None:
            mask = mask & (kv_pos < kv_len)[None, :]
        if pad:
            mask = mask & (kv_pos < Skv)[None, :]
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + _gqa_values(p, vj)
        m = m_new
        j = j + 1
    l_t = torch.clamp_min(l.permute(0, 3, 1, 2)[..., None], 1e-30)
    return (acc / l_t).reshape(B, Sq, H, -1).to(q.dtype)


def softmax_last(s: torch.Tensor) -> torch.Tensor:
    """`torch.softmax(s, dim=-1)`.  On a DTensor whose last dimension is
    split (a decode step's scores over a sequence-split cache), written
    out: its max, exp and sum, each rank over its own part and the
    reductions across ranks (the partitioned softmax GSPMD runs; the same
    FLOPs and transcendentals as the fused op).  DTensor's rule for the
    fused op gathers the whole dimension."""
    if shard_count(s, -1) == 1:
        return torch.softmax(s, dim=-1)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _first_row(x: torch.Tensor, dim: int) -> Optional[int]:
    """Rank 0's (and every rank's) first index along `dim` of a DTensor
    whose placements split it (its coordinates on the splitting mesh
    dimensions, major to minor, times its rows), or None where the mesh
    does not split `dim`."""
    if shard_count(x, dim) == 1:
        return None
    mesh, row = x.device_mesh, 0
    for i, p in enumerate(x.placements):
        if p.is_shard() and p.dim == dim:
            row = row * mesh.size(i) + mesh.get_local_rank(i)
    return row * x.to_local().shape[dim]


def _on_local_rows(fn, x: torch.Tensor, out_pl: tuple, *others
                   ) -> torch.Tensor:
    """`fn(x, *others)` on DTensors, rank by rank: each `(tensor,
    placements)` of `others` taken at its placements, `fn` run on the
    local shards, its result [B, S, ...] lying at `out_pl` as x's rows do
    (the global rows x's, even where the mesh splits them unevenly, which
    `local_map` cannot say; a later dimension that `out_pl` splits is
    the local one times its shards)."""
    from torch.distributed.tensor import DTensor

    mesh = x.device_mesh
    local = [t.redistribute(mesh, pl).to_local() for t, pl in others]
    out = fn(x.redistribute(mesh, out_pl).to_local(), *local)
    shape = list(x.shape[:2]) + list(out.shape[2:])
    for i, p in enumerate(out_pl):
        if p.is_shard() and p.dim >= 2:
            shape[p.dim] *= mesh.size(i)
    shape = torch.Size(shape)
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _attention_on_local_rows(attend, q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, q_offset: int
                             ) -> torch.Tensor:
    """`attend(q, k, v, q_offset=...)` on DTensors, rank by rank
    (`_on_local_rows`): each rank attends its rows of q (q as it lies: batch
    and, after the reference's `attn_seq` constraint, its sequence
    sharded) to the whole sequence of k and v within its batch shard (the
    reference keeps k and v replicated there), its first row's absolute
    position its offset.  The output lies as q.  DTensor has no sharding
    rule for the products of the attention on a sequence-sharded q (its
    einsums flatten the sharded sequence with the heads into a strided
    shard); GSPMD partitions the same region this way.

    A k or v whose sequence is sharded (a decode cache under `kv_seq`) is
    resharded as GSPMD does it: an all-to-all moves its split from the
    sequence to the KV heads on the same mesh dimensions, q's heads take
    those dimensions too, and each rank attends its heads over the whole
    sequence; the output lies on its heads."""
    from torch.distributed.tensor import Replicate, Shard

    seq_dims = {i for t in (k, v) for i, p in enumerate(t.placements)
                if p.is_shard() and p.dim == 1}
    if seq_dims:
        kv_heads = k.shape[2]
        parts = math.prod(k.device_mesh.size(i) for i in seq_dims)
        if kv_heads % parts:
            raise ValueError(
                f"attention over a sequence-sharded k / v (placements "
                f"{tuple(k.placements)}, {tuple(v.placements)}): its "
                f"{kv_heads} KV heads do not split over the {parts} ranks "
                f"of mesh dimensions {sorted(seq_dims)}")
        q_pl = tuple(Shard(2) if i in seq_dims
                     else p if p.is_shard() and p.dim == 0 else Replicate()
                     for i, p in enumerate(q.placements))
        kv_pl = q_pl
    else:
        q_pl = tuple(p if p.is_shard() and p.dim in (0, 1) else Replicate()
                     for p in q.placements)
        kv_pl = tuple(p if p.is_shard() and p.dim == 0 else Replicate()
                      for p in q_pl)
    # q's rows are whole on each rank where its heads split
    first = 0 if seq_dims else _first_row(q, 1) or 0
    return _on_local_rows(
        lambda ql, kl, vl: attend(ql, kl, vl, q_offset=q_offset + first),
        q, q_pl, (k, kv_pl), (v, kv_pl))


def embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """`table[tokens]`.  On a DTensor table, rank by rank: each rank looks
    its tokens up in its own rows of the table (its vocabulary shard,
    the columns gathered), a token outside them giving zeros, and the
    ranks' rows are summed where the vocabulary is split (a
    vocabulary-parallel lookup; the gradient is each rank's rows, summed
    over the batch's shards).  DTensor's own rules for an index into a
    sharded table and its backward's accumulate differ between versions
    (and fail in some)."""
    if not _is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    rows = [p.is_shard() and p.dim == 0 for p in table.placements]
    batch = [_is_dtensor(tokens) and p.is_shard() and p.dim == 0
             for p in (tokens.placements if _is_dtensor(tokens)
                       else table.placements)]
    split = [i for i, r in enumerate(rows) if r and mesh.size(i) > 1]
    t_pl = tuple(Shard(0) if r else Replicate() for r in rows)
    k_pl = tuple(tokens.placements) if _is_dtensor(tokens) else None
    out_pl = tuple(Shard(0) if b else Partial() if i in split
                   else Replicate() for i, b in enumerate(batch))
    grad_pl = tuple(Shard(0) if r else Partial() if b else Replicate()
                    for r, b in zip(rows, batch))
    first = 0
    for i in split:
        first = first * mesh.size(i) + mesh.get_local_rank(i)

    def look_up(t, k):
        if not split:
            return t[k]
        idx = k - first * t.shape[0]
        inside = (idx >= 0) & (idx < t.shape[0])
        return torch.where(inside[..., None], t[torch.where(inside, idx, 0)],
                           0)

    return local_map(look_up, out_placements=(out_pl,),
                     in_placements=(t_pl, k_pl),
                     in_grad_placements=(grad_pl, k_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def local_block_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, window: int,
                          rt: Optional["Runtime"] = None) -> torch.Tensor:
    """Sliding-window causal attention, block-banded: query block n (of
    `w = min(window, S)` rows) attends to key blocks n - 1 and n, masked
    to `0 <= i - j < window`; block 0's previous block is zeros, masked
    off.  O(S x window) work.

    The reference builds the scores of all blocks at once
    (`[B, n, KV, G, w, 2w]` fp32: 8.6 GB for recurrentgemma at S 32768);
    here a loop over the query blocks does the same arithmetic one block
    at a time, so the scores of one block are alive at once."""
    B, S, H, hd = q.shape
    w = min(window, S)
    nblk = -(-S // w)
    pad = nblk * w - S
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    KV = k.shape[2]
    G = H // KV
    if rt is not None and nblk % shard_count(q, 1):
        # a sequence split that cuts a block: the batch alone first, as k
        # and v (the site below splits each block's rows)
        q = rt.shard(q, "batch")
    qb = (q * (1.0 / math.sqrt(hd))).reshape(B, nblk, w, KV, G, hd)
    kb = k.reshape(B, nblk, w, KV, hd)
    vb = v.reshape(B, nblk, w, KV, hd)
    if rt is not None:
        # the within-block query dim, whatever the block count
        qb = rt.shard(qb, "batch", None, "attn_seq")
    dev = q.device
    qpos = torch.arange(w, device=dev)[:, None]
    kpos = torch.arange(2 * w, device=dev)[None, :] - w
    mask = (qpos >= kpos) & (qpos - kpos < window)
    mask_first = mask & (kpos >= 0)                     # no previous block
    outs = []
    for n in range(nblk):
        k_prev = kb[:, n - 1] if n else torch.zeros_like(kb[:, 0])
        v_prev = vb[:, n - 1] if n else torch.zeros_like(vb[:, 0])
        k2 = torch.cat([k_prev, kb[:, n]], dim=1)       # [B, 2w, KV, hd]
        v2 = torch.cat([v_prev, vb[:, n]], dim=1)
        s = _gqa_scores(qb[:, n], k2)                   # [B,KV,G,w,2w]
        s = s.masked_fill(~(mask_first if n == 0 else mask), -math.inf)
        p = torch.softmax(s, dim=-1)
        outs.append(_gqa_values(p, v2).to(q.dtype))     # [B,w,KV,G,hd]
    o = torch.stack(outs, dim=1).reshape(B, nblk * w, H, hd)
    return o[:, :S]


def f8_bits(x: torch.Tensor) -> torch.Tensor:
    """`x.astype(float8_e4m3fn)` as XLA casts it, as `uint8` bits: round
    to nearest even, and NaN past 464 in magnitude (infinities included),
    where torch's cast saturates at +-448."""
    bits = x.to(torch.float8_e4m3fn).view(torch.uint8)
    return torch.where(x.abs() > 464, bits | 0x7F, bits)


def _write_position(cache: torch.Tensor, new: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
    if cache.dtype == torch.float8_e4m3fn:
        cache.view(torch.uint8).index_copy_(1, pos.reshape(1),
                                            f8_bits(new))
        return cache
    return cache.index_copy_(1, pos.reshape(1), new.to(cache.dtype))


def kv_cache_write(cache: torch.Tensor, new: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    """Write `new` [B, 1, ...] into `cache` [B, S, ...] at seq position
    `pos` (a 0-d int64 tensor on the cache's device), in place (the
    reference returns a new buffer; writing in place saves a copy of the
    whole cache per layer and step).  An f8 cache is written through a
    `uint8` view, with `f8_bits(new)` (`index_copy_` has no f8 kernel):
    bit for bit the reference's `new.astype(cache.dtype)`.

    A DTensor cache is written rank by rank, each its own shard; one whose
    sequence is split (the rules' `kv_seq`) as the reference writes it
    there, a masked select into a new buffer over the rank's positions: a
    write at a runtime index has no partitioned form."""
    if not _is_dtensor(cache):
        return _write_position(cache, new, pos)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(cache.placements)
    first = _first_row(cache, 1)

    def write(c, n, p):
        if first is None:
            return _write_position(c, n, p)
        iota = torch.arange(c.shape[1], device=c.device) + first
        mask = (iota == p).reshape((1, -1) + (1,) * (c.ndim - 2))
        if c.dtype == torch.float8_e4m3fn:
            return torch.where(mask, f8_bits(n),
                               c.view(torch.uint8)).view(c.dtype)
        return torch.where(mask, n.to(c.dtype), c)

    new_pl = tuple(Replicate() if q.is_shard() and q.dim == 1 else q
                   for q in pl)
    return local_map(write, out_placements=(pl,),
                     in_placements=(pl, new_pl, (Replicate(),) * len(pl)
                                    if _is_dtensor(pos) else None),
                     device_mesh=cache.device_mesh,
                     redistribute_inputs=True)(cache, new, pos)


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
                hd: int, rt: Runtime, q_axes: Tuple[Optional[str], ...] = (
                    "batch", "attn_seq")
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v [B, S, heads, hd] in the compute dtype.  Over a mesh whose
    `qkv_fused` split cuts a head, q first takes `q_axes` (the
    reference's next constraint on q: context parallelism in the
    full-sequence forms, the batch alone in a decode step) and k and v
    the batch alone (the reference keeps them replicated within a batch
    shard)."""
    cd = rt.compute_dtype

    def proj(w, b, n, axes):
        y = cd_matmul(x, w, cd)
        if b is not None:
            y = y + b.float()
        y = rt.shard(y.to(cd), "batch", None, "qkv_fused")
        return split_heads(y, n, hd, rt, *axes)

    q = proj(p["wq"], p.get("bq"), n_heads, q_axes)
    k = proj(p["wk"], p.get("bk"), n_kv, ("batch",))
    v = proj(p["wv"], p.get("bv"), n_kv, ("batch",))
    return q, k, v


def project_rows(x: torch.Tensor, w: torch.Tensor,
                 cd: torch.dtype) -> torch.Tensor:
    """`cd_matmul(x, w, cd)` for x [B, S, f].  On a DTensor x whose
    sequence is split (an attention's output at the reference's
    `attn_seq` constraint), rank by rank, each its rows against the whole
    of w: DTensor cannot flatten a split sequence with the batch into a
    product's rows in every version."""
    if not (_is_dtensor(x) and any(p.is_shard() and p.dim == 1
                                   for p in x.placements)):
        return cd_matmul(x, w, cd)
    from torch.distributed.tensor import Replicate
    x_pl = tuple(p if p.is_shard() and p.dim in (0, 1) else Replicate()
                 for p in x.placements)
    return _on_local_rows(lambda xl, wl: cd_matmul(xl, wl, cd), x, x_pl,
                          (w, (Replicate(),) * len(x_pl)))


def gqa_out(p: Params, attn: torch.Tensor, rt: Runtime) -> torch.Tensor:
    B, S, H, hd = attn.shape
    y = project_rows(attn.reshape(B, S, H * hd), p["wo"], rt.compute_dtype)
    return rt.shard(y.to(rt.compute_dtype), "batch", None, "act_embed")


def gqa_attention_train(p: Params, x: torch.Tensor, *, n_heads: int,
                        n_kv: int, hd: int, rope_theta: float, rt: Runtime,
                        causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    with obs.span("attn"):
        B, S, _ = x.shape
        q, k, v = gqa_project(p, x, n_heads, n_kv, hd, rt)
        pos = torch.arange(S, device=x.device)[None, :]
        cos, sin = rope_cos_sin(pos, hd, rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        # context parallelism: the q sequence on the model axis (any head
        # count); k and v stay replicated within the batch shard
        q = rt.shard(q, "batch", "attn_seq")
        with obs.span("attn.core"):
            if window and window < S:
                o = local_block_attention(q, k, v, window, rt=rt)
            elif rt.use_kernels:
                from repro_torch.kernels.flash_attention import (
                    flash_attention)
                no_kernel_backward("flash_attention", q, k, v)
                no_kernel_on_dtensor("flash_attention", q, k, v)
                o = flash_attention(q, k, v, causal=causal)
            else:
                o = blocked_attention(q, k, v, causal=causal,
                                      kv_block=rt.attn_kv_block)
        o = rt.shard(o, "batch", "attn_seq")
        return gqa_out(p, o, rt)


def gqa_attention_decode(p: Params, x: torch.Tensor,
                         cache: Dict[str, torch.Tensor],
                         pos: torch.Tensor, *,
                         n_heads: int, n_kv: int, hd: int, rope_theta: float,
                         rt: Runtime, window: int = 0
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode with a statically-sized KV cache.

    cache = {"k": [B, S_max, KV, hd], "v": ...}, written in place; `pos`
    (a 0-d int64 tensor on the device, as the reference's traced scalar)
    is the position of the new token.  For window attention the cache is
    a ring buffer of `window` slots."""
    B = x.shape[0]
    q, k_new, v_new = gqa_project(p, x, n_heads, n_kv, hd, rt,
                                  q_axes=("batch",))
    cos, sin = rope_cos_sin(pos.reshape(1, 1), hd, rope_theta)
    q = apply_rope(q, cos, sin)
    k_new = apply_rope(k_new, cos, sin)
    S_max = cache["k"].shape[1]
    slot = pos % S_max if window else pos
    k = kv_cache_write(cache["k"], k_new, slot)
    v = kv_cache_write(cache["v"], v_new, slot)
    k = rt.shard(k, "batch", "kv_seq")
    v = rt.shard(v, "batch", "kv_seq")

    G = n_heads // n_kv
    # the token's q whole on each batch shard, as k and v: the scores
    # contract it with every rank's part of a sequence-split cache, and
    # its heads, grouped by KV head below, need not split evenly
    qs = rt.shard(q * (1.0 / math.sqrt(hd)), "batch")
    qg = qs.reshape(B, 1, n_kv, G, hd)
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
    p_attn = softmax_last(s)
    o = _gqa_values(p_attn, v).reshape(B, 1, n_heads, hd)
    y = gqa_out(p, o.to(rt.compute_dtype), rt)
    return y, {"k": k, "v": v}


# ============================================================== MLA attention

def mla_specs(d: int, n_heads: int, kv_lora: int, nope: int, rope_d: int,
              v_hd: int) -> Dict[str, Spec]:
    return {
        "wq": Spec((d, n_heads * (nope + rope_d)), ("embed", "qkv_fused")),
        "wdkv": Spec((d, kv_lora + rope_d), ("embed", None)),
        "wukv": Spec((kv_lora, n_heads * (nope + v_hd)),
                     (None, "qkv_fused")),
        "wo": Spec((n_heads * v_hd, d), ("qkv_fused", "embed")),
        "kv_norm": Spec((kv_lora,), (None,), "ones"),
    }


def mla_attention_train(p: Params, x: torch.Tensor, *, n_heads: int,
                        kv_lora: int, nope: int, rope_d: int, v_hd: int,
                        rope_theta: float, eps: float, rt: Runtime
                        ) -> torch.Tensor:
    """Multi-head latent attention, expanded: the latent `c_kv` (normed)
    is projected up to every head's k_nope and v, the shared RoPE key is
    broadcast to the heads, and the causal attention over q/k of width
    `nope + rope_d` and v of width `v_hd` is `blocked_attention` (no
    kernel, under `use_kernels` too, as in the reference)."""
    with obs.span("attn"):
        cd = rt.compute_dtype
        B, S, _ = x.shape
        q = cd_matmul(x, p["wq"], cd).to(cd)
        q = rt.shard(q, "batch", None, "qkv_fused")
        q = split_heads(q, n_heads, nope + rope_d, rt, "batch", "attn_seq")
        q_nope, q_rope = q[..., :nope], q[..., nope:]

        ckv = cd_matmul(x, p["wdkv"], cd)
        c_kv, k_rope = ckv[..., :kv_lora], ckv[..., kv_lora:]
        c_kv = rms_norm(c_kv.to(cd), p["kv_norm"], eps)
        kv = cd_matmul(c_kv, p["wukv"], cd).to(cd)
        kv = rt.shard(kv, "batch", None, "qkv_fused")
        kv = split_heads(kv, n_heads, nope + v_hd, rt, "batch")
        k_nope, v = kv[..., :nope], kv[..., nope:]

        pos = torch.arange(S, device=x.device)[None, :]
        cos, sin = rope_cos_sin(pos, rope_d, rope_theta)
        q_rope = apply_rope(q_rope, cos, sin)
        k_rope = apply_rope(k_rope.to(cd)[:, :, None, :], cos, sin)
        k_rope_b = k_rope.expand(B, S, n_heads, rope_d)

        qf = torch.cat([q_nope, q_rope], -1)
        kf = torch.cat([k_nope, k_rope_b], -1)
        qf = rt.shard(qf, "batch", "attn_seq")
        # the scale is 1/sqrt(nope + rope_d), the full qk head dim
        with obs.span("attn.core"):
            o = blocked_attention(qf, kf, v, causal=True,
                                  kv_block=rt.attn_kv_block)
        o = rt.shard(o, "batch", "attn_seq")
        y = project_rows(o.reshape(B, S, n_heads * v_hd), p["wo"], cd)
        return rt.shard(y.to(cd), "batch", None, "act_embed")


def mla_attention_decode(p: Params, x: torch.Tensor,
                         cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                         *, n_heads: int, kv_lora: int, nope: int,
                         rope_d: int, v_hd: int, rope_theta: float,
                         eps: float, rt: Runtime
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weight-absorbed MLA decode over the latent cache: cache = {"ckv":
    [B, S_max, kv_lora], "krope": [B, S_max, rope_d]} (bf16, written in
    place).  W_uk is absorbed into the query and W_uv applied after the
    attention, so the cache holds `kv_lora + rope_d` numbers a token.  The
    products take their operands in the compute dtype and accumulate in
    fp32 (the bf16 cache widened exactly), as the reference's
    `preferred_element_type`."""
    cd = rt.compute_dtype
    B = x.shape[0]
    q = cd_matmul(x, p["wq"], cd).to(cd)
    q = q.reshape(B, 1, n_heads, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    cos, sin = rope_cos_sin(pos.reshape(1, 1), rope_d, rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)

    ckv = cd_matmul(x, p["wdkv"], cd)
    c_new, kr_new = ckv[..., :kv_lora], ckv[..., kv_lora:]
    c_new = rms_norm(c_new.to(cd), p["kv_norm"], eps)
    kr_new = apply_rope(kr_new.to(cd)[:, :, None, :], cos, sin)[:, :, 0]

    c_cache = kv_cache_write(cache["ckv"], c_new, pos)
    r_cache = kv_cache_write(cache["krope"], kr_new, pos)
    c_cache = rt.shard(c_cache, "batch", "kv_seq")
    r_cache = rt.shard(r_cache, "batch", "kv_seq")

    # absorb W_uk into q: q_lat[h] = q_nope[h] @ W_uk[h]^T (a lora-dim query)
    wukv = p["wukv"].to(cd).reshape(kv_lora, n_heads, nope + v_hd)
    w_uk = wukv[..., :nope]                      # [lora, H, nope]
    w_uv = wukv[..., nope:]                      # [lora, H, v_hd]
    q_lat = torch.einsum("bqhn,lhn->bqhl", q_nope.float(), w_uk.float())

    scale = 1.0 / math.sqrt(nope + rope_d)
    c32 = c_cache.float()
    s = (torch.einsum("bqhl,bsl->bhqs", q_lat.to(cd).float(), c32)
         + torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                        r_cache.float())) * scale
    valid = torch.arange(c_cache.shape[1], device=x.device) <= pos
    s = s.masked_fill(~valid, -math.inf)
    pr = softmax_last(s)
    o_lat = torch.einsum("bhqs,bsl->bqhl", pr.to(cd).float(), c32)
    o = torch.einsum("bqhl,lhv->bqhv", o_lat.to(cd).float(), w_uv.float())
    y = cd_matmul(o.to(cd).reshape(B, 1, n_heads * v_hd), p["wo"], cd)
    return (rt.shard(y.to(cd), "batch", None, "act_embed"),
            {"ckv": c_cache, "krope": r_cache})


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
    h = rt.shard(h, "batch", None, "ff")
    return rt.shard(cd_matmul(h, p["w2"], cd).to(cd),
                    "batch", None, "act_embed")


def gelu_mlp_specs(d: int, f: int) -> Dict[str, Spec]:
    return {
        "w1": Spec((d, f), ("embed", "ff")),
        "b1": Spec((f,), ("ff",), "zeros"),
        "w2": Spec((f, d), ("ff", "embed")),
        "b2": Spec((d,), ("embed",), "zeros"),
    }


def gelu_mlp(p: Params, x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """Two projections with fp32 biases after each and the tanh GeLU
    (`jax.nn.gelu`) between them."""
    cd = rt.compute_dtype
    h = cd_matmul(x, p["w1"], cd) + p["b1"].float()
    h = F.gelu(h, approximate="tanh").to(cd)
    h = rt.shard(h, "batch", None, "ff")
    y = cd_matmul(h, p["w2"], cd) + p["b2"].float()
    return rt.shard(y.to(cd), "batch", None, "act_embed")


# ====================================================================== MoE

def moe_specs(d: int, n_experts: int, d_expert: int,
              n_shared: int) -> Dict[str, Any]:
    s: Dict[str, Any] = {
        "router": Spec((d, n_experts), ("embed", None)),
        "we1": Spec((n_experts, d, d_expert), ("experts", "embed", None)),
        "we3": Spec((n_experts, d, d_expert), ("experts", "embed", None)),
        "we2": Spec((n_experts, d_expert, d), ("experts", None, "embed")),
    }
    if n_shared:
        s["shared"] = swiglu_specs(d, d_expert * n_shared)
    return s


def moe_capacity(group: int, top_k: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Slots an expert has in a group: ceil(group k / E x factor), rounded
    up to a multiple of 8, at least 8."""
    cap = int(math.ceil(group * top_k / n_experts * capacity_factor))
    return max(8, -(-cap // 8) * 8)


def moe_route(p: Params, xg: torch.Tensor, *, n_experts: int, top_k: int,
              cap: int, normalize_gates: bool, rt: Runtime
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token-choice routing of xg [G, T, D]: (gate [G, T, k] fp32, e_flat
    [G, T*k] the chosen experts, slot [G, T*k]).  The router's logits and
    softmax are fp32 from compute-dtype inputs; the slots are
    `moe_slots`'s, a dropped pair's `E * cap`, past every expert's
    slots."""
    cd = rt.compute_dtype
    G, T, _ = xg.shape
    logits = torch.matmul(xg.to(cd).float(), p["router"].to(cd).float())
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, top_k, dim=-1)       # [G, T, k]
    if normalize_gates:
        gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    e_flat = eidx.reshape(G, T * top_k)
    return gate, e_flat, moe_slots(e_flat, n_experts, cap)


def _one_hot(x: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    return (x[..., None] == torch.arange(n, device=x.device)).to(dtype)


def one_hot(x: torch.Tensor, n: int,
            dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """`F.one_hot(x, n)` in `dtype` (int64, as `F.one_hot`), in
    `jax.nn.one_hot`'s form, a compare with an `arange`: the same ops on
    real and fake tensors (`F.one_hot` checks the indices' range on the
    host and scatters on real ones), and to the frontend one vertex, as
    the reference's nested `jit`."""
    return nested_jit("onehot", _one_hot, x, n, dtype)


def moe_slots(e_flat: torch.Tensor, n_experts: int, cap: int
              ) -> torch.Tensor:
    """Each (token, choice) pair's slot [G, T*k] from its expert e_flat
    [G, T*k]: its position within the expert is the cumsum of the one-hot
    over the token-major order, and a pair at a position >= `cap` is
    dropped, its slot `E * cap`."""
    onehot = one_hot(e_flat, n_experts).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) * onehot
    pos = pos.sum(-1, dtype=torch.int32) - 1            # place in expert
    return torch.where(pos < cap, e_flat * cap + pos, n_experts * cap)


def assert_unique_slots(slot: torch.Tensor, n_slots: int) -> None:
    """Each of the `n_slots` expert slots of a group takes at most one
    (token, choice) pair; `slot` [G, T*k], where `n_slots` marks a dropped
    pair.  Checked on the device without a sync (`_assert_async`)."""
    hits = torch.zeros((slot.shape[0], n_slots + 1), dtype=slot.dtype,
                       device=slot.device).scatter_add_(
        1, slot, torch.ones_like(slot))
    torch._assert_async((hits[:, :n_slots] <= 1).all())


def _per_group(fn, n_out: int, *args, whole=()):
    """`fn(*args)`, or on DTensors rank by rank (`local_map`): each rank
    runs `fn` on its own groups (the leading dimension of every argument,
    lying as the first argument's), with the arguments at the positions
    in `whole` gathered whole.  The MoE block's routing, dispatch and
    combine are per group; DTensor has no rule for their index scatter in
    every version, and this is how GSPMD partitions them."""
    if not _is_dtensor(args[0]):
        return fn(*args)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    groups = tuple(p if p.is_shard() and p.dim == 0 else Replicate()
                   for p in args[0].placements)
    rep = (Replicate(),) * len(groups)
    return local_map(fn, out_placements=(groups,) * n_out,
                     in_placements=tuple(rep if i in whole else groups
                                         for i in range(len(args))),
                     device_mesh=args[0].device_mesh,
                     redistribute_inputs=True)(*args)


def _moe_dispatch(xg: torch.Tensor, router: torch.Tensor, *,
                  n_experts: int, top_k: int, cap: int,
                  normalize_gates: bool, rt: Runtime
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Route groups xg [G, T, D] (`moe_route`) and gather each expert's
    slots: (gate [G, T, k], slot [G, T*k], buf [G, E, C, D] in the
    compute dtype), by an index scatter into `slot_to_src` (only the
    padding column, sliced off after, takes more than one write), then a
    token gather.  With `obs` metrics on, it counts the (token, choice)
    pairs routed, the expert slots, and the pairs dropped at capacity (a
    0-d tensor, summed on the device without a sync)."""
    G, gsz, D = xg.shape
    n_slots = n_experts * cap
    with obs.span("moe.route"):
        gate, _, slot = moe_route({"router": router}, xg,
                                  n_experts=n_experts, top_k=top_k, cap=cap,
                                  normalize_gates=normalize_gates, rt=rt)
    with obs.span("moe.dispatch"):
        if obs.metrics().enabled:
            obs.counter("moe.pairs_routed", G * gsz * top_k)
            obs.counter("moe.slots", G * n_slots)
            obs.counter("moe.pairs_dropped", (slot >= n_slots).sum())
        dev = xg.device
        src_tok = torch.arange(gsz, device=dev)[None, :, None].expand(
            G, gsz, top_k).reshape(G, gsz * top_k)
        gidx = torch.arange(G, device=dev)[:, None]
        if slot.is_cuda:    # duplicate in-range writes would race on the card
            assert_unique_slots(slot, n_slots)
        slot_to_src = torch.full((G, n_slots + 1), gsz, dtype=torch.int64,
                                 device=dev)
        slot_to_src[gidx, slot] = src_tok
        # the reference's constraint: the slots lie as their groups (a
        # plain tensor, a rank's own groups, passes through)
        slot_to_src = rt.shard(slot_to_src[:, :-1], "batch")  # [G, E*C]
        x_pad = torch.cat([xg, torch.zeros((G, 1, D), dtype=xg.dtype,
                                           device=dev)], 1)
        buf = torch.take_along_dim(x_pad, slot_to_src[..., None], dim=1)
        return gate, slot, buf.reshape(G, n_experts, cap, D).to(
            rt.compute_dtype)


def _moe_combine(y_e: torch.Tensor, slot: torch.Tensor, gate: torch.Tensor,
                 cd: torch.dtype, first: Optional[int] = None
                 ) -> torch.Tensor:
    """Each (token, choice)'s expert output gathered back from y_e
    [G, E, C, D], a dropped pair giving zero, weighted by its gate and
    summed over the k choices: [G, T, D].  With `first`, y_e holds the
    experts from slot `first` on only (a rank's expert shard), and a pair
    routed elsewhere gives zero too."""
    G, E, C, D = y_e.shape
    n_slots = E * C
    top_k = gate.shape[-1]
    y_flat = y_e.reshape(G, n_slots, D)
    if first is None:
        safe_slot = torch.clamp_max(slot, n_slots - 1)
        dropped = (slot >= n_slots)[..., None]
    else:
        slot = slot - first
        safe_slot = torch.clamp(slot, 0, n_slots - 1)
        dropped = ((slot < 0) | (slot >= n_slots))[..., None]
    y_rep = torch.take_along_dim(y_flat, safe_slot[..., None], dim=1)
    y_rep = torch.where(dropped, torch.zeros((), dtype=cd,
                                             device=y_e.device), y_rep)
    return (y_rep.reshape(G, slot.shape[1] // top_k, top_k, D)
            * gate[..., None].to(cd)).sum(dim=2)


def _combine_by_experts(y_e: torch.Tensor, slot: torch.Tensor,
                        gate: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """`_moe_combine`; on DTensors rank by rank: each rank combines its
    groups' pairs routed to its own experts, and the ranks' partial sums
    over the expert shards are added (expert parallelism: the output
    reduced, not the experts' outputs gathered)."""
    if not _is_dtensor(y_e):
        return _moe_combine(y_e, slot, gate, cd)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    groups = tuple(p if p.is_shard() and p.dim == 0 else Replicate()
                   for p in slot.placements)
    first = _first_row(y_e, 1)
    y_pl = tuple(p if p.is_shard() and p.dim in (0, 1) else Replicate()
                 for p in y_e.placements)
    out = tuple(Partial() if p.is_shard() and p.dim == 1 else g
                for p, g in zip(y_pl, groups))
    cap = y_e.shape[2]
    return local_map(
        functools.partial(_moe_combine, cd=cd,
                          first=None if first is None else first * cap),
        out_placements=(out,), in_placements=(y_pl, groups, groups),
        device_mesh=y_e.device_mesh, redistribute_inputs=True)(
        y_e, slot, gate)


def moe_block(p: Params, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float, normalize_gates: bool, rt: Runtime
              ) -> torch.Tensor:
    """Token-choice top-k MoE with capacity dropping, the reference's
    function: tokens routed in groups of `min(rt.moe_group_size, B*S)`
    and dispatched (`_moe_dispatch`), the experts' SwiGLU as three
    batched products, and combined (`_moe_combine`) in the compute dtype.
    With "shared" in `p`, the shared experts' SwiGLU is added.

    Over a mesh the groups lie on the batch axes, as the reference's
    constraints put them, and each rank routes, dispatches and combines
    its own groups (`_per_group`); the experts' products run on the
    experts' shards.  Where there are fewer groups than batch shards (a
    decode step's few tokens), GSPMD pads the group dimension and each
    device routes one group, real or padding: here every rank routes the
    groups whole (the group dimension replicated, as is a single group),
    the same work a rank."""
    with obs.span("moe"):
        cd = rt.compute_dtype
        B, S, D = x.shape
        T = B * S
        gsz = min(rt.moe_group_size, T)
        n_groups = -(-T // gsz)
        assert T % gsz == 0, (T, gsz)
        g_axis = "batch" if n_groups > 1 and \
            n_groups % rt.axis_size("batch") == 0 else None
        xg = rt.shard(x.reshape(n_groups, gsz, D), g_axis, None, None)
        cap = moe_capacity(gsz, top_k, n_experts, capacity_factor)
        gate, slot, buf = _per_group(
            functools.partial(_moe_dispatch, n_experts=n_experts,
                              top_k=top_k, cap=cap,
                              normalize_gates=normalize_gates, rt=rt),
            3, xg, p["router"], whole=(1,))
        buf = rt.shard(buf, g_axis, "experts")

        with obs.span("moe.experts"):
            g1 = torch.einsum("gecd,edf->gecf", buf, p["we1"].to(cd)).float()
            u1 = torch.einsum("gecd,edf->gecf", buf, p["we3"].to(cd)).float()
            h = rt.shard((F.silu(g1) * u1).to(cd), g_axis, "experts")
            y_e = torch.einsum("gecf,efd->gecd", h, p["we2"].to(cd)).to(cd)
            y_e = rt.shard(y_e, g_axis, "experts")

        with obs.span("moe.combine"):
            y = _combine_by_experts(y_e, slot, gate, cd).reshape(B, S, D)
        if "shared" in p:
            with obs.span("moe.shared"):
                y = y + swiglu(p["shared"], x, rt)
        return rt.shard(y, "batch", None, "act_embed")


# ================================================================== RG-LRU

def rglru_specs(d: int, w: int, n_heads: int, conv_w: int) -> Dict[str, Spec]:
    hd = w // n_heads
    return {
        "wx": Spec((d, w), ("embed", "lru")),
        "wy": Spec((d, w), ("embed", "lru")),          # gelu gate branch
        "conv_w": Spec((conv_w, w), (None, "lru"), "small"),
        "conv_b": Spec((w,), ("lru",), "zeros"),
        # block-diagonal (per-head) recurrence & input gates
        "wa": Spec((n_heads, hd, hd), (None, None, None), "small"),
        "ba": Spec((w,), ("lru",), "zeros"),
        "wi": Spec((n_heads, hd, hd), (None, None, None), "small"),
        "bi": Spec((w,), ("lru",), "zeros"),
        "a_param": Spec((w,), ("lru",), "rglru_a"),
        "wout": Spec((w, d), ("lru", "embed")),
    }


_RGLRU_C = 8.0


def _rglru_gate_logits(p: Params, xb: torch.Tensor, n_heads: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-diagonal gate projections before their biases; xb [B, S, W]
    fp32 -> ra, ri [B, S, heads, W / heads] fp32, as the einsum leaves
    them (on the card a head-major view)."""
    B, S, W = xb.shape
    hd = W // n_heads
    xh = xb.reshape(B, S, n_heads, hd)
    ra = torch.einsum("bshi,hij->bshj", xh, p["wa"].float())
    ri = torch.einsum("bshi,hij->bshj", xh, p["wi"].float())
    return ra, ri


def _rglru_gate_sigmoids(p: Params, ra: torch.Tensor, ri: torch.Tensor,
                         shape: torch.Size
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gates r, i [B, S, W] from their logits and biases."""
    r = torch.sigmoid(ra.reshape(shape) + p["ba"].float())
    i = torch.sigmoid(ri.reshape(shape) + p["bi"].float())
    return r, i


def _rglru_gates(p: Params, xb: torch.Tensor, n_heads: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-diagonal gate projections; xb [B, S, W] fp32."""
    ra, ri = _rglru_gate_logits(p, xb, n_heads)
    return _rglru_gate_sigmoids(p, ra, ri, xb.shape)


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over seq; x [B,S,W], w [K,W].  `prefix`
    [B,K-1,W] supplies decode-time history.  A shifted sum, the K terms
    added in order and then the bias, as the reference adds them (no
    `F.conv1d`: on the card it goes through cuDNN, in TF32 by default)."""
    K, S = w.shape[0], x.shape[1]
    if prefix is None:
        prefix = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                             device=x.device)
    xp = torch.cat([prefix, x], dim=1)
    out = sum(xp[:, i:i + S] * w[i].to(x.dtype) for i in range(K))
    return out + b.to(x.dtype)


def _rglru_decay(p: Params, r: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a = exp(log_a) and beta = sqrt(max(1 - a^2, 1e-6)), fp32, with
    log_a = -8 softplus(a_param) r.  softplus is the reference's
    logaddexp(x, 0): `F.softplus` returns x itself above its threshold of
    20, a difference below an fp32 ulp there, but not the same function."""
    a_param = p["a_param"].float()
    log_a0 = -_RGLRU_C * torch.logaddexp(a_param, torch.zeros_like(a_param))
    log_a = log_a0 * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6))
    return a, beta


def rglru_scan_inputs(p: Params, x: torch.Tensor, *, n_heads: int,
                      rt: Runtime
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The full-sequence block up to its scan: (a, b, gate), each
    [B, S, W] fp32, where the scan's h_t = a_t h_{t-1} + b_t."""
    xc, ra, ri, gate = rglru_gated_inputs(p, x, n_heads=n_heads, rt=rt)
    r, i = _rglru_gate_sigmoids(p, ra, ri, xc.shape)
    a, beta = _rglru_decay(p, r)
    return a, beta * (i * xc), gate.float()


def rglru_gated_inputs(p: Params, x: torch.Tensor, *, n_heads: int,
                       rt: Runtime
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """The full-sequence block up to the kernel `rglru_gated_scan`: (xc,
    ra, ri, gate) — the conv output [B, S, W] fp32, the gate logits
    [B, S, heads, W / heads] fp32 as the einsums leave them, and the GeLU
    branch's product [B, S, W] in the compute dtype (the kernel widens it
    to fp32 in its loads, exactly)."""
    cd = rt.compute_dtype
    xb = cd_matmul(x, p["wx"], cd)
    gate = cd_matmul(x, p["wy"], cd, out_dtype=cd)
    xb = rt.shard(xb, "batch", None, "lru")
    xc = _causal_conv1d(xb, p["conv_w"], p["conv_b"])
    ra, ri = _rglru_gate_logits(p, xc, n_heads)
    return xc, ra, ri, gate


def rglru_output(p: Params, h: torch.Tensor, gate: torch.Tensor,
                 rt: Runtime) -> torch.Tensor:
    """The block after its scan: h times the GeLU gate (the reference's
    `jax.nn.gelu`, the tanh approximation), projected out."""
    cd = rt.compute_dtype
    y = h * F.gelu(gate, approximate="tanh")
    return rt.shard(cd_matmul(y, p["wout"], cd).to(cd),
                    "batch", None, "act_embed")


def rglru_block_train(p: Params, x: torch.Tensor, *, n_heads: int,
                      rt: Runtime) -> torch.Tensor:
    """Griffin recurrent block: conv1d -> RG-LRU, gated by a GeLU branch.
    Under `rt.use_kernels` the gates' biases and sigmoids, the decay, the
    scan and the GeLU gating run in the one kernel `rglru_gated_scan`
    between the gate einsums and the output projection; else the block
    composes them in tensor ops around the scan's plain version (the twin
    of the reference's `associative_scan`)."""
    from repro_torch.kernels import rg_lru
    if not rt.use_kernels:
        a, b, gate = rglru_scan_inputs(p, x, n_heads=n_heads, rt=rt)
        return rglru_output(p, rg_lru.rglru_scan_plain(a, b), gate, rt)
    cd = rt.compute_dtype
    xc, ra, ri, gate = rglru_gated_inputs(p, x, n_heads=n_heads, rt=rt)
    no_kernel_backward("rglru_gated_scan", xc, ra, ri, gate, p["ba"],
                       p["bi"], p["a_param"])
    no_kernel_on_dtensor("rglru_gated_scan", xc, ra, ri, gate)
    y = rg_lru.rglru_gated_scan(xc, ra, ri, gate, p["ba"], p["bi"],
                                p["a_param"], cd)
    return rt.shard(cd_matmul(y, p["wout"], cd).to(cd),
                    "batch", None, "act_embed")


def rglru_block_decode(p: Params, x: torch.Tensor,
                       state: Dict[str, torch.Tensor], *, n_heads: int,
                       rt: Runtime
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One step; state = {"h": [B, W] fp32, "conv": [B, K-1, W] fp32}.
    Returns the output and a new state (the old one is not written)."""
    cd = rt.compute_dtype
    xb = cd_matmul(x, p["wx"], cd)
    gate = cd_matmul(x, p["wy"], cd)
    conv_hist = torch.cat([state["conv"], xb], dim=1)
    xc = _causal_conv1d(xb, p["conv_w"], p["conv_b"], prefix=state["conv"])
    r, i = _rglru_gates(p, xc, n_heads)
    a, beta = _rglru_decay(p, r)
    h = a[:, 0] * state["h"] + (beta * (i * xc))[:, 0]
    y = rglru_output(p, h[:, None, :], gate, rt)
    return y, {"h": h, "conv": conv_hist[:, 1:]}


# =================================================================== xLSTM

# the stabiliser m the full-sequence forms start from, as the reference's
# do; the decode cache's m starts at 0 (`lm.block_cache_specs`)
STABILISER_START = -1e30

# the counters of `launch.steps.count_step` running, innermost last: while
# one is, `scan` runs four steps and the counter counts one for the middle
# ones
STEP_COUNTERS: list = []


def slice_of(t: torch.Tensor, xs: torch.Tensor, i: int) -> bool:
    """Whether `t` is the view `xs[i]` (a scan step's slice of its xs,
    written in place).  DTensors are compared on their local shards, by
    storage (DTensor takes its local views below autograd, where a view
    records no `_base`)."""
    if _is_dtensor(t) != _is_dtensor(xs):
        return False
    if _is_dtensor(t):
        t, xs = t._local_tensor, xs._local_tensor
        same = t.untyped_storage()._cdata == xs.untyped_storage()._cdata
    else:
        same = t._base is (xs if xs._base is None else xs._base)
    return (same and tuple(t.shape) == tuple(xs.shape[1:])
            and t.stride() == xs.stride()[1:]
            and t.storage_offset() == xs.storage_offset() + i * xs.stride(0))


def stack_ys(ys, xs_leaves, slices, nodes):
    """The scan's ys stacked (`scan_stack`), leaf by leaf of the steps'
    outputs (`slices`: each step's xs slices, flat; `nodes`: their graph
    vertices when they were sliced, under `trace_to_graph`).  Outside a
    trace, a leaf that every step passed on as its own slice of an xs
    leaf, or wrote in place into it (a KV cache layer), is that xs leaf,
    not a copy.  Under `trace_to_graph` a leaf passed on unwritten is
    the xs leaf, as jax's scan forwards it (no stack), and a written one
    is stacked, as the reference's scan stacks the written slices."""
    if ys[0] is None:
        return None
    flat = [pytree.tree_flatten(y)[0] for y in ys]
    spec = pytree.tree_flatten(ys[0])[1]
    out = []
    for j in range(len(flat[0])):
        steps = [f[j] for f in flat]
        if tracing():
            same = next((x for k, x in enumerate(xs_leaves) if all(
                t is sl[k] and node_of(t) == nd[k]
                for t, sl, nd in zip(steps, slices, nodes))), None)
        else:
            same = next((x for x in xs_leaves if all(
                slice_of(t, x, i) for i, t in enumerate(steps))), None)
        out.append(same if same is not None else scan_stack(steps))
    return pytree.tree_unflatten(out, spec)


def scan(step, carry, xs):
    """`jax.lax.scan(step, carry, xs)`: `step(carry, x) -> (carry, y)` over
    the leading dimension of the tensors of the pytree `xs` (x the same
    pytree of their slices), returning the last carry and the ys stacked
    (`stack_ys`: None if the steps return None; a slice passed on, or
    written in place, is returned as its xs leaf).  To the frontend the
    loop is the reference's scan (`scan_slices`, `scan_stack`).  Under
    `launch.steps.count_step` every middle step does the same work on
    tensors of the same shapes, so four steps run and one of them is
    counted for the middle ones, backward included (`STEP_COUNTERS`,
    `_Counter.replay_scan`); the output then holds those steps' values
    only, which on fake tensors are none."""
    leaves, spec = pytree.tree_flatten(xs)
    n = leaves[0].shape[0]
    if STEP_COUNTERS and n > 4:
        return STEP_COUNTERS[-1].replay_scan(step, carry, xs, n)
    ys, slices, nodes = [], [], []
    for x in scan_slices(*leaves):
        if tracing():
            nodes.append([node_of(t) for t in x])
        carry, y = step(carry, pytree.tree_unflatten(list(x), spec))
        ys.append(y)
        slices.append(x)
    return carry, stack_ys(ys, leaves, slices, nodes)


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.log_sigmoid`: -softplus(-x), softplus the reference's
    logaddexp(x, 0) (not `F.logsigmoid`)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return -torch.logaddexp(-x, zero)


def mlstm_specs(d: int, n_heads: int) -> Dict[str, Spec]:
    u = 2 * d                                    # proj_factor = 2
    hd = u // n_heads
    return {
        "w_up": Spec((d, u), ("embed", "ff")),
        "w_gate": Spec((d, u), ("embed", "ff")),
        "wq": Spec((n_heads, hd, hd), (None, None, None), "small"),
        "wk": Spec((n_heads, hd, hd), (None, None, None), "small"),
        "wv": Spec((n_heads, hd, hd), (None, None, None), "small"),
        "w_if": Spec((u, 2 * n_heads), ("ff", None), "small"),
        "b_if": Spec((2 * n_heads,), (None,), "zeros"),
        "w_down": Spec((u, d), ("ff", "embed")),
        "ln_inner": Spec((u,), ("ff",), "ones"),
    }


def _mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_i: torch.Tensor, log_f: torch.Tensor, chunk: int,
                     state: Optional[Tuple] = None
                     ) -> Tuple[torch.Tensor, Tuple]:
    """Chunkwise-parallel mLSTM (matrix-memory linear attention with scalar
    per-head exponential input and sigmoid forget gates), the reference's
    function and its ops in order.

    q, k, v [B, S, H, hd]; log_i, log_f [B, S, H].  S is padded to a
    multiple of `chunk` (log_i with -1e9, the rest with 0).  Returns y
    [B, S, H, hd] fp32 and the final (C [B, H, hd, hd], n [B, H, hd],
    m [B, H]); with no `state` the stabiliser starts at -1e30
    (`STABILISER_START`).  The loop
    over chunks is the reference's scan (`scan`).  fp32 gate math
    throughout."""
    B, S, H, hd = q.shape
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=-1e9)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    L = chunk

    def resh(x):
        return x.reshape(B, nc, L, *x.shape[2:]).transpose(0, 1)

    qc, kc, vc = resh(q), resh(k), resh(v)
    lic, lfc = resh(log_i), resh(log_f)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    if state is None:
        C0 = torch.zeros((B, H, hd, hd), device=dev)
        n0 = torch.zeros((B, H, hd), device=dev)
        m0 = torch.full((B, H), STABILISER_START, device=dev)
    else:
        C0, n0, m0 = state

    def step(carry, blk):
        C, n, m = carry
        qb, kb, vb, li, lf = blk                   # [B, L, H, *]
        csum = torch.cumsum(lf, dim=1)             # inclusive cum log f
        total = index_from_end(csum, 1, -1)        # [B, H]
        # decay from j to i (i >= j): csum_i - csum_j + li_j
        dec = (csum[:, :, None, :] - csum[:, None, :, :]
               + li[:, None, :, :])                # [B, Li, Lj, H]
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))
        dec = torch.where(causal[None, :, :, None], dec, -math.inf)
        m_intra = dec.amax(dim=2)                  # [B, Li, H]
        m_inter = csum + m[:, None, :]
        m_new_t = torch.maximum(m_intra, m_inter)  # running per-step max
        d_intra = torch.exp(dec - m_new_t[:, :, None, :])
        d_inter = torch.exp(m_inter - m_new_t)
        q32, k32, v32 = qb.float(), kb.float(), vb.float()

        s = torch.einsum("blhd,bmhd->blmh", q32 * scale, k32)
        sd = s * d_intra
        y_intra = torch.einsum("blmh,bmhd->blhd", sd, v32)
        y_inter = torch.einsum("blhd,bhde->blhe",
                               q32 * scale * d_inter[..., None], C)
        # normalizer: n_l = sum_j D_lj k_j (q enters once, below)
        n_intra = torch.einsum("blmh,bmhd->blhd", d_intra, k32)
        n_inter = n[:, None] * d_inter[..., None]
        num = y_intra + y_inter
        den = torch.abs(torch.einsum("blhd,blhd->blh", q32 * scale,
                                     n_intra + n_inter))
        y = num / torch.maximum(den, torch.exp(-m_new_t))[..., None]

        # carry update (each key's contribution decayed to the chunk end);
        # the reference's three-operand einsum contracts w_key with k
        # first, then with v over the chunk
        m_end = torch.maximum(total + m,
                              (total[:, None] - csum + li).amax(dim=1))
        w_key = torch.exp(total[:, None] - csum + li - m_end[:, None])
        C_new = C * torch.exp(total + m - m_end)[..., None, None] + \
            torch.einsum("blhd,blhe->bhde",
                         torch.einsum("blh,blhd->blhd", w_key, k32), v32)
        n_new = n * torch.exp(total + m - m_end)[..., None] + \
            torch.einsum("blh,blhd->bhd", w_key, k32)
        return (C_new, n_new, m_end), y

    (C, n, m), ys = scan(step, (C0, n0, m0), (qc, kc, vc, lic, lfc))
    y = ys.transpose(0, 1).reshape(B, nc * L, H, hd)[:, :S]
    return y, (C, n, m)


def _head_proj(xh: torch.Tensor, w: torch.Tensor, cd: torch.dtype
               ) -> torch.Tensor:
    """The block-diagonal per-head projection `bshi,hij->bshj` in the
    compute dtype."""
    return torch.einsum("bshi,hij->bshj", xh, w.to(cd))


def mlstm_block_train(p: Params, x: torch.Tensor, *, n_heads: int,
                      eps: float, rt: Runtime) -> torch.Tensor:
    """The mLSTM block over a full sequence: up-projection, per-head q, k,
    v (rounded to the compute dtype), the exponential input and sigmoid
    forget gates (fp32), the chunkwise form, the inner norm, the SiLU
    gate (z in fp32 up to its cast) and the down-projection."""
    cd = rt.compute_dtype
    B, S, _ = x.shape
    u = p["w_up"].shape[1]
    hd = u // n_heads
    xb = cd_matmul(x, p["w_up"], cd, out_dtype=cd)
    z = f32_matmul(x, p["w_gate"], cd)
    xb = rt.shard(xb, "batch", None, "ff")
    xh = split_heads(xb, n_heads, hd, rt, "batch")
    # forward a constraint q, k and v meet; backward, their gradients
    # come out of the chunks with the sequence split, which the
    # projection's rows (batch and sequence flattened) cannot take: they
    # are gathered first (GSPMD reshards there silently, DTensor refuses)
    q, k, v = (rt.shard(_head_proj(xh, p[w], cd).to(cd), "batch")
               for w in ("wq", "wk", "wv"))
    gates = f32_matmul(xb, p["w_if"], cd) + p["b_if"].float()
    log_i, f_pre = gates[..., :n_heads], gates[..., n_heads:]
    log_f = _log_sigmoid(f_pre)
    y, _ = _mlstm_chunkwise(q, k, v, log_i, log_f, rt.mlstm_chunk)
    y = y.reshape(B, S, u)
    if n_heads % rt.axis_size("ff"):
        # the gradient comes back split on "ff", which would cut a head:
        # it is gathered before it is unflattened (GSPMD reshards there
        # silently, DTensor refuses); forward, a constraint y meets
        y = rt.shard(y, "batch")
    y = rms_norm(y.to(cd), p["ln_inner"], eps)
    y = y * F.silu(z).to(cd)
    return rt.shard(cd_matmul(y, p["w_down"], cd, out_dtype=cd),
                    "batch", None, "act_embed")


def mlstm_block_decode(p: Params, x: torch.Tensor,
                       state: Dict[str, torch.Tensor], *, n_heads: int,
                       eps: float, rt: Runtime
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One step of the recurrent form; state = {"C": [B, H, hd, hd],
    "n": [B, H, hd], "m": [B, H]} fp32 (a fresh cache's m is 0, not the
    chunkwise form's -1e30, as in the reference).  q, k, v are products in
    the compute dtype, widened to fp32.  Returns the output and a new
    state (the old one is not written).  At a float64 compute dtype (and
    a float64 state) every step is float64."""
    cd = rt.compute_dtype
    B = x.shape[0]
    u = p["w_up"].shape[1]
    hd = u // n_heads
    acc = acc_dtype(cd)
    xb = cd_matmul(x, p["w_up"], cd, out_dtype=cd)
    z = f32_matmul(x, p["w_gate"], cd)
    if n_heads % shard_count(xb, -1):       # a head cut in two
        xb = rt.shard(xb, "batch")
    xh = xb.reshape(B, n_heads, hd)
    q = torch.einsum("bhi,hij->bhj", xh, p["wq"].to(cd)).to(acc)
    k = torch.einsum("bhi,hij->bhj", xh, p["wk"].to(cd)).to(acc)
    v = torch.einsum("bhi,hij->bhj", xh, p["wv"].to(cd)).to(acc)
    gates = f32_matmul(xb[:, 0], p["w_if"], cd) + p["b_if"].to(acc)
    log_i, f_pre = gates[..., :n_heads], gates[..., n_heads:]
    log_f = _log_sigmoid(f_pre)

    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(log_f + m, log_i)
    w_f = torch.exp(log_f + m - m_new)
    w_i = torch.exp(log_i - m_new)
    C_new = C * w_f[..., None, None] + \
        w_i[..., None, None] * k[..., :, None] * v[..., None, :]
    n_new = n * w_f[..., None] + w_i[..., None] * k
    scale = 1.0 / math.sqrt(hd)
    num = torch.einsum("bhd,bhde->bhe", q * scale, C_new)
    den = torch.abs(torch.einsum("bhd,bhd->bh", q * scale, n_new))
    y = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    y = rms_norm(y.reshape(B, 1, u).to(cd), p["ln_inner"], eps)
    y = y * F.silu(z).to(cd)
    out = cd_matmul(y, p["w_down"], cd, out_dtype=cd)
    return (rt.shard(out, "batch", None, "act_embed"),
            {"C": C_new, "n": n_new, "m": m_new})


def slstm_specs(d: int, n_heads: int) -> Dict[str, Spec]:
    hd = d // n_heads
    return {
        "w_in": Spec((d, 4 * d), ("embed", "ff")),       # z,i,f,o pre-acts
        "b_in": Spec((4 * d,), ("ff",), "zeros"),
        "r": Spec((4, n_heads, hd, hd), (None, None, None, None), "small"),
        "ln_inner": Spec((d,), ("embed",), "ones"),
    }


def _slstm_cell(wx: torch.Tensor, h_prev: torch.Tensor, state: Tuple,
                r: torch.Tensor, n_heads: int
                ) -> Tuple[torch.Tensor, Tuple]:
    """One sLSTM step.  wx [B, 4D] input pre-activations (fp32), gate-major
    (z, i, f, o); state = (c, n, m), each [B, D].  The recurrence `r`
    [4, H, hd, hd] is block-diagonal per head, its output [B, 4, H, hd]
    gate-major like wx.  h = o c / max(n, 1)."""
    c, n, m = state
    B, D4 = wx.shape
    D = D4 // 4
    hd = D // n_heads
    hh = h_prev.reshape(B, n_heads, hd)
    rec = torch.einsum("bhi,ghij->bghj", hh, r.to(wx.dtype))
    rec = rec.reshape(B, 4 * D)
    pre = wx + rec
    z_pre, i_pre, f_pre, o_pre = torch.split(pre, D, dim=-1)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    log_i = i_pre                                   # exponential input gate
    log_f = _log_sigmoid(f_pre)
    m_new = torch.maximum(log_f + m, log_i)
    w_f = torch.exp(log_f + m - m_new)
    w_i = torch.exp(log_i - m_new)
    c_new = w_f * c + w_i * z
    n_new = w_f * n + w_i
    h = o * c_new / torch.clamp_min(n_new, 1.0)
    return h, (c_new, n_new, m_new)


def slstm_block_train(p: Params, x: torch.Tensor, *, n_heads: int,
                      eps: float, rt: Runtime) -> torch.Tensor:
    """The sLSTM block over a full sequence: the input pre-activations in
    fp32 at once, then the cell step by step from zeros (m from -1e30),
    as the reference's scan over time (`scan`)."""
    cd = rt.compute_dtype
    B, S, D = x.shape
    wx = f32_matmul(x, p["w_in"], cd) + p["b_in"].float()
    dev = x.device

    def step(carry, xs):
        h_prev, st = carry
        h, st = _slstm_cell(xs[0], h_prev, st, p["r"], n_heads)
        return (h, st), h

    init = (torch.zeros((B, D), device=dev),
            (torch.zeros((B, D), device=dev), torch.zeros((B, D), device=dev),
             torch.full((B, D), STABILISER_START, device=dev)))
    _, hs = scan(step, init, (wx.transpose(0, 1),))
    y = hs.transpose(0, 1)                               # [B, S, D]
    return rt.shard(rms_norm(y.to(cd), p["ln_inner"], eps),
                    "batch", None, "act_embed")


def slstm_block_decode(p: Params, x: torch.Tensor,
                       state: Dict[str, torch.Tensor], *, n_heads: int,
                       eps: float, rt: Runtime
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One step; state = {"h", "c", "n", "m"}, each [B, D] fp32 (a fresh
    cache's m is 0).  Returns the output and a new state."""
    cd = rt.compute_dtype
    wx = f32_matmul(x, p["w_in"], cd)[:, 0] + p["b_in"].to(acc_dtype(cd))
    h, (c, n, m) = _slstm_cell(wx, state["h"],
                               (state["c"], state["n"], state["m"]),
                               p["r"], n_heads)
    y = rms_norm(h[:, None].to(cd), p["ln_inner"], eps)
    return (rt.shard(y, "batch", None, "act_embed"),
            {"h": h, "c": c, "n": n, "m": m})
