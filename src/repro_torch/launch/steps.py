"""Step builders of the port: `build_model`, `make_runtime`,
`input_specs`, the training step `make_train_step`, the serving steps
`make_prefill_step` / `make_serve_step`, and `trace_step`, which counts
one step of any of them on fake tensors for the dry-run
(`launch.dryrun`).

The reference builds jit-able steps over a device mesh; on one GPU a step
is a plain function that runs eagerly under
`layers.full_precision_products` (the serving steps under
`torch.inference_mode` as well), over a `DecoderLM` or, for the
encoder-decoder (whisper-medium), an `EncDecLM`.  The training step takes
its gradients with `torch.autograd.grad`, backward and remat recompute
inside the same precision scope, and updates the parameters and moments
in place (the reference donates them).

Over a device mesh (`launch.mesh`), `make_runtime(mesh=...)` derives the
reference's sharding rules for the cell, `step_placements` gives the
DTensor placements of every argument and result of the cell's step (the
reference's `in_shardings` / `out_shardings`), and `place_params` puts a
parameter tree on the mesh.  A step runs on a rank's local shards as
plain tensors, or on the DTensors themselves: then the models' sharding
sites (`Runtime.shard`) lay its activations out as the reference's
constraints do, the tensors it makes for itself join as replicated ones,
and a serving step runs under `no_grad`.  `trace_step(mesh=...)` counts
such a step per rank, its collectives included (the dry-run over a mesh,
`launch.dryrun`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import math
import weakref
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils import _pytree as pytree
from torch.utils._pytree import tree_leaves

from repro_torch import obs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.roofline import CollectiveStats
from repro_torch.distributed.sharding import (AxisRules, Layout, fsdp_rules,
                                              placements_of, shard_shape,
                                              tp_rules)
from repro_torch.launch.mesh import batch_axes_for
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (STEP_COUNTERS, Runtime,
                                       full_precision_products, map_specs,
                                       slice_of)
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lm import DecoderLM
from repro_torch.optim import (AdamWState, adamw_update,
                               linear_warmup_cosine)

Model = Union[DecoderLM, EncDecLM]

__all__ = ["build_model", "make_runtime", "rules_for", "input_specs",
           "StepPlacements", "step_placements", "place_params",
           "loss_and_grads", "make_train_step",
           "make_prefill_step", "make_serve_step", "StepCounts",
           "count_step", "trace_step"]


def build_model(arch: ArchConfig) -> Model:
    if arch.is_encdec:
        return EncDecLM(arch)
    return DecoderLM(arch)


def rules_for(mesh, shape: ShapeSpec, *, sharding_mode: str = "fsdp",
              rule_updates: Optional[Dict[str, Any]] = None) -> AxisRules:
    """The reference's sharding rules of a cell on `mesh`: batch on the
    mesh axes that divide the global batch (`batch_axes_for`), `fsdp` or
    `tp` rules, then `rule_updates`.  Decode always takes `tp`: its
    parameters stay resident on the model axis (a per-layer FSDP gather
    would put the whole weight read on the interconnect each token)."""
    batch_axes = batch_axes_for(mesh, shape.global_batch)
    if sharding_mode == "fsdp" and shape.mode != "decode":
        rules = fsdp_rules(batch_axes)
    else:
        rules = tp_rules(batch_axes)
    if rule_updates:
        rules = rules.replace(**rule_updates)
    return rules


def make_runtime(arch: ArchConfig, shape: ShapeSpec, *,
                 remat: str = "full", use_kernels: bool = False,
                 overrides: Optional[Dict[str, Any]] = None, mesh=None,
                 sharding_mode: str = "fsdp",
                 rule_updates: Optional[Dict[str, Any]] = None) -> Runtime:
    """Execution point for one (arch, shape) cell, as the reference's:
    training runs fp32 params, bf16 compute and `remat` (serving shapes
    no remat); serving shapes run bf16 weights (half the memory and the
    bytes of every weight read).  With a `mesh` (a `DeviceMesh`), the
    runtime carries it and the cell's rules (`rules_for`)."""
    kw: Dict[str, Any] = {"use_kernels": use_kernels,
                          "remat": remat if shape.mode == "train"
                          else "none"}
    if mesh is not None:
        kw["mesh"] = mesh
        kw["rules"] = rules_for(mesh, shape, sharding_mode=sharding_mode,
                                rule_updates=rule_updates)
    if shape.mode != "train":
        kw["param_dtype"] = torch.bfloat16
    if overrides:
        kw.update(overrides)
    return Runtime(**kw)


def input_specs(arch: ArchConfig, shape: ShapeSpec
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of every model input of this cell."""
    B, S = shape.global_batch, shape.seq_len
    if shape.mode in ("train", "prefill"):
        if arch.is_encdec:
            return {"frames": ((B, arch.encoder_seq, arch.d_model),
                               torch.bfloat16),
                    "tokens": ((B, S), torch.int64)}
        batch: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
        s_text = S
        if arch.frontend == "vit_stub":
            s_text = S - arch.num_patches
            batch["patch_embeds"] = ((B, arch.num_patches, arch.d_model),
                                     torch.bfloat16)
        batch["tokens"] = ((B, s_text), torch.int64)
        return batch
    # decode: one new token against a seq_len-deep cache
    return {"token": ((B, 1), torch.int64), "pos": ((), torch.int64)}


@dataclasses.dataclass(frozen=True)
class StepPlacements:
    """Where a cell's step finds its arguments and leaves its results on a
    mesh: the counterpart of the reference's `StepBundle.in_shardings` and
    `out_shardings`.  `inputs` has one tree a step argument and `outputs`
    the step's result, in the layout of the port's trees, with a `Layout`
    at every tensor: train `(params, opt_state, batch)` ->
    `(params, opt_state, metrics)`; prefill `(params, batch)` -> the last
    position's logits; decode `(params, cache, token, pos)` ->
    `(logits, cache)`."""

    rules: AxisRules
    inputs: Tuple[Any, ...]
    outputs: Any


def step_placements(arch: ArchConfig, shape: ShapeSpec, mesh, *,
                    sharding_mode: str = "fsdp",
                    rule_updates: Optional[Dict[str, Any]] = None
                    ) -> StepPlacements:
    """The placements of the cell's step on `mesh` under `rules_for`'s
    rules: parameters by their specs' logical axes, AdamW's `step`
    replicated and its moments placed as the parameters, every batch
    input `batch` on its first dimension and `pos` replicated, the decode
    caches by their specs, the prefill logits `["batch", "vocab"]`, the
    decode logits `["batch", None, "vocab"]` and the train metrics
    replicated."""
    rules = rules_for(mesh, shape, sharding_mode=sharding_mode,
                      rule_updates=rule_updates)
    model = build_model(arch)

    def layout(shp, axes) -> Layout:
        spec = rules.spec(axes)
        return Layout(tuple(shp), spec, placements_of(mesh, spec))

    def of_specs(tree):
        return map_specs(lambda s: layout(s.shape, s.axes), tree)

    B = shape.global_batch
    vocab = model.v_pad
    params = of_specs(model.param_specs())
    if shape.mode == "decode":
        specs = input_specs(arch, shape)
        cache = of_specs(model.cache_specs(B, shape.seq_len))
        inputs = (params, cache,
                  layout(specs["token"][0], ["batch", None]),
                  layout((), ()))
        return StepPlacements(rules, inputs, (
            layout((B, 1, vocab), ["batch", None, "vocab"]), cache))
    batch = {name: layout(shp, ["batch"] + [None] * (len(shp) - 1))
             for name, (shp, _) in input_specs(arch, shape).items()}
    if shape.mode == "prefill":
        return StepPlacements(rules, (params, batch),
                              layout((B, vocab), ["batch", "vocab"]))
    opt = AdamWState(step=layout((), ()), mu=params, nu=params)
    metrics = {k: layout((), ()) for k in ("loss", "grad_norm", "lr")}
    return StepPlacements(rules, (params, opt, batch),
                          (params, opt, metrics))


def place_params(params, mesh, layouts, src_data_rank: Optional[int] = 0):
    """`params` (nested dicts and lists of tensors: parameters or decode
    caches) on `mesh` as DTensors, leaf by leaf
    with `distribute_tensor` at the `Layout` of the same place in
    `layouts` (e.g. `step_placements(...).inputs[0]`).  Every leaf must
    have its layout's shape, divisible by its mesh axes.  `src_data_rank`
    is `distribute_tensor`'s: the rank whose data every rank takes (by a
    scatter or a broadcast), or None for each rank to cut its own shard
    from the tensor it holds, with no communication."""
    from torch.distributed.tensor import distribute_tensor

    def place(x, lay: Layout):
        if tuple(x.shape) != lay.shape:
            raise ValueError(f"a leaf of shape {tuple(x.shape)} where the "
                             f"layout has {lay.shape}")
        shard_shape(lay.shape, mesh, lay.placements)
        return distribute_tensor(x, mesh, lay.placements,
                                 src_data_rank=src_data_rank)

    def walk(x, lay):
        if isinstance(x, dict):
            if x.keys() != lay.keys():
                raise ValueError(f"keys {sorted(x)} against the layout's "
                                 f"{sorted(lay)}")
            return {k: walk(v, lay[k]) for k, v in x.items()}
        if isinstance(x, list):
            if len(x) != len(lay):
                raise ValueError(f"{len(x)} entries against the layout's "
                                 f"{len(lay)}")
            return [walk(v, w) for v, w in zip(x, lay)]
        return place(x, lay)

    return walk(params, layouts)


def _split_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """x [B, ...] as n microbatches [n, B / n, ...].  Over a mesh each rank
    splits its own rows, so every microbatch holds rows of every batch
    shard and tiles the shards, where the reference constrains the split
    batch to (None, "batch") (DTensor cannot reshape a sharded dimension
    in place; which rows go to which microbatch changes no sum)."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.experimental import local_map

    def split(t):
        return t.reshape((n, t.shape[0] // n) + t.shape[1:])

    if not isinstance(x, DTensor):
        return split(x)
    out = tuple(Shard(p.dim + 1) if p.is_shard() else p
                for p in x.placements)
    return local_map(split, out_placements=(out,),
                     in_placements=(tuple(x.placements),),
                     device_mesh=x.device_mesh)(x)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """fp32 zeros of `p`'s shape on its device; over a mesh laid out as
    `p` (each rank's zeros of its shard's shape)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    local = p.to_local()
    return DTensor.from_local(
        torch.zeros(local.shape, dtype=torch.float32, device=local.device),
        p.device_mesh, p.placements, run_check=False, shape=p.shape,
        stride=p.stride())


def _value_and_grad(model: Model, rt: Runtime, params, batch):
    """`jax.value_and_grad` of `model.loss` in the parameters: the loss
    (detached) and the gradients as a flat list in `tree_leaves` order."""
    leaves, spec = pytree.tree_flatten(params)
    wrt = [p.detach().requires_grad_() for p in leaves]
    loss = model.loss(pytree.tree_unflatten(wrt, spec), batch, rt)
    return loss.detach(), list(torch.autograd.grad(loss, wrt))


def loss_and_grads(model: Model, rt: Runtime, params, batch,
                   microbatches: int = 1):
    """The train step's loss (fp32, 0-d) and gradients (a flat list in
    `tree_leaves(params)` order), as the reference's step takes them:
    with `microbatches > 1` the batch is split along its first axis, the
    fp32 gradients summed over the microbatches and loss and gradients
    scaled by 1/n.  Call it under `full_precision_products` on the card
    (the train step does).  Under `count_step` the first microbatch is
    counted for all (`_Counter.repeat`): the same peak, since the
    accumulators exist from the start, and its values only."""
    if microbatches <= 1:
        return _value_and_grad(model, rt, params, batch)
    n = microbatches
    micro = {k: rt.shard(_split_rows(v, n), None, "batch")
             for k, v in batch.items()}
    leaves = pytree.tree_leaves(params)
    loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    grads = [_zeros_f32(p) for p in leaves]

    def accumulate(i, loss):
        mb_loss, mb_grads = _value_and_grad(
            model, rt, params, {k: v[i] for k, v in micro.items()})
        for acc, g in zip(grads, mb_grads):
            acc.add_(g.float())
        del mb_grads
        return loss + mb_loss

    if STEP_COUNTERS:
        # counted: the microbatches do the same work on tensors of the
        # same shapes, so the first runs for all (the reference's
        # microbatch probe); the loss and gradients then hold its share
        # only, which on fake tensors are none
        loss = STEP_COUNTERS[-1].repeat(lambda: accumulate(0, loss), n)
    else:
        for i in range(n):
            loss = accumulate(i, loss)
    inv = 1.0 / microbatches
    for g in grads:
        g.mul_(inv)
    return loss * inv, grads


def make_train_step(model: Model, rt: Runtime, *, base_lr: float = 3e-4,
                    warmup_steps: int = 100, total_steps: int = 10000,
                    microbatches: int = 1) -> Callable:
    """The training step `(params, opt_state, batch) -> (params,
    opt_state, {"loss", "grad_norm", "lr"})`, the reference's: the loss
    and gradients of `loss_and_grads` (gradient accumulation over
    `microbatches`), the lr `linear_warmup_cosine(step + 1)`, and
    `adamw_update`, which writes params and moments in place with the
    reference's decay mask (`model.decay_mask()`).  The metrics are 0-d
    device tensors: nothing in the step waits for the device."""
    decay = model.decay_mask()

    def train_step(params, opt_state: AdamWState, batch):
        with _over_mesh(params), full_precision_products():
            loss, grads = loss_and_grads(model, rt, params, batch,
                                         microbatches)
            # step + 1: the schedule is evaluated for the step being taken
            lr = linear_warmup_cosine(opt_state.step + 1, base_lr=base_lr,
                                      warmup_steps=warmup_steps,
                                      total_steps=total_steps)
            grads = pytree.tree_unflatten(
                grads, pytree.tree_structure(params))
            params, opt_state, gnorm = adamw_update(
                grads, opt_state, params, lr, decay=decay)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": lr}
    return train_step


def _on_mesh(params) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(next(iter(tree_leaves(params)), None), DTensor)


def _over_mesh(params):
    """A step on DTensors meets the tensors it makes for itself
    (positions, masks, constants) as replicated DTensors
    (`implicit_replication`), as every rank makes them whole."""
    if not _on_mesh(params):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _no_autograd(params):
    """The serving steps' autograd context: `inference_mode`, or `no_grad`
    for a step on DTensors (a view of a DTensor made outside
    `inference_mode` cannot be taken inside it)."""
    return torch.no_grad() if _on_mesh(params) else torch.inference_mode()


def make_prefill_step(model: Model, rt: Runtime) -> Callable:
    def prefill_step(params, batch):
        # the sampler needs only the last position's logits
        with _no_autograd(params), _over_mesh(params), \
                full_precision_products(), obs.span("prefill"):
            logits = model.forward(params, batch, rt, last_only=True)
        return logits[:, -1, :]
    return prefill_step


def make_serve_step(model: Model, rt: Runtime) -> Callable:
    def serve_step(params, cache, token, pos):
        with _no_autograd(params), _over_mesh(params), \
                full_precision_products():
            return model.decode_step(params, cache, token, pos, rt)
    return serve_step


# ------------------------------------------------------ counting one step

@dataclasses.dataclass
class StepCounts:
    """What one run of a step does, counted op by op.

    `matmul_flops`: `torch.utils.flop_counter.FlopCounterMode`'s count, the
    matmul family (mm, addmm, bmm, baddbmm, convolution, SDPA), by op in
    `flops_by_op`.  `elementwise_flops`: the pointwise ops and reductions,
    and `transcendentals` apart, as XLA's `HloCostAnalysis` counts them
    (`_ELEMENTWISE`).  `flops` is their sum, `matmul_flops +
    elementwise_flops`: XLA's "flops", which the reference's roofline
    divides by the peak.  `bytes_accessed`: operand and result bytes of
    every aten op that is not a view — the counterpart of XLA's pre-fusion
    "bytes accessed", an upper bound on device-memory traffic.
    `peak_bytes`: the most bytes of storage alive at once, the step's
    arguments included (params, inputs, caches), in use by tensors; no
    allocator rounding, no library workspace.

    Over a mesh (a step on DTensors) every count is rank 0's: the ops on
    its local shards, and `collectives` the result bytes of each
    collective it takes part in, by the reference's kind names (the sum
    `core.roofline.parse_collective_bytes` takes over an HLO's result
    shapes); on one device `collectives` is empty."""

    flops: int
    flops_by_op: Dict[str, int]
    bytes_accessed: int
    peak_bytes: int
    ops: int
    matmul_flops: int = 0
    elementwise_flops: int = 0
    transcendentals: int = 0
    collectives: CollectiveStats = dataclasses.field(
        default_factory=CollectiveStats)
    # bytes of each argument of the step (its local shards over a mesh),
    # by name, where `trace_step` made them
    arg_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)


# (FLOPs, transcendentals) per output element of a pointwise aten op, as
# XLA's HloCostAnalysis counts the reference's op after XLA's own
# expansions (probed with jax 0.9.0's XLA:CPU `cost_analysis()` at [8, 64]
# fp32; tests/test_torch_flops.py holds each).  Every pointwise op not
# listed counts (1, 0): add, sub, mul, div, neg, abs, maximum, clamp,
# comparisons, logical ops, where / masked_fill (select), x ** 2 (a
# product).  Transcendentals count apart and add no FLOPs.
_ELEMENTWISE = {
    **{op: (0, 1) for op in ("exp", "exp2", "expm1", "log", "log1p", "log2",
                             "rsqrt", "sqrt", "tanh", "sin", "cos", "erf",
                             "pow")},
    "sigmoid": (3, 1),      # logistic -> 1 / (1 + exp(-x))
    "silu": (4, 1),         # x * logistic(x)
    "gelu": (8, 1),         # the tanh approximation, the only gelu the
                            # port calls: 0.5 x (1 + tanh(c (x + a x^3)))
    "logaddexp": (8, 2),    # max, sub, abs, neg, exp, log1p, add, isnan,
                            # select
    "addcmul": (2, 0),      # input + t1 * t2
}
def _cumsum_flops(n: int) -> int:
    """Adds XLA:CPU counts for an inclusive cumulative sum of length `n`
    (probed with jax 0.9.0 at n from 8 to 32768, fp32 and int32): a
    window-n reduce-window up to 16; beyond, n padded to 16 k, a scan
    within each block of 16 (15 adds an element), the block totals added
    back (1 an element) and an exclusive scan of the k totals (k^2 - 1 up
    to 16 blocks, else the same rule at length k)."""
    if n <= 16:
        return n * (n - 1)
    k = -(-n // 16)
    outer = k * k - 1 if k <= 16 else _cumsum_flops(k)
    return 16 * k * 16 + outer


# ops that move data and compute nothing (XLA's copy, concatenate,
# broadcast, iota and gather count 0), unless they convert the dtype (XLA:
# convert, 1 an element)
_COPIES = {"clone", "copy", "_to_copy"}


def _elementwise_cost(func, args, outs) -> Tuple[int, int]:
    """(FLOPs, transcendentals) of one aten op in XLA's convention: a
    pointwise op per output element (`_ELEMENTWISE`), a reduction n - 1
    per output (a mean one more, its division), softmax as its max, sub,
    exp, sum and div, a cumulative sum by `_cumsum_flops`, a triangular
    mask one an element; a matmul-family op counts 0 here
    (FlopCounterMode counts it)."""
    name = func.overloadpacket.__name__.rstrip("_")
    out = outs[0].numel()
    if name in _COPIES:
        src = args[1] if name == "copy" else args[0]
        return (out if src.dtype != outs[0].dtype else 0), 0
    if name == "cumsum":
        n = args[0].shape[args[1]] if args[0].dim() else 1
        return out // max(n, 1) * _cumsum_flops(n), 0
    if name == "tril":                # jnp.tril of a constant: a compare
        return out, 0
    if name == "_softmax":            # max, sub, exp, sum, div along a dim
        rows = out // max(1, args[0].shape[args[1]])
        return 4 * out - 2 * rows, out
    if torch.Tag.reduction in func.tags:
        return args[0].numel() - out + (out if name == "mean" else 0), 0
    if torch.Tag.pointwise not in func.tags:
        return 0, 0
    if name == "pow" and isinstance(args[1], (int, float)) and \
            float(args[1]).is_integer() and 0 <= args[1] <= 64:
        # an integer power is multiplies (XLA's `integer_pow`: square and
        # multiply): x ** 2 one, x ** 3 two (rsqrt's backward), x ** 1 none
        # (the backward of x ** 2 takes it)
        k = int(args[1])
        return out * max(k.bit_length() + bin(k).count("1") - 2, 0), 0
    f, tr = _ELEMENTWISE.get(name, (1, 0))
    return f * out, tr * out


# the collectives of `torch.distributed._functional_collectives` (and
# DTensor's all-to-all) by the reference's HLO kind names; `wait_tensor`
# only waits on the result of one of them
_COLLECTIVES = {
    **{f"_c10d_functional.{op}": kind for kind, ops in (
        ("all-gather", ("all_gather_into_tensor",
                        "all_gather_into_tensor_coalesced")),
        ("reduce-scatter", ("reduce_scatter_tensor",
                            "reduce_scatter_tensor_coalesced")),
        ("all-reduce", ("all_reduce", "all_reduce_", "all_reduce_coalesced",
                        "all_reduce_coalesced_")),
        ("all-to-all", ("all_to_all_single",)),
        ("collective-permute", ("broadcast", "broadcast_")),
    ) for op in ops},
    "_dtensor.shard_dim_alltoall": "all-to-all",
}
_WAIT = "_c10d_functional.wait_tensor"


def _add_flops(registry, flop_counts, func, out, args, kwargs,
               times: int) -> None:
    """Add `times` of the op's matmul-family FLOPs, by
    `FlopCounterMode`'s formula, to its `flop_counts["Global"]`."""
    packet = func._overloadpacket
    if packet in registry:
        flop_counts["Global"][packet] += times * registry[packet](
            *args, **(kwargs or {}), out_val=out)


class _LocalFlops:
    """`FlopCounterMode`'s count of the matmul family kept by `_Counter`
    itself, on the local tensors of a step over a mesh (`FlopCounterMode`
    would count a DTensor op at its global shapes): the same formulas
    (`torch.utils.flop_counter`'s registry) and the same
    `flop_counts["Global"]` record."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode
        self.registry = FlopCounterMode(display=False).flop_registry
        self.flop_counts = {"Global": collections.defaultdict(int)}

    def count(self, func, out, args, kwargs, times: int = 1) -> None:
        _add_flops(self.registry, self.flop_counts, func, out, args, kwargs,
                   times)

    def get_flop_counts(self):
        return self.flop_counts

    def get_total_flops(self) -> int:
        return sum(self.flop_counts["Global"].values())


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the tensor itself if it is none)."""
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


@contextlib.contextmanager
def _propagation_muted(counter: "_Counter"):
    """DTensor plans each op on the host before it runs it on the local
    shards: its sharding propagation (`ShardingPropagator`, cached per op
    and placements) runs the op on fake tensors of the global shapes, or
    its decomposition on meta tensors over a one-rank mesh, and a strided
    shard's local sizes come from splitting an `arange`
    (`_StridedShard.local_shard_size_and_offset`, also when a tensor is
    redistributed).  Those ops are no rank's work: the counter lets them
    through uncounted and unheld, and they run outside the ambient fake
    mode (with it their host arithmetic, `tolist` and `nonzero` on index
    tensors, would have no values; the propagation makes its own fake
    tensors)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import _StridedShard

    def muted(orig):
        @functools.wraps(orig)
        def run(*args, **kwargs):
            counter.muted += 1
            try:
                with unset_fake_temporarily():
                    return orig(*args, **kwargs)
            finally:
                counter.muted -= 1
        return run

    # on the instance: the dispatcher calls them there, and the cached
    # one is an attribute of the instance
    prop = DTensor._op_dispatcher.sharding_propagator
    names = [n for n in ("propagate_op_sharding",
                         "propagate_op_sharding_non_cached")
             if hasattr(prop, n)]
    own = {n: prop.__dict__[n] for n in names if n in prop.__dict__}
    for n in names:
        setattr(prop, n, muted(getattr(prop, n)))
    strided = _StridedShard.__dict__.get("local_shard_size_and_offset")
    if strided is not None:
        _StridedShard.local_shard_size_and_offset = muted(strided)
    try:
        yield
    finally:
        for n in names:
            if n in own:
                setattr(prop, n, own[n])
            else:
                delattr(prop, n)
        if strided is not None:
            _StridedShard.local_shard_size_and_offset = strided


class _Counter(TorchDispatchMode):
    """Live storage bytes (with their peak) for every op, and operand and
    result bytes, elementwise FLOPs and transcendentals while `counting` is
    set.

    With `per_rank` (a step on DTensors) the counter passes every op on a
    DTensor on to DTensor (`NotImplemented`) and counts the ops DTensor
    runs on rank 0's local shards, its collectives among them
    (`collectives`), and the matmul family itself (`_LocalFlops`).

    An op of the backward of a replayed scan step (`replay_scan`) counts
    as many times as the step stands for (`times`)."""

    def __init__(self, per_rank: bool = False):
        super().__init__()
        self.sizes: Dict[int, int] = {}
        # each held storage's place in the order of holding
        self.born: Dict[int, int] = {}
        self._serial = itertools.count()
        self.live = self.peak = 0
        self.bytes_accessed = self.ops = 0
        self.elementwise_flops = self.transcendentals = 0
        self.counting = False
        self.per_rank = per_rank
        self.muted = 0
        self.collectives = CollectiveStats()
        if per_rank:
            self.flop_counter = _LocalFlops()
        # replayed scan steps: (first, end) autograd sequence numbers of
        # the nodes a step made, and the steps it stands for
        self.replayed: list = []
        self._times: Dict[int, int] = {}
        # storage -> the stand-ins that go when their last storage goes
        self.waiting: Dict[int, list] = {}

    def hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.sizes:
            return
        self.sizes[key] = st.nbytes()
        self.born[key] = next(self._serial)
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self.sizes.pop(key)
        del self.born[key]
        for group in self.waiting.pop(key, ()):
            group[0] -= 1
            if not group[0]:
                group[1] = None         # the stand-in goes with the last

    def times(self) -> int:
        """How many times the op running now counts: the steps a replayed
        scan step stands for (their product, where replays nest) while the
        autograd node running is one that step made, else 1.  In the
        backward that is the node's own work, the gradients it adds into
        its inputs' buffers, and a remat recompute it sets off."""
        if not self.replayed:
            return 1
        node = torch._C._current_autograd_node()
        if node is None:
            return 1
        seq = node._sequence_nr()
        n = self._times.get(seq)
        if n is None:
            n = self._times[seq] = math.prod(
                k for a, b, k in self.replayed if a <= seq < b)
        return n

    def repeat(self, fn, n: int):
        """`fn()` counted `n` times over: it runs once, and its counts
        (ops, bytes, elementwise FLOPs, transcendentals and
        `flop_counter`'s matmul FLOPs by op) are added `n - 1` times more.
        Returns what `fn` returns."""
        flops = self.flop_counter.flop_counts["Global"]
        fields = ("ops", "bytes_accessed", "elementwise_flops",
                  "transcendentals")
        was, was_flops = [getattr(self, f) for f in fields], dict(flops)
        coll = self.collectives
        was_coll, was_n = dict(coll.by_kind), coll.count
        out = fn()
        counted = dict(flops)
        flops.clear()
        flops.update({op: c + (n - 1) * (c - was_flops.get(op, 0))
                      for op, c in counted.items()})
        for f, w in zip(fields, was):
            setattr(self, f, getattr(self, f) + (n - 1) * (
                getattr(self, f) - w))
        for kind, b in dict(coll.by_kind).items():
            extra = (n - 1) * (b - was_coll.get(kind, 0))
            coll.by_kind[kind] += extra
            coll.total_bytes += extra
        coll.count += (n - 1) * (coll.count - was_n)
        return out

    def _stand_in(self, nbytes: int, device) -> torch.Tensor:
        """An uncounted allocation of `nbytes`, held as any storage."""
        was, self.counting = self.counting, False
        try:
            return torch.empty((nbytes,), dtype=torch.uint8, device=device)
        finally:
            self.counting = was

    def replay_scan(self, step, carry, xs, n: int):
        """`layers.scan` of `n > 4` steps, run as four chained steps: the
        first, a middle step standing for `n - 3` middle ones, the last
        middle one and the last.  Where grad is on (a train step's
        forward, or a remat recompute in its backward) the first and the
        last differ from the others in the backward (the first's carry may
        need no gradient, the last's gets none from a next step); every
        middle step does what the others do, on tensors of the same
        shapes.  So:

        * the standing step's forward counts `n - 3` times (`repeat`),
          and so does every op that runs while an autograd node it made
          runs (`times`, keyed by the nodes' sequence numbers): its
          backward, the gradients it adds into the first step's buffers,
          a recompute it sets off;
        * the ys are stacked from the four steps' ys and `n - 4` detached
          aliases of the standing one's: the stack's operands and result
          are the loop's, and its backward hands the four steps their
          gradients and no other (the loop's hands one to each step and
          adds none up); a ys leaf that each step passed on as its own
          slice of an xs leaf, or wrote in place into it (a KV cache
          layer), is that xs leaf, as `layers.stack_ys` returns it;
        * the peak: what the standing step made and still holds once the
          next step has run (its saved activations, its y, a carry the
          next step saved) stands in `n - 4` times from then until the
          stack, and what of it outlives the stack until the last of the
          standing step's own storages goes (in the backward, where the
          middle steps' go).  The next middle step and the last run beside
          it, as the loop's last two do.

        The output holds the four steps' values only, which on fake
        tensors are none."""
        leaves, spec = pytree.tree_flatten(xs)

        def run(c, i):
            return step(c, pytree.tree_unflatten([x[i] for x in leaves],
                                                 spec))

        carry, y0 = run(carry, 0)
        mark = next(self._serial)
        first = torch.autograd._get_sequence_nr()
        carry, y1 = self.repeat(functools.partial(run, carry, 1), n - 3)
        if torch.is_grad_enabled() and \
                torch._C._current_autograd_node() is None:
            # a forward's nodes; a recompute's never run backward
            self.replayed.append(
                (first, torch.autograd._get_sequence_nr(), n - 3))
        made = {k: b for k, b in self.born.items() if b > mark}
        carry, y2 = run(carry, 2)
        device = _local(leaves[0]).device

        def alive():
            # a storage freed may leave its key to a new one
            return [k for k, b in made.items() if self.born.get(k) == b]

        def stand_in(keys):
            return self._stand_in(
                (n - 4) * sum(self.sizes[k] for k in keys), device)

        held = stand_in(alive())
        carry, y3 = run(carry, n - 1)

        def stacked(a, b, c, d):
            same = next((x for x in leaves if all(
                slice_of(t, x, i)
                for t, i in ((a, 0), (b, 1), (c, 2), (d, n - 1)))), None)
            if same is not None:
                return same
            return torch.stack([a, b] + [b.detach()] * (n - 4) + [c, d])

        ys = None
        if y0 is not None:
            flat, yspec = pytree.tree_flatten(y0)
            ys = pytree.tree_unflatten(
                [stacked(*ts) if isinstance(ts[0], torch.Tensor) else ts[0]
                 for ts in zip(flat, *(pytree.tree_leaves(y)
                                       for y in (y1, y2, y3)))], yspec)
        del y0, y1, y2, y3, held
        kept = alive()
        # made even where nothing is kept: a recompute under selective
        # checkpointing must meet the forward's allocations one for one
        group = [len(kept), stand_in(kept)]
        for k in kept:
            self.waiting.setdefault(k, []).append(group)
        return carry, ys

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.muted:
            return func(*args, **(kwargs or {}))
        if self.per_rank:
            from torch.distributed.tensor import DTensor
            if any(isinstance(t, DTensor)
                   for t in tree_leaves((args, kwargs))):
                return NotImplemented       # DTensor runs the local ops
            if func._overloadpacket not in self.flop_counter.registry \
                    and func is not torch.ops.prim.device.default:
                # `FlopCounterMode`'s own rule, which stands above this
                # mode on one device: an op it has no formula for runs
                # as its decomposition, where it has one
                with self:
                    r = func.decompose(*args, **(kwargs or {}))
                if r is not NotImplemented:
                    return r
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if self.per_rank and any(t.device.type == "meta" for t in outs):
            # DTensor's planning through an op's decomposition runs on
            # meta tensors: no rank's work
            return out
        for t in outs:
            self.hold(t)
        if not (self.counting and outs):
            return out
        name = f"{func.namespace}.{func._opname}"
        if name == _WAIT:
            return out
        times = self.times()
        if name in _COLLECTIVES:
            for t in outs:
                self.collectives.add(_COLLECTIVES[name],
                                     times * t.numel() * t.element_size(),
                                     times)
            return out
        if self.per_rank:
            self.flop_counter.count(func, out, args, kwargs, times)
        elif times > 1:
            # `FlopCounterMode`, above this mode, counted it once
            _add_flops(self.flop_counter.flop_registry,
                       self.flop_counter.flop_counts, func, out, args,
                       kwargs, times - 1)
        # ops with no tensor result (device or size queries) move nothing
        if not func.is_view:
            self.ops += times
            self.bytes_accessed += times * sum(
                t.numel() * t.element_size()
                for t in tree_leaves((args, kwargs)) + outs
                if isinstance(t, torch.Tensor))
            flops, trans = _elementwise_cost(func, args, outs)
            self.elementwise_flops += times * flops
            self.transcendentals += times * trans
        return out


def count_step(step: Callable, *args) -> Tuple[Any, StepCounts]:
    """Run `step(*args)` once and count it (`StepCounts`); on real or fake
    tensors alike.  Returns the step's output and the counts.  A
    `layers.scan` inside (the xLSTM blocks' loops, the encoder-decoder's
    layers) runs four steps, one counted for the middle ones, its
    backward too where grad is on (`_Counter.replay_scan`); a train
    step's microbatches count one for all (`loss_and_grads`).  The
    counts are exact, the output is not the model's where such a repeat
    ran.

    When an argument is a DTensor, the step runs over its mesh and is
    counted per rank (`_Counter(per_rank=True)`)."""
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import FlopCounterMode

    leaves = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    per_rank = any(isinstance(t, DTensor) for t in leaves)
    counter = _Counter(per_rank)
    STEP_COUNTERS.append(counter)
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(counter)
            for t in leaves:
                counter.hold(_local(t))
            counter.counting = True
            if per_rank:
                stack.enter_context(_propagation_muted(counter))
                flop_counter = counter.flop_counter
            else:
                flop_counter = stack.enter_context(
                    FlopCounterMode(display=False))
                counter.flop_counter = flop_counter
            out = step(*args)
            counter.counting = False
    finally:
        STEP_COUNTERS.remove(counter)
    by_op = {str(op): int(n) for op, n in
             flop_counter.get_flop_counts().get("Global", {}).items()}
    mm = int(flop_counter.get_total_flops())
    return out, StepCounts(flops=mm + counter.elementwise_flops,
                           flops_by_op=by_op,
                           bytes_accessed=counter.bytes_accessed,
                           peak_bytes=counter.peak, ops=counter.ops,
                           matmul_flops=mm,
                           elementwise_flops=counter.elementwise_flops,
                           transcendentals=counter.transcendentals,
                           collectives=counter.collectives)


def trace_step(arch: ArchConfig, shape: ShapeSpec, *, device: str = "cuda",
               overrides: Optional[Dict[str, Any]] = None,
               remat: str = "full", microbatches: int = 1, mesh=None,
               sharding_mode: str = "fsdp",
               rule_updates: Optional[Dict[str, Any]] = None
               ) -> Tuple[StepCounts, Runtime]:
    """Count one step of `arch` at `shape` on fake tensors of `device`
    (`torch._subclasses.fake_tensor.FakeTensorMode`): no memory is
    allocated and no kernel runs, whatever the shape.  The step is the one
    `make_train_step` / `make_prefill_step` / `make_serve_step` build,
    through the plain paths (`use_kernels=False`, as the reference's
    dry-run traces without Pallas; the ctypes kernels are invisible to
    dispatch modes anyway), on parameters in the cell's dtype.  A train
    step is forward, backward (with `remat`'s recompute) and the AdamW
    update over `microbatches` microbatches, from fp32 params and
    moments.  A decode step writes one token at position `seq_len - 1`
    against a `seq_len`-deep cache, made by `init_cache` under the cell's
    runtime (an f8 KV cache under `kv_dtype="f8"`).  The whole step is
    counted once; a `layers.scan` counts one step for the others
    (`count_step`; the reference's scan probes have no counterpart).

    With a `mesh` (a `DeviceMesh` on `device` over an initialised group,
    fake or real) this is the counterpart of the reference's
    `build_step_bundle` on a mesh: the runtime carries the mesh and the
    cell's rules (`sharding_mode`, `rule_updates`), every argument (the
    params, AdamW's state, the batch, the caches, the token and its
    position) is placed at `step_placements(...).inputs` as a DTensor,
    and the same step runs on them, counted per rank (`count_step`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    model = build_model(arch)
    rt = make_runtime(arch, shape, remat=remat, overrides=overrides,
                      mesh=mesh, sharding_mode=sharding_mode,
                      rule_updates=rule_updates)
    lay = (step_placements(arch, shape, mesh, sharding_mode=sharding_mode,
                           rule_updates=rule_updates).inputs
           if mesh is not None else None)

    def placed(tree, i):
        # fake tensors hold no data to send: each rank cuts its own shard
        return tree if lay is None else place_params(tree, mesh, lay[i],
                                                     src_data_rank=None)

    with FakeTensorMode():
        params = placed(map_specs(
            lambda s: torch.empty(s.shape, device=device,
                                  dtype=s.resolved_dtype(rt.param_dtype)),
            model.param_specs()), 0)
        specs = input_specs(arch, shape)
        if shape.mode in ("train", "prefill"):
            batch = placed({name: torch.zeros(shp, dtype=dt, device=device)
                            for name, (shp, dt) in specs.items()},
                           2 if shape.mode == "train" else 1)
        if shape.mode == "train":
            step = torch.zeros((), dtype=torch.int32, device=device)
            if lay is not None:
                step = place_params(step, mesh, lay[1].step,
                                    src_data_rank=None)
            # the moments take the params' placements, as their layouts do
            state = AdamWState(
                step=step, mu=pytree.tree_map(torch.zeros_like, params),
                nu=pytree.tree_map(torch.zeros_like, params))
            args = {"params": params, "opt_state": state, "batch": batch}
            fn = make_train_step(model, rt, microbatches=microbatches)
        elif shape.mode == "prefill":
            args = {"params": params, "batch": batch}
            fn = make_prefill_step(model, rt)
        else:
            args = {"params": params,
                    "cache": placed(model.init_cache(
                        shape.global_batch, shape.seq_len, rt, device), 1),
                    "token": placed(torch.zeros(
                        specs["token"][0], dtype=torch.int64,
                        device=device), 2),
                    "pos": placed(torch.full(
                        (), shape.seq_len - 1, dtype=torch.int64,
                        device=device), 3)}
            fn = make_serve_step(model, rt)
        arg_bytes = {name: sum(_local(t).numel() * _local(t).element_size()
                               for t in tree_leaves(tree))
                     for name, tree in args.items()}
        _, counts = count_step(fn, *args.values())
    counts.arg_bytes = arg_bytes
    return counts, rt
