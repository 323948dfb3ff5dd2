"""Step builders of the port: `build_model`, `make_runtime`,
`input_specs`, the serving steps `make_prefill_step` / `make_serve_step`,
and `trace_step`, which counts one serving step on fake tensors for the
dry-run (`launch.dryrun`).

The reference builds jit-able steps over a device mesh; on one GPU a step
is a plain function that runs eagerly under `torch.inference_mode` and
`layers.full_precision_products`, over a `DecoderLM` or, for the
encoder-decoder (whisper-medium), an `EncDecLM`.  The
training step, the mesh and the sharding rules are ported in a later
slice (see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils import _pytree as pytree
from torch.utils._pytree import tree_leaves

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (STEP_COUNTERS, Runtime,
                                       full_precision_products, map_specs,
                                       not_ported, slice_of)
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lm import DecoderLM

Model = Union[DecoderLM, EncDecLM]

__all__ = ["build_model", "make_runtime", "input_specs",
           "make_prefill_step", "make_serve_step", "StepCounts",
           "count_step", "trace_step"]


def build_model(arch: ArchConfig) -> Model:
    if arch.is_encdec:
        return EncDecLM(arch)
    return DecoderLM(arch)


def make_runtime(arch: ArchConfig, shape: ShapeSpec, *,
                 use_kernels: bool = False,
                 overrides: Optional[Dict[str, Any]] = None) -> Runtime:
    """Execution point for one (arch, shape) cell.  Serving shapes run
    bf16 weights, as in the reference (half the memory and the bytes of
    every weight read)."""
    kw: Dict[str, Any] = {"use_kernels": use_kernels}
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


def make_prefill_step(model: Model, rt: Runtime) -> Callable:
    def prefill_step(params, batch):
        # the sampler needs only the last position's logits
        with torch.inference_mode(), full_precision_products():
            logits = model.forward(params, batch, rt, last_only=True)
        return logits[:, -1, :]
    return prefill_step


def make_serve_step(model: Model, rt: Runtime) -> Callable:
    def serve_step(params, cache, token, pos):
        with torch.inference_mode(), full_precision_products():
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
    allocator rounding, no library workspace."""

    flops: int
    flops_by_op: Dict[str, int]
    bytes_accessed: int
    peak_bytes: int
    ops: int
    matmul_flops: int = 0
    elementwise_flops: int = 0
    transcendentals: int = 0


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
    if name == "pow" and isinstance(args[1], (int, float)) and args[1] == 2:
        return out, 0                 # x * x
    f, tr = _ELEMENTWISE.get(name, (1, 0))
    return f * out, tr * out


class _Counter(TorchDispatchMode):
    """Live storage bytes (with their peak) for every op, and operand and
    result bytes, elementwise FLOPs and transcendentals while `counting` is
    set."""

    def __init__(self):
        super().__init__()
        self.sizes: Dict[int, int] = {}
        self.live = self.peak = 0
        self.bytes_accessed = self.ops = 0
        self.elementwise_flops = self.transcendentals = 0
        self.counting = False

    def hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.sizes:
            return
        self.sizes[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self.sizes.pop(key)

    def repeat_scan(self, step, carry, xs, n: int):
        """`layers.scan` of `n` steps, run once: the first step is counted
        and its counts (ops, bytes, elementwise FLOPs, transcendentals and
        `flop_counter`'s matmul FLOPs by op) are added `n - 1` times more.
        The step then runs again, uncounted, as the loop's last step runs:
        from a carry of its own, beside the first carry and one stand-in
        allocation of the other steps' outputs (the loop's list holds
        them until the stack; an output written in place into its slice
        of the xs, a KV cache layer, holds nothing), so the peak is the
        loop's."""
        flops = self.flop_counter.flop_counts["Global"]
        fields = ("ops", "bytes_accessed", "elementwise_flops",
                  "transcendentals")
        was, was_flops = [getattr(self, f) for f in fields], dict(flops)
        leaves, spec = pytree.tree_flatten(xs)
        x0 = pytree.tree_unflatten([x[0] for x in leaves], spec)
        y = step(carry, x0)[1]
        def written_in_place(t):
            return next((x for x in leaves if slice_of(t, x, 0)), None)

        held_shapes = [((n - 1,) + tuple(t.shape), t.dtype)
                       for t in pytree.tree_leaves(y)
                       if isinstance(t, torch.Tensor)
                       and written_in_place(t) is None]
        del y
        counted = dict(flops)
        self.counting = False
        held = [torch.empty(shape, dtype=dtype, device=leaves[0].device)
                for shape, dtype in held_shapes]
        # the last step's input carry, apart from the first's
        last = pytree.tree_map_only(torch.Tensor, torch.empty_like, carry)
        carry, y = step(last, x0)
        del last
        self.counting = True
        flops.clear()
        flops.update({op: c + (n - 1) * (c - was_flops.get(op, 0))
                      for op, c in counted.items()})
        for f, w in zip(fields, was):
            setattr(self, f, getattr(self, f) + (n - 1) * (
                getattr(self, f) - w))
        def stacked(t):
            src = written_in_place(t)
            return src if src is not None else torch.stack([t] * n)

        ys = None if y is None else pytree.tree_map_only(
            torch.Tensor, stacked, y)
        del held
        return carry, ys

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self.hold(t)
        # ops with no tensor result (device or size queries) move nothing
        if self.counting and outs and not func.is_view:
            self.ops += 1
            self.bytes_accessed += sum(
                t.numel() * t.element_size()
                for t in tree_leaves((args, kwargs)) + outs
                if isinstance(t, torch.Tensor))
            flops, trans = _elementwise_cost(func, args, outs)
            self.elementwise_flops += flops
            self.transcendentals += trans
        return out


def count_step(step: Callable, *args) -> Tuple[Any, StepCounts]:
    """Run `step(*args)` once and count it (`StepCounts`); on real or fake
    tensors alike.  Returns the step's output and the counts.  A
    `layers.scan` inside (the xLSTM blocks' loops) runs one step and
    counts it for all (`_Counter.repeat_scan`): the counts are exact, the
    output is not the model's where such a scan ran."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = _Counter()
    STEP_COUNTERS.append(counter)
    try:
        with counter:
            for t in tree_leaves(args):
                if isinstance(t, torch.Tensor):
                    counter.hold(t)
            counter.counting = True
            with FlopCounterMode(display=False) as flop_counter:
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
                           transcendentals=counter.transcendentals)


def trace_step(arch: ArchConfig, shape: ShapeSpec, *, device: str = "cuda",
               overrides: Optional[Dict[str, Any]] = None
               ) -> Tuple[StepCounts, Runtime]:
    """Count one serving step of `arch` at `shape` on fake tensors of
    `device` (`torch._subclasses.fake_tensor.FakeTensorMode`): no memory is
    allocated and no kernel runs, whatever the shape.  The step is the one
    `make_prefill_step` / `make_serve_step` build, through the plain paths
    (`use_kernels=False`, as the reference's dry-run traces without
    Pallas; the ctypes kernels are invisible to dispatch modes anyway), on
    parameters in the serving dtype.  A decode step writes one token at
    position `seq_len - 1` against a `seq_len`-deep cache, made by
    `init_cache` under the cell's runtime (an f8 KV cache under
    `kv_dtype="f8"`).  The whole step is counted once, a `layers.scan`
    over layers one step for all (the reference's scan probes have no
    counterpart)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if shape.mode == "train":
        raise not_ported("the train step")
    model = build_model(arch)
    rt = make_runtime(arch, shape, overrides=overrides)
    with FakeTensorMode():
        params = map_specs(
            lambda s: torch.empty(s.shape, device=device,
                                  dtype=s.resolved_dtype(rt.param_dtype)),
            model.param_specs())
        specs = input_specs(arch, shape)
        if shape.mode == "prefill":
            batch = {name: torch.zeros(shp, dtype=dt, device=device)
                     for name, (shp, dt) in specs.items()}
            _, counts = count_step(make_prefill_step(model, rt), params,
                                   batch)
        else:
            cache = model.init_cache(shape.global_batch, shape.seq_len, rt,
                                     device)
            token = torch.zeros(specs["token"][0], dtype=torch.int64,
                                device=device)
            pos = torch.full((), shape.seq_len - 1, dtype=torch.int64,
                             device=device)
            _, counts = count_step(make_serve_step(model, rt), params,
                                   cache, token, pos)
    return counts, rt
