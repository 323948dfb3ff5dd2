"""Model-zoo DSE workloads: the port's decoders as traced
`ComputationGraph` apps.

The twin of `repro.frontend.zoo`.  For each architecture it traces the
port's model code (`repro_torch.models.lm`, and `repro_torch.models.encdec`
for whisper-medium) with
`frontend.trace.trace_to_graph` on fake tensors at full width, and
exposes the graph under the reference's `<arch>:<variant>` names, which
`repro_torch.core.apps.build_app` resolves:

    variant "prefill" — `forward` at `PREFILL_SEQ` tokens with
                        `last_only` logits (serving prefill; whisper's
                        over `min(encoder_seq, ENCODER_SEQ)` fp32 frames);
    variant "decode"  — `decode_step` against a `DECODE_CACHE`-slot cache,
                        returning the caches, so the liveness profile sees
                        KV-cache residency and the single-row products
                        lower to `Op.matvec` (whisper's encoder_seq cut to
                        `DECODE_CACHE`, its cross caches with it).

Both run with the reference's `Runtime()` defaults and `use_kernels=False`
(a ctypes kernel launch is invisible to a dispatch mode).  The decode
step takes the reference's parameter layout — each group's leaves stacked
on its repeats — and slices one layer out at a time, as the reference's
`decode_step` does; the prefill takes one parameter per layer, as the
reference's scan hands each step its slice.  `EncDecLM` takes the
reference's stacked layout itself and scans its layers (`layers.scan`).

Two parts of the prefill are traced in the reference's form, so that the
graph is the reference's while the serving code stays as it is:

  * `prefill_fn` walks `DecoderLM.forward`'s layers a group at a time,
    each group's repeats as one scan (`trace.scan_repeats`): the
    reference's scan makes an attention slot's rotary table once a group;
  * the RG-LRU block's plain scan is `associative_scan`'s odd/even
    recursion, op for op (`_associative_scan`), in place of the port's
    log-step doubling (`kernels.rg_lru.rglru_scan_plain`, the kernels'
    yardstick), whose values are the same and whose ops are not.

Graphs are memoized per process; listing `ZOO_APP_NAMES` costs nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.core.graph import ComputationGraph
from repro_torch.frontend.trace import scan_repeats, trace_to_graph
from repro_torch.kernels import rg_lru
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.layers import Runtime, map_specs
from repro_torch.models.lm import DecoderLM, block_apply_train, plan_groups

__all__ = ["ZOO_APP_NAMES", "ZOO_VARIANTS", "PORTED_ARCHS", "build_zoo_app",
           "prefill_fn", "PREFILL_SEQ", "ENCODER_SEQ", "DECODE_CACHE"]

# the reference's workload shapes (`repro.frontend.zoo`)
PREFILL_SEQ = 128
ENCODER_SEQ = 256          # audio-family encoder frames (whisper)
DECODE_CACHE = 128         # KV-cache slots resident during a decode step

ZOO_VARIANTS: Tuple[str, ...] = ("prefill", "decode")

ZOO_APP_NAMES: Tuple[str, ...] = tuple(
    f"{arch}:{variant}" for arch in ARCH_NAMES for variant in ZOO_VARIANTS)

# the archs whose models the port has: every one
PORTED_ARCHS: Tuple[str, ...] = ARCH_NAMES


def _meta(spec, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(spec.shape, dtype=spec.resolved_dtype(dtype),
                       device="meta")


def _combine(a1, b1, a2, b2):
    """The affine map h -> a2 (a1 h + b1) + b2, the recurrence's monoid."""
    return a1 * a2, a2 * b1 + b2


def _interleave(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x[0], y[0], x[1], y[1], ... along dim 1 (x as long as y or one
    longer), as zero-padded copies added: the reference's interleave."""
    xp = F.pad(x.unsqueeze(2), (0, 0, 0, 1)).flatten(1, 2)
    yp = F.pad(y.unsqueeze(2), (0, 0, 1, 0)).flatten(1, 2)
    if x.shape[1] != y.shape[1]:
        xp, yp = xp[:, :-1], F.pad(yp, (0, 0, 0, 1))
    return xp + yp


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the maps (a, b) along dim 1 by odd/even recursion:
    pairs combined, the half-length scan recursed, the even positions made
    from the odd ones, the two interleaved (`jax.lax.associative_scan`'s
    algorithm, op for op, the scanned a included)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, 0:1], ea], dim=1)
    eb = torch.cat([b[:, 0:1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _reference_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`rglru_scan_plain`'s function in the reference's ops: h in fp32,
    returned in a's dtype."""
    return _associative_scan(a.float(), b.float())[1].to(a.dtype)


@contextlib.contextmanager
def _scan_as_the_reference() -> Iterator[None]:
    """The RG-LRU block's plain scan is `_reference_scan` inside."""
    saved = rg_lru.rglru_scan_plain
    rg_lru.rglru_scan_plain = _reference_scan
    try:
        yield
    finally:
        rg_lru.rglru_scan_plain = saved


def prefill_fn(model: DecoderLM, rt: Runtime) -> Callable:
    """`model.forward(params, {"tokens": toks}, rt, last_only=True)` with
    its layers walked a group at a time, each group's repeats as one scan
    (`scan_repeats`), as the reference's forward scans them: the same
    calls in the same order, so the same values."""
    def fn(params, toks):
        x = model._embed_inputs(params, {"tokens": toks}, rt)
        layers = iter(zip(model.kinds, params["layers"]))
        for g in model.groups:
            for _ in scan_repeats(g.repeats):
                for _ in g.unit:
                    kind, p = next(layers)
                    x = block_apply_train(model.cfg, kind, p, x, rt)
        return model._logits(params, x[:, -1:], rt).to(rt.compute_dtype)
    return fn


def _prefill_graph(arch_name: str) -> ComputationGraph:
    arch = get_arch(arch_name)
    rt = Runtime()
    name = f"{arch_name}:prefill"
    tokens = torch.empty((1, PREFILL_SEQ), dtype=torch.int64, device="meta")
    if arch.is_encdec:
        model = EncDecLM(arch)
        frames = torch.empty((1, min(arch.encoder_seq, ENCODER_SEQ),
                              arch.d_model), device="meta")

        def fn(params, toks, frm):
            return model.forward(params, {"tokens": toks, "frames": frm},
                                 rt, last_only=True)

        params = map_specs(lambda s: _meta(s, rt.param_dtype),
                           model.param_specs())
        return trace_to_graph(fn, params, tokens, frames, name=name)
    model = DecoderLM(arch)
    params = map_specs(lambda s: _meta(s, rt.param_dtype),
                       model.param_specs())
    with _scan_as_the_reference():
        return trace_to_graph(prefill_fn(model, rt), params, tokens,
                              name=name)


def _stacked_params(model: DecoderLM, dtype: torch.dtype):
    """The reference's layout: ``groups`` of unit dicts whose leaves are
    stacked on the group's repeats (when it repeats)."""
    specs = model.param_specs()
    layers = iter(specs.pop("layers"))
    groups = []
    for g in plan_groups(model.cfg):
        units = [[next(layers) for _ in g.unit] for _ in range(g.repeats)]
        groups.append([
            map_specs(lambda s, r=g.repeats: torch.empty(
                ((r,) if r > 1 else ()) + tuple(s.shape),
                dtype=s.resolved_dtype(dtype), device="meta"), units[0][i])
            for i in range(len(g.unit))])
    out = map_specs(lambda s: _meta(s, dtype), specs)
    out["groups"] = groups
    return out


def _unstack(model: DecoderLM, params):
    """Per-layer parameter dicts sliced out of the stacked groups, a layer
    at a time, as the reference's `decode_step` slices them."""
    layers = []
    for g, gparams in zip(plan_groups(model.cfg), params["groups"]):
        for r in range(g.repeats):
            for unit in gparams:
                layers.append({k: _slice(v, r, g.repeats)
                               for k, v in unit.items()})
    out = {k: v for k, v in params.items() if k != "groups"}
    out["layers"] = layers
    return out


def _slice(tree, r: int, repeats: int):
    if isinstance(tree, dict):
        return {k: _slice(v, r, repeats) for k, v in tree.items()}
    return tree[r] if repeats > 1 else tree


def _decode_graph(arch_name: str) -> ComputationGraph:
    arch = get_arch(arch_name)
    rt = Runtime()
    token = torch.empty((1, 1), dtype=torch.int64, device="meta")
    pos = torch.empty((), dtype=torch.int64, device="meta")
    if arch.is_encdec:
        # the reference's cut of the decode-time encoder context: the
        # cross caches are sized from encoder_seq, and 1500 frames push
        # the Eq. 13 activation floor past the default area budget
        model = EncDecLM(dataclasses.replace(
            arch, encoder_seq=min(arch.encoder_seq, DECODE_CACHE)))
        params = map_specs(lambda s: _meta(s, rt.param_dtype),
                           model.param_specs())

        def unstack(p):                 # its own layout is the stacked one
            return p
    else:
        model = DecoderLM(arch)
        params = _stacked_params(model, rt.param_dtype)
        unstack = functools.partial(_unstack, model)
    cache = map_specs(lambda s: _meta(s, torch.bfloat16),
                      model.cache_specs(1, DECODE_CACHE))

    def fn(params, c, t, p):
        # return the new caches too: their liveness is the decode story
        return model.decode_step(unstack(params), c, t, p, rt)

    return trace_to_graph(fn, params, cache, token, pos,
                          name=f"{arch_name}:decode")


_VARIANT_BUILDERS: Dict[str, Callable[[str], ComputationGraph]] = {
    "prefill": _prefill_graph,
    "decode": _decode_graph,
}


@functools.lru_cache(maxsize=None)
def build_zoo_app(name: str) -> ComputationGraph:
    """`"<arch>:<variant>"` -> traced `ComputationGraph` (memoized)."""
    if ":" not in name:
        raise KeyError(f"zoo app names look like 'qwen2-0.5b:prefill'; "
                       f"got {name!r}")
    arch_name, _, variant = name.partition(":")
    if arch_name not in ARCH_NAMES:
        raise KeyError(f"unknown architecture {arch_name!r}; "
                       f"available: {sorted(ARCH_NAMES)}")
    builder = _VARIANT_BUILDERS.get(variant)
    if builder is None:
        raise KeyError(f"unknown variant {variant!r}; "
                       f"available: {sorted(_VARIANT_BUILDERS)}")
    return builder(arch_name)
