"""One run of a cell: set-up, the measured window, the traced stretch and
the check, ending in the result line.

The system under test is the port's serving prefill step,
`repro_torch.launch.steps.make_prefill_step(build_model(cfg),
make_runtime(cfg, shape, use_kernels=True))`, driven in a closed loop: one
batch of prompts at a time, each forward synchronised before the next is
sent.  Weights and token batches are made on the device from the seed
before the window; the window's batches are all different.  After the
window, a sample of its forwards (drawn from the seed) is compared with
the plain reference (`bench.check`).
"""

from __future__ import annotations

import dataclasses
import json
import math
import random
import statistics
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from bench import check, trace
from bench.spec import Cell, SpecError

__all__ = ["FOREIGN", "foreign_modules", "port_arch", "make_params",
           "Inputs", "make_inputs", "window_batches", "build_step",
           "warm_up", "reference_logits", "compare", "run", "report"]

# top-level module names that may not be loaded in a run: JAX and the JAX
# package, compared whole (the port's name begins with the latter's)
FOREIGN = ("jax", "jaxlib", "flax", "repro")

# leaves of the weight tree start on 64-element boundaries
_ALIGN = 64


def foreign_modules() -> List[str]:
    """The loaded modules whose top-level name is one of `FOREIGN`."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


def port_arch(config: Dict[str, Any]):
    """The port's `ArchConfig` as the configuration file states it: the
    registry's `arch` with the file's `port` fields."""
    from repro_torch import configs
    base = configs.get_arch(config["arch"])
    fields = dict(config["port"])
    for group in ("moe", "mla"):
        if group in fields:
            fields[group] = dataclasses.replace(getattr(base, group),
                                                **fields[group])
    return dataclasses.replace(base, **fields)


def make_params(specs, gen: torch.Generator, dtype: torch.dtype):
    """Weights in the layout `specs` describes (the model's parameter
    specs), made in one draw of normals on the generator's device and
    scaled a leaf at a time: std min(0.02, fan_in^-1/2) (0.006 for
    "small"), fan_in the second-last dimension; norm scales ones, biases
    zeros."""
    from repro_torch.models.layers import map_specs
    sizes: List[int] = []

    def size(s):
        if s.dtype not in (None, "bf16") or s.init not in (
                "normal", "small", "ones", "zeros"):
            raise SpecError(f"a weight of dtype {s.dtype} and init {s.init}: "
                            f"the benchmark makes only bf16 weights")
        sizes.append(math.prod(s.shape))
    map_specs(size, specs)
    offsets = [0]
    for n in sizes:
        offsets.append(offsets[-1] + -(-n // _ALIGN) * _ALIGN)
    flat = torch.randn(offsets[-1], generator=gen, dtype=dtype,
                       device=gen.device)
    where = iter(offsets)

    def leaf(s):
        o = next(where)
        t = flat[o:o + math.prod(s.shape)].view(s.shape)
        if s.init == "ones":
            return t.fill_(1)
        if s.init == "zeros":
            return t.zero_()
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        base = 0.02 if s.init == "normal" else 0.006
        return t.mul_(min(base, fan_in ** -0.5))
    return map_specs(leaf, specs)


@dataclasses.dataclass
class Inputs:
    """A run's weights and token batches, all made from its seed: the
    weights, the warm-up's batches, then the window's, one draw a batch,
    so that a seed's batch i is the same however many are drawn."""

    params: Any
    gen: torch.Generator
    shape: Tuple[int, int]      # (batch, seq)
    vocab: int
    warmup: List[torch.Tensor]
    batches: List[torch.Tensor] = dataclasses.field(default_factory=list)

    def _draw(self) -> torch.Tensor:
        return torch.randint(0, self.vocab, self.shape, generator=self.gen,
                             device=self.gen.device)

    def draw(self, n: int) -> None:
        """n more of the window's batches."""
        self.batches += [self._draw() for _ in range(n)]


def make_inputs(cell: Cell, model, seed: int, device: torch.device
                ) -> Inputs:
    tr = cell.traffic
    gen = torch.Generator(device=device).manual_seed(seed)
    params = make_params(model.param_specs(), gen, torch.bfloat16)
    inputs = Inputs(params, gen, (tr["batch"], tr["seq"]),
                    cell.config["vocab_size"], [])
    inputs.warmup = [inputs._draw() for _ in range(tr["warmup_forwards"])]
    return inputs


def window_batches(tr: Dict[str, Any], seconds: float,
                   forward_s: float) -> int:
    """The batches a window of `seconds` needs at the warm-up's fastest
    forward `forward_s` (not its first, which loads the kernels: a
    traffic mix warms up twice or more), with room for forwards three
    times as fast and the traced stretch."""
    return math.ceil(3 * seconds / max(forward_s, 1e-6)) \
        + tr["trace_forwards"] + 2


def build_step(cell: Cell):
    """The model and the timed step of the cell's configuration."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.steps import (build_model, make_prefill_step,
                                          make_runtime)
    tr = cell.traffic
    arch = port_arch(cell.config)
    shape = ShapeSpec(tr["name"], tr["seq"], tr["batch"], "prefill")
    model = build_model(arch)
    rt = make_runtime(arch, shape, use_kernels=True, overrides={
        "moe_group_size": cell.config["moe_group_size"]})
    return model, make_prefill_step(model, rt)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Window:
    times: List[float]                      # each forward, send to ready
    wall_s: float
    outs: List[torch.Tensor]
    stretch: Optional[trace.Stretch]


def _window(step, inputs: Inputs, seconds: float, tr: Dict[str, Any],
            device: torch.device, traced: bool) -> Window:
    """Forwards back to back until `seconds` have passed; the last one
    started ends the window.  Traced, `trace_forwards` forwards after the
    first `trace_after` run inside a profiler session."""
    times: List[float] = []
    outs: List[torch.Tensor] = []

    def forward():
        i = len(outs)
        if i == len(inputs.batches):
            raise RuntimeError(f"the window outran its {i} batches, "
                               f"drawn for three times the warm-up's pace")
        t = time.perf_counter()
        out = step(inputs.params, {"tokens": inputs.batches[i]})
        _sync(device)
        times.append(time.perf_counter() - t)
        outs.append(out)

    def stretch():
        with trace.profiled(device) as prof:
            with torch.profiler.record_function(trace.STRETCH):
                for _ in range(tr["trace_forwards"]):
                    forward()
        return prof

    prof = None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if traced and prof is None and len(outs) >= tr["trace_after"]:
            prof = stretch()
        else:
            forward()
    if traced and prof is None:
        prof = stretch()
    wall = time.perf_counter() - t0
    summary = trace.summarize(prof, tr["trace_forwards"]) if traced else None
    return Window(times, wall, outs, summary)


@dataclasses.dataclass
class Context:
    """What a per-layer metric reader reads."""

    config: Dict[str, Any]
    traffic: Dict[str, Any]
    device_kind: str
    times: List[float]
    stretch: Optional[trace.Stretch]


def _end_to_end(name: str, win: Window, tr: Dict[str, Any], setup_s: float,
                peak: int) -> float:
    if name == "prefill_tok_s":
        return len(win.times) * tr["batch"] * tr["seq"] / win.wall_s
    if name == "ttft_p90_ms":
        if len(win.times) == 1:
            return win.times[0] * 1e3
        return statistics.quantiles(win.times, n=10,
                                    method="inclusive")[8] * 1e3
    if name == "peak_mem_gb":
        return peak / 1e9
    if name == "setup_s":
        return setup_s
    raise SpecError(f"end-to-end metric {name!r}: the harness does not "
                    f"measure it")


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


# about as many tokens as the reference takes at a time
REF_TOKENS = 16384


def reference_rows(cell: Cell) -> int:
    """Prompts the reference takes at a time: whole routing groups of the
    timed batch (so that its capacity drops are the batch's), about
    `REF_TOKENS` tokens."""
    b, s = cell.traffic["batch"], cell.traffic["seq"]
    group = min(cell.config["moe_group_size"], b * s)
    for rows in range(max(1, REF_TOKENS // s), 0, -1):
        if b % rows == 0 and rows * s % group == 0:
            return rows
    return b


def reference_logits(cell: Cell, params, tokens: torch.Tensor,
                     precision: str = "fp32") -> torch.Tensor:
    """The plain reference's last-position logits of tokens [B, S], taken
    `reference_rows` prompts at a time."""
    rows = reference_rows(cell)
    return torch.cat([cell.reference.last_logits(cell.config, params,
                                                 tokens[i:i + rows],
                                                 precision)
                      for i in range(0, tokens.shape[0], rows)])


def compare(cell: Cell, params, batches: List[torch.Tensor],
            outs: Dict[int, torch.Tensor]) -> List[Dict[str, float]]:
    """`check.prompt_numbers` of the forwards `outs` (index -> served
    logits) against the plain reference over the same tokens."""
    vocab = cell.config["vocab_size"]
    rows: List[Dict[str, float]] = []
    for f, got in sorted(outs.items()):
        ref = reference_logits(cell, params, batches[f])
        rows += check.prompt_numbers(got[:, :vocab].float(), ref)
    return rows


def warm_up(step, inputs: Inputs, device: torch.device) -> List[float]:
    """The warm-up's forwards on the cell's own shape; their times."""
    times = []
    for batch in inputs.warmup:
        t = time.perf_counter()
        step(inputs.params, {"tokens": batch})
        _sync(device)
        times.append(time.perf_counter() - t)
    return times


def run(cell: Cell, *, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float,
        break_step: Optional[Callable] = None) -> Dict[str, Any]:
    """One run of `cell`; returns the result line's object.  `break_step`
    (tests only) wraps the timed step to plant a fault under it."""
    tr = cell.traffic
    model, step = build_step(cell)
    if break_step is not None:
        step = break_step(step)
    inputs = make_inputs(cell, model, seed, device)
    inputs.draw(window_batches(tr, seconds, min(warm_up(step, inputs,
                                                        device))))
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    win = _window(step, inputs, seconds, tr, device, traced)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    metrics: Dict[str, Dict[str, Any]] = {}
    dev: Dict[str, Any] = {"platform": "gpu" if cuda else "cpu",
                           "kind": kind, "count": cell.chips,
                           "memory_peak_bytes": max(setup_peak, window_peak)}
    result: Dict[str, Any] = {}
    if traced:
        ctx = Context(cell.config, tr, kind, win.times, win.stretch)
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if win.stretch is not None:
            dev.update(busy_s=win.stretch.busy_s,
                       window_s=win.stretch.window_s)
            result["breakdown"] = {
                "device_ops": trace.top(win.stretch.device_ops),
                "idle_gaps": trace.top(win.stretch.idle_gaps)}
        result["power_limit"] = _power_limit() if cuda else None
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": _end_to_end(
                m["name"], win, tr, setup_s, window_peak), "unit": m["unit"]}

    # the check: every output finite, and a sample of the window's forwards
    # against the plain reference, once the program's outputs but those
    # sampled are freed
    failed = sum(int((~torch.isfinite(o.float())).any(dim=-1).sum())
                 for o in win.outs)
    pick = sorted(random.Random(seed).sample(
        range(len(win.outs)), min(tr["check_forwards"], len(win.outs))))
    outs = {f: win.outs[f] for f in pick}
    win.outs.clear()
    numbers = check.cell_numbers(compare(cell, inputs.params,
                                         inputs.batches, outs))
    verdict = check.judge(numbers, cell.limits["limits"])
    result.update(
        correct=failed == 0 and all(v["ok"] for v in verdict.values()),
        attempted=len(win.times) * tr["batch"], failed=failed,
        metrics=metrics, device=dev, forwards=len(win.times),
        checked_forwards=pick, readings=numbers,
        checks={k: {"value": v["value"], "limit": v["limit"]}
                for k, v in verdict.items()})
    return result


def report(result: Dict[str, Any]) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, and the result as the last line of standard output, its
    `checks` last."""
    print(f"correct {result['correct']}", file=sys.stderr)
    for k, v in result["checks"].items():
        ok = "ok" if v["value"] <= v["limit"] else "OVER"
        print(f"check {k} {v['value']!r} limit {v['limit']!r} {ok}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
