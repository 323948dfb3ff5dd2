"""The traced stretch by program span: the device's time put down to the
span of the port (`repro_torch.obs.span`) that launched it, and the idle
gaps named by the span the host was in.

While `obs` tracing is on, each span of the port enters the profiler's
session as a host range of its name, on the profiler's own clock.  Each
device operation of the stretch (those `bench.trace` counts: kernels,
copies and sets, clipped to the stretch) goes to the innermost span whose
host interval holds the operation's launch: the runtime or driver call
that carries the operation's correlation id or, where the session holds
none, the host op the operation is linked to.  An operation launched
outside the root span `prefill` goes to `(unattributed)`.  A span's total
is the device time of the operations put down to it or to a span inside
it; its self time is the part put down to it alone.  The idle gaps (the
stretch less the union of the device's busy intervals, as `bench.trace`
takes them) are named by the innermost span running on the host at each
gap's middle, `(outside spans)` where none is.

`measure` takes such a stretch of one cell outside the benchmark's own
runs (`bench/by_span.py`): the harness's traced run leaves `obs` off, so
its line holds none of this.  `readings` turns a stretch into the
per-layer numbers the spans and counters give.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from bench import trace

__all__ = ["ROOT", "UNATTRIBUTED", "OUTSIDE", "DISPATCH", "Spans",
           "summarize", "attribute", "readings", "measure"]

ROOT = "prefill"
UNATTRIBUTED = "(unattributed)"
OUTSIDE = "(outside spans)"

# host ranges that are a runtime or driver call (cudaLaunchKernel,
# cuLaunchKernelEx, cudaMemcpyAsync, ...): the launches
_LAUNCH_PREFIX = "cu"
# the MoE block's routing and dispatch: the spans outside its experts
DISPATCH = ("moe.route", "moe.dispatch", "moe.combine")


@dataclasses.dataclass
class Spans:
    """One traced stretch of `forwards` forwards by span name: device
    seconds in total and self, and operations launched (`by_span`); idle
    seconds by the span the host was in (`idle_by_span`); each span's self
    seconds by operation name (`ops_by_span`)."""

    forwards: int
    by_span: Dict[str, Dict[str, float]]
    idle_by_span: Dict[str, float]
    ops_by_span: Dict[str, Dict[str, float]]


def _innermost(spans: Sequence[Tuple[int, int, str]],
               times: Sequence[int]) -> List[int]:
    """For each time (ascending), the index into `spans` (sorted by start,
    an outer span before an inner one of the same start; nested, as the
    spans of one thread are) of the innermost span holding it, or -1."""
    out: List[int] = []
    stack: List[int] = []
    nxt = 0
    for t in times:
        while nxt < len(spans) and spans[nxt][0] <= t:
            while stack and spans[stack[-1]][1] < spans[nxt][0]:
                stack.pop()
            stack.append(nxt)
            nxt += 1
        while stack and spans[stack[-1]][1] < t:
            stack.pop()
        out.append(stack[-1] if stack else -1)
    return out


def _parents(spans: Sequence[Tuple[int, int, str]]) -> List[int]:
    """Each span's enclosing span (index into the sorted `spans`), or -1."""
    parent: List[int] = []
    stack: List[int] = []
    for i, (a, b, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] < a:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    return parent


def attribute(spans: Iterable[Tuple[int, int, str]],
              ops: Iterable[Tuple[int, int, Optional[int], str]],
              window: Tuple[int, int], forwards: int) -> Spans:
    """The stretch `window` (ns) by span: `spans` are the program's host
    ranges (start, end, name), `ops` the device operations (start, end,
    launch time or None, name), clipped to the window."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    parent = _parents(spans)
    chains: List[Tuple[str, ...]] = []        # own name first, distinct
    under_root: List[bool] = []
    for i, (_, _, name) in enumerate(spans):
        up = chains[parent[i]] if parent[i] >= 0 else ()
        chains.append((name,) + tuple(n for n in up if n != name))
        under_root.append(name == ROOT
                          or (parent[i] >= 0 and under_root[parent[i]]))
    ops = sorted(ops, key=lambda o: -1 if o[2] is None else o[2])
    where = _innermost(spans, [-1 if o[2] is None else o[2] for o in ops])
    total: Dict[str, float] = collections.defaultdict(float)
    own: Dict[str, float] = collections.defaultdict(float)
    launches: Dict[str, int] = collections.defaultdict(int)
    by_op: Dict[str, Dict[str, float]] = collections.defaultdict(
        lambda: collections.defaultdict(float))
    for (a, b, launch, op), i in zip(ops, where):
        s = (b - a) * 1e-9
        if launch is None or i < 0 or not under_root[i]:
            chain: Tuple[str, ...] = (UNATTRIBUTED,)
        else:
            chain = chains[i]
        own[chain[0]] += s
        launches[chain[0]] += 1
        by_op[chain[0]][op[:trace._NAME_CHARS]] += s
        for name in chain:
            total[name] += s
    by_span = {name: {"total_s": total[name], "self_s": own[name],
                      "launches": launches[name]}
               for name in sorted(total, key=lambda n: -total[n])}
    s0, s1 = window
    busy = trace._union([(a, b) for a, b, _, _ in ops])
    edges = [s0] + [t for iv in busy for t in iv] + [s1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    idle: Dict[str, float] = collections.defaultdict(float)
    for (a, b), i in zip(gaps, _innermost(spans,
                                          [(a + b) // 2 for a, b in gaps])):
        idle[spans[i][2] if i >= 0 else OUTSIDE] += (b - a) * 1e-9
    return Spans(forwards=forwards, by_span=by_span, idle_by_span=dict(idle),
                 ops_by_span={k: dict(v) for k, v in by_op.items()})


def summarize(prof, forwards: int, names: Iterable[str]) -> Optional[Spans]:
    """The stretch marked `trace.STRETCH` in the session `prof` by the
    program's spans, the host ranges named as one of `names` (the span
    names `obs` recorded); None where the session holds no such stretch."""
    from torch.autograd import DeviceType
    names = set(names)
    events = prof.profiler.kineto_results.events()
    mark = [e for e in events if e.name() == trace.STRETCH
            and e.device_type() == DeviceType.CPU]
    if not mark:
        return None
    s0 = mark[0].start_ns()
    s1 = s0 + mark[0].duration_ns()
    spans: List[Tuple[int, int, str]] = []
    launch_at: Dict[int, int] = {}      # runtime / driver call, by its id
    op_at: Dict[int, int] = {}          # aten op or span, by its id
    device = []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name.startswith(_LAUNCH_PREFIX):
                launch_at[e.correlation_id()] = e.start_ns()
            elif name.startswith("aten::") or name in names:
                op_at[e.correlation_id()] = e.start_ns()
            if name in names:
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                              name))
        elif e.device_type() == DeviceType.CUDA \
                and not name.startswith(trace._MARKS):
            a = max(e.start_ns(), s0)
            b = min(e.start_ns() + e.duration_ns(), s1)
            if b > a:
                device.append((a, b, e))
    ops = []
    for a, b, e in device:
        launch = launch_at.get(e.correlation_id())
        if launch is None:
            launch = op_at.get(e.linked_correlation_id())
        ops.append((a, b, launch, e.name()))
    return attribute(spans, ops, (s0, s1), forwards)


def readings(s: Optional[Spans], counters: Dict[str, float]
             ) -> Dict[str, float]:
    """The per-layer numbers of a stretch, those it holds: device ms a
    forward of the MoE dispatch's spans (`moe_dispatch_span_ms`), of
    `moe.experts` (`moe_experts_ms`) and of `attn.core`
    (`attention_core_ms`), each with the spans inside it; and from the
    counters, the useful share of the expert slots, 100 (pairs routed -
    pairs dropped at capacity) / slots (`moe_slot_fill_pct`)."""
    out: Dict[str, float] = {}
    by = s.by_span if s is not None else {}
    for name, group in (("moe_dispatch_span_ms", DISPATCH),
                        ("moe_experts_ms", ("moe.experts",)),
                        ("attention_core_ms", ("attn.core",))):
        if any(n in by for n in group):
            out[name] = 1e3 * sum(by[n]["total_s"] for n in group
                                  if n in by) / s.forwards
    if counters.get("moe.slots"):
        out["moe_slot_fill_pct"] = 100.0 * (
            counters["moe.pairs_routed"] - counters["moe.pairs_dropped"]) \
            / counters["moe.slots"]
    return out


def measure(cell, seed: int, device) -> Dict[str, Any]:
    """One traced stretch of `cell` by span, as the benchmark's traced run
    takes its stretch but with `obs` on: tracing from the set-up's start
    (its kernel loads are recorded), the cell's warm-up and `trace_after`
    forwards, then `trace_forwards` forwards of fresh batches from `seed`
    in a profiler session with `obs` metrics counting.  `obs` is off
    again on return.  Returns `readings`, the stretch by span, its idle
    gaps by span, the counters (the stretch's MoE counters, and the
    set-up's `kernels.built` where it loaded a kernel library), the
    set-up's kernel loads (name, built, seconds), and the stretch's
    length, busy seconds and device operations' seconds as `bench.trace`
    takes them."""
    import torch

    from bench import harness
    from repro_torch import obs

    def forward(batch):
        step(inputs.params, {"tokens": batch})
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    tr = cell.traffic
    n = tr["trace_forwards"]
    obs.disable(reset=True)
    obs.enable(trace=True, metrics=False, journal=False)
    try:
        model, step = harness.build_step(cell)
        inputs = harness.make_inputs(cell, model, seed, device)
        harness.warm_up(step, inputs, device)
        loads = [[e["args"].get("name"), e["args"].get("built"),
                  e["dur"] * 1e-6] for e in obs.tracer().export()
                 if e.get("name") == "kernels.load"]
        inputs.draw(tr["trace_after"] + n)
        for batch in inputs.batches[:tr["trace_after"]]:
            forward(batch)
        obs.metrics().enabled = True
        with trace.profiled(device) as prof:
            with torch.profiler.record_function(trace.STRETCH):
                for batch in inputs.batches[tr["trace_after"]:]:
                    forward(batch)
        obs.metrics().enabled = False
        counters = obs.metrics().export()["counters"]
        names = {e["name"] for e in obs.tracer().export()
                 if e.get("ph") == "X"}
    finally:
        obs.disable(reset=True)
    stretch = trace.summarize(prof, n)
    s = summarize(prof, n, names)
    return {"readings": readings(s, counters),
            "by_span": s.by_span, "idle_by_span": s.idle_by_span,
            "ops_by_span": {k: trace.top(v) for k, v in
                            s.ops_by_span.items()},
            "counters": counters, "setup": loads, "forwards": n,
            "window_s": stretch.window_s, "busy_s": stretch.busy_s,
            "device_ops_s": sum(stretch.device_ops.values())}
