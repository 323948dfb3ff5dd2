"""The traced stretch by program span (`bench.spans`): a device operation
goes to the innermost span holding its launch, a launch outside `prefill`
to `(unattributed)`, an idle gap to the span at its middle, a span's self
time is its total less its children's; the port's prefill opens the spans
the benchmark reads, nested as they are read, and the same logits with
`obs` on; `measure` takes such a stretch and the benchmark's own runs
leave `obs` off; and, on a card, a traced stretch put down to spans
whole."""

import json
import subprocess
import sys
import types

import pytest
import torch

from _tiny import ROOT, TINY

from bench import harness, spans, spec, trace

NS = 1e-9


def _by(s, name, key="total_s"):
    return s.by_span[name][key]


# ------------------------------------------------------ synthetic stretches

SPANS = [(0, 100, "prefill"), (10, 50, "moe"), (12, 20, "moe.route"),
         (30, 40, "moe.dispatch"), (60, 90, "layer"), (200, 300, "kernels")]


def _named(ops):
    return [(a, b, t, f"k{i % 3}") for i, (a, b, t) in enumerate(ops)]


def test_operation_goes_to_the_innermost_span_holding_its_launch():
    ops = [(1000, 1010, 15), (1010, 1030, 35), (1030, 1070, 45),
           (1070, 1100, 70), (1100, 1101, 5)]
    s = spans.attribute(SPANS, _named(ops), (1000, 1200), 1)
    assert _by(s, "moe.route", "self_s") == pytest.approx(10 * NS)
    assert _by(s, "moe.dispatch", "self_s") == pytest.approx(20 * NS)
    assert _by(s, "moe", "self_s") == pytest.approx(40 * NS)
    assert _by(s, "layer", "self_s") == pytest.approx(30 * NS)
    assert _by(s, "prefill", "self_s") == pytest.approx(1 * NS)
    assert _by(s, "prefill") == pytest.approx(101 * NS)
    assert {n: v["launches"] for n, v in s.by_span.items()} == {
        "prefill": 1, "moe": 1, "moe.route": 1, "moe.dispatch": 1,
        "layer": 1}
    assert s.ops_by_span["moe"] == pytest.approx({"k2": 40 * NS})
    assert s.ops_by_span["prefill"] == pytest.approx({"k1": 1 * NS})


def test_launch_outside_prefill_is_unattributed():
    ops = [(1000, 1010, 150), (1010, 1030, 250), (1030, 1040, None),
           (1040, 1050, 15)]
    s = spans.attribute(SPANS, _named(ops), (1000, 1100), 2)
    assert s.forwards == 2
    assert _by(s, spans.UNATTRIBUTED) == pytest.approx(40 * NS)
    assert s.by_span[spans.UNATTRIBUTED]["launches"] == 3
    assert "kernels" not in s.by_span
    assert _by(s, "moe.route") == pytest.approx(10 * NS)


def test_self_time_is_total_less_children():
    ops = [(a, a + 7, t) for a, t in zip(range(0, 700, 7),
                                         range(1, 100))]
    s = spans.attribute(SPANS, _named(ops), (0, 1000), 1)
    kids = {"prefill": ("moe", "layer"),
            "moe": ("moe.route", "moe.dispatch")}
    for name, children in kids.items():
        assert _by(s, name, "self_s") == pytest.approx(
            _by(s, name) - sum(_by(s, c) for c in children))
    total = sum(v["self_s"] for v in s.by_span.values())
    assert total == pytest.approx(sum(b - a for a, b, _ in ops) * NS)


def test_idle_gap_named_by_the_span_at_its_middle():
    # busy [20, 30] and [60, 80] of [0, 250]: the gaps' middles 10 and 45
    # lie in `moe`, 165 (of [80, 250]) in no span
    ops = [(20, 30, 15, "k"), (60, 80, 35, "k")]
    s = spans.attribute(SPANS, ops, (0, 250), 1)
    assert s.idle_by_span == pytest.approx(
        {"moe": 50 * NS, spans.OUTSIDE: 170 * NS})
    # busy [20, 30] and [60, 90] of [0, 100]: the last gap's middle 95
    # lies in `prefill` alone
    s = spans.attribute(SPANS, [(20, 30, 15, "k"), (60, 90, 35, "k")],
                        (0, 100), 1)
    assert s.idle_by_span == pytest.approx(
        {"moe": 50 * NS, "prefill": 10 * NS})


class _Event:
    """A profiler event as `kineto_results.events()` gives it."""

    def __init__(self, name, device, start, dur, corr=0, linked=0):
        self._v = (name, device, start, dur, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def _session(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_summarize_takes_the_launch_by_correlation():
    """A kernel's launch is the runtime or driver call with its
    correlation id (never a host op whose own id happens to be the same);
    without one, the host op it is linked to.  The by-span seconds are
    `bench.trace`'s device operations whole."""
    from torch.autograd import DeviceType
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        _Event(trace.STRETCH, cpu, 0, 1000, corr=1),
        _Event(trace.STRETCH, gpu, 300, 600, corr=1),    # its device copy
        _Event("prefill", cpu, 10, 900, corr=2),
        _Event("moe.route", cpu, 20, 100, corr=3),
        _Event("aten::topk", cpu, 30, 50, corr=4),
        _Event("cudaLaunchKernel", cpu, 40, 5, corr=4, linked=4),
        _Event("moe.experts", cpu, 200, 100, corr=5),
        _Event("aten::bmm", cpu, 210, 50, corr=6),
        _Event("cuLaunchKernelEx", cpu, 220, 5, corr=7, linked=6),
        _Event("lm.head", cpu, 400, 100, corr=8),
        _Event("aten::add", cpu, 410, 10, corr=7),       # id as the bmm's
        _Event("topk_kernel", gpu, 300, 100, corr=4, linked=4),
        _Event("nvjet_gemm", gpu, 400, 200, corr=7, linked=6),
        _Event("flash_kernel", gpu, 600, 50, corr=99, linked=8),
        _Event("orphan_kernel", gpu, 700, 20, corr=98, linked=0),
    ]
    names = {"prefill", "moe.route", "moe.experts", "lm.head"}
    s = spans.summarize(_session(events), 1, names)
    assert {n: v["self_s"] for n, v in s.by_span.items()} == pytest.approx(
        {"moe.route": 100 * NS, "moe.experts": 200 * NS,
         "lm.head": 50 * NS, spans.UNATTRIBUTED: 20 * NS,
         "prefill": 0.0})
    stretch = trace.summarize(_session(events), 1)
    assert sum(v["self_s"] for v in s.by_span.values()) == pytest.approx(
        sum(stretch.device_ops.values()))
    assert s.ops_by_span["moe.experts"] == pytest.approx(
        {"nvjet_gemm": 200 * NS})
    assert spans.summarize(_session(events[2:]), 1, names) is None


# ------------------------------------------------ the port's prefill spans

# each span of the prefill and the span it opens inside
PARENT = {"prefill": None, "lm.embed": "prefill", "layer": "prefill",
          "lm.head": "prefill", "attn": "layer", "attn.core": "attn",
          "mlp": "layer", "moe": "layer", "moe.route": "moe",
          "moe.dispatch": "moe", "moe.experts": "moe", "moe.combine": "moe",
          "moe.shared": "moe"}


@pytest.mark.parametrize("config", list(TINY))
def test_prefill_spans_nest_as_read(tiny, config):
    """Under a CPU profiler session with `obs` on, the prefill opens the
    spans of `PARENT`, each inside its parent, the MoE block's once a MoE
    layer, and serves the logits it serves with `obs` off."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    cell = spec.resolve(f"{config}.tiny", tiny)
    model, step = harness.build_step(cell)
    inputs = harness.make_inputs(cell, model, 2**31 + 3, torch.device("cpu"))
    batch = {"tokens": inputs.warmup[0]}
    plain = step(inputs.params, batch)
    obs.disable(reset=True)
    obs.enable(trace=True, metrics=True, journal=False)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = step(inputs.params, batch)
        counters = obs.metrics().export()["counters"]
    finally:
        obs.disable(reset=True)
    assert torch.equal(plain, traced)
    host = sorted(((e.start_ns(), e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() in PARENT), key=lambda s: (s[0], -s[1]))
    up = spans._parents(host)
    for (_, _, name), i in zip(host, up):
        assert (host[i][2] if i >= 0 else None) == PARENT[name], name
    count = {n: sum(1 for s in host if s[2] == n) for n in PARENT}
    moe = cell.config["port"]["moe"]
    n_layers = cell.config["port"]["num_layers"]
    n_moe = n_layers - moe["first_dense"]
    assert count == {
        "prefill": 1, "lm.embed": 1, "lm.head": 1, "layer": n_layers,
        "attn": n_layers, "attn.core": n_layers, "mlp": moe["first_dense"],
        "moe": n_moe, "moe.route": n_moe, "moe.dispatch": n_moe,
        "moe.experts": n_moe, "moe.combine": n_moe,
        "moe.shared": n_moe if moe["num_shared"] else 0}
    b, s = inputs.shape
    assert counters["moe.pairs_routed"] == n_moe * b * s * moe["top_k"]
    assert 0 <= counters["moe.pairs_dropped"] < counters["moe.pairs_routed"]


def test_readings_of_a_stretch():
    """The dispatch's three spans, the experts and the attention core, in
    ms a forward with the spans inside them; the slot fill from the
    counters; nothing for what the stretch does not hold."""
    ops = [(0, 10, 15, "k"), (10, 30, 35, "k"), (30, 70, 45, "k"),
           (70, 100, 70, "k")]
    s = spans.attribute(SPANS + [(70, 80, "moe.experts")], ops, (0, 100), 2)
    r = spans.readings(s, {"moe.pairs_routed": 40, "moe.pairs_dropped": 10,
                           "moe.slots": 50})
    assert r == pytest.approx({"moe_dispatch_span_ms": 15 * NS * 1e3,
                               "moe_experts_ms": 15 * NS * 1e3,
                               "moe_slot_fill_pct": 60.0})
    assert spans.readings(None, {}) == {}


@pytest.mark.parametrize("config", list(TINY))
def test_measure_on_the_cpu(tiny, config):
    """`measure` on the CPU: no device operation, so no span reads time,
    but the counters read; `obs` is left off with nothing recorded."""
    from repro_torch import obs
    cell = spec.resolve(f"{config}.tiny", tiny)
    out = spans.measure(cell, 2**31 + 13, torch.device("cpu"))
    assert set(out["readings"]) == {"moe_slot_fill_pct"}
    assert 0 < out["readings"]["moe_slot_fill_pct"] \
        <= 100 / cell.config["port"]["moe"]["capacity_factor"]
    assert out["by_span"] == {} and out["device_ops_s"] == 0
    assert set(out["counters"]) == {"moe.pairs_routed", "moe.slots",
                                    "moe.pairs_dropped"}
    (gap, _), = out["idle_by_span"].items()
    assert gap in PARENT or gap == spans.OUTSIDE
    assert out["setup"] == [] and out["forwards"] == 2
    assert not obs.active() and len(obs.tracer()) == 0


@pytest.mark.parametrize("traced", [False, True])
def test_benchmark_runs_leave_obs_off(tiny, traced):
    """The benchmark's own runs, traced or not, never turn `obs` on: the
    program records no span and counts nothing in them."""
    import time

    from repro_torch import obs
    cell = spec.resolve("olmoe-tiny.tiny", tiny)
    seen = []
    real = obs.span

    def span(name, /, **args):
        seen.append(obs.active())
        return real(name, **args)
    obs.span = span
    try:
        out = harness.run(cell, seed=2**31 + 17, seconds=0.5, traced=traced,
                          device=torch.device("cpu"),
                          t_start=time.perf_counter())
    finally:
        obs.span = real
    assert out["correct"] and seen and not any(seen)
    assert len(obs.tracer()) == 0
    assert obs.metrics().export()["counters"] == {}


# ------------------------------------------------------------------ card

# `measure` of a test-width cell on the card in a fresh process, as
# `bench/by_span.py` runs it
_ON_CARD = """
import json, sys
from pathlib import Path
sys.path[:0] = sys.argv[1:3]
import torch
from bench import spans, spec
cell = spec.resolve(sys.argv[3], Path(sys.argv[1]))
print(json.dumps(spans.measure(cell, 2**31 + 7, torch.device("cuda", 0))))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("config", list(TINY))
def test_spans_on_the_card(card, tiny, config):
    """On the card, under 1 % of the stretch's device time is launched
    outside `prefill`, the by-span seconds are the stretch's device
    operations whole (within 0.1 %), and every reading reads."""
    p = subprocess.run([sys.executable, "-c", _ON_CARD, str(tiny),
                        str(ROOT / "src"), f"{config}.tiny"],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    by = out["by_span"]
    total = sum(v["self_s"] for v in by.values())
    assert total == pytest.approx(out["device_ops_s"], rel=1e-3)
    assert by.get(spans.UNATTRIBUTED, {"total_s": 0})["total_s"] \
        < 0.01 * out["busy_s"]
    assert set(out["readings"]) == {"moe_dispatch_span_ms",
                                    "moe_experts_ms", "attention_core_ms",
                                    "moe_slot_fill_pct"}
    assert out["idle_by_span"] and out["ops_by_span"]["moe.experts"]


# the tiny prefill on the card with `obs` off, then on under a profiler
# session with its metrics counting: the logits bit for bit
_SAME_ON_CARD = """
import sys
from pathlib import Path
sys.path[:0] = sys.argv[1:3]
import torch
from torch.profiler import ProfilerActivity, profile
from bench import harness, spec
from repro_torch import obs
dev = torch.device("cuda", 0)
cell = spec.resolve(sys.argv[3], Path(sys.argv[1]))
model, step = harness.build_step(cell)
inputs = harness.make_inputs(cell, model, 2**31 + 9, dev)
batch = {"tokens": inputs.warmup[0]}
plain = step(inputs.params, batch)
obs.enable(trace=True, metrics=True, journal=False)
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
    traced = step(inputs.params, batch)
print(bool(torch.equal(plain, traced)),
      obs.metrics().export()["counters"]["moe.pairs_routed"] > 0)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("config", list(TINY))
def test_logits_bit_identical_with_obs_on_the_card(card, tiny, config):
    p = subprocess.run([sys.executable, "-c", _SAME_ON_CARD, str(tiny),
                        str(ROOT / "src"), f"{config}.tiny"],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split()[-2:] == ["True", "True"], p.stdout[-500:]
