"""Per-op cost attribution: the paper's Table-1 lens as a first-class API.

The analytical model is pitched as *explainable* — for every op you can
say which resource (MAC array, weight-buffer bandwidth, activation-buffer
bandwidth) bounds its latency.  `explain_config` turns one
`(config, stream)` pair into exactly that breakdown, built on the port's
`evaluate_stream` (one config: the Eqs. (1)-(13) broadcast pass on the
evaluator's device), whose numbers agree bit for bit with what the
Evaluator scored.

`Evaluator.explain(config)` is the ergonomic entry point::

    ev = Evaluator.for_space(stream, space, ...)
    exp = ev.explain(cfg)
    print(exp.table())          # Table-1-style per-op breakdown

Roofline position per op: arithmetic intensity = 2*MACs / bytes moved
(weights once + activations per batch element at `hw.bit_width`), and
the op is "compute-bound" when its compute cycles dominate both memory
terms, "memory-bound" otherwise — the Sze et al. (arXiv 1703.09039)
reading of the max(compute, weight, input) latency model.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.costmodel import (AccelConfig, HardwareConstants,
                                        OpStream, evaluate_stream)

__all__ = ["OpCost", "CostExplanation", "explain_config",
           "EngineAttribution", "CompositionExplanation",
           "explain_composition"]


@dataclasses.dataclass
class OpCost:
    """One op's row of the Table-1 breakdown."""

    index: int
    name: str
    kind: str
    macs: int                     # total MACs incl. batch and repeat
    compute_cycles: float
    weight_cycles: float
    input_cycles: float
    total_cycles: float           # max(compute, weight, input)
    latency_share: float          # total_cycles / stream total
    bottleneck: str               # "compute" | "weight" | "input"
    arithmetic_intensity: float   # ops per byte moved
    roofline: str                 # "compute-bound" | "memory-bound"
    valid: bool                   # Eq. 9-13 satisfied for this op

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CostExplanation:
    """Full per-op attribution for one config on one op stream."""

    config: Dict[str, int]
    total_cycles: float
    gops: float                   # at hw.frequency_hz, 1 MAC = 2 ops
    area: float
    area_budget: float
    valid: bool                   # every op satisfies Eq. 9-13
    feasible: bool                # valid AND within the area budget
    ops: List[OpCost]

    @property
    def bottleneck_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for op in self.ops:
            out[op.bottleneck] = out.get(op.bottleneck, 0) + 1
        return out

    def to_json(self) -> Dict[str, Any]:
        return {
            "config": dict(self.config),
            "total_cycles": self.total_cycles,
            "gops": self.gops,
            "area": self.area,
            "area_budget": self.area_budget,
            "valid": self.valid,
            "feasible": self.feasible,
            "bottleneck_counts": self.bottleneck_counts,
            "ops": [op.to_json() for op in self.ops],
        }

    def table(self, max_rows: Optional[int] = None) -> str:
        """Table-1-style text rendering, ops in stream order (pass
        `max_rows` to keep only the largest latency shares)."""
        rows = self.ops
        if max_rows is not None and len(rows) > max_rows:
            keep = sorted(rows, key=lambda o: -o.latency_share)[:max_rows]
            keep_idx = {o.index for o in keep}
            rows = [o for o in self.ops if o.index in keep_idx]
        head = (f"{'op':24s} {'kind':14s} {'cycles':>12s} {'share':>7s} "
                f"{'bottleneck':>10s} {'ops/byte':>9s} {'roofline':>13s}")
        lines = [head, "-" * len(head)]
        for o in rows:
            lines.append(
                f"{o.name[:24]:24s} {o.kind:14s} {o.total_cycles:12.0f} "
                f"{o.latency_share:6.1%} {o.bottleneck:>10s} "
                f"{o.arithmetic_intensity:9.2f} {o.roofline:>13s}"
                + ("" if o.valid else "  [invalid]"))
        lines.append("-" * len(head))
        lines.append(
            f"{'total':24s} {'':14s} {self.total_cycles:12.0f} "
            f"{1.0:6.1%}  ->  {self.gops:.1f} GOPS, area {self.area:.0f}"
            f"{'' if self.feasible else '  [infeasible]'}")
        return "\n".join(lines)


def explain_config(config: AccelConfig, stream: OpStream,
                   hw: Optional[HardwareConstants] = None,
                   peak_weight_bits: int = 0, peak_input_bits: int = 0,
                   area_budget: float = 0.0,
                   device="cuda") -> CostExplanation:
    """Per-op Table-1 attribution of `config` on `stream`, its cycles
    computed on `device`."""
    hw = hw or HardwareConstants()
    bd = evaluate_stream(config, stream, hw, peak_weight_bits,
                         peak_input_bits, device=device)
    shares = bd.latency_shares()
    labels = bd.bottlenecks()
    ops: List[OpCost] = []
    for j, op in enumerate(stream.ops):
        macs = int(op.macs * op.batch)
        # bytes moved: weights once, input/output activations per batch
        # element, all at the quantized datapath width
        bytes_moved = ((op.weight_elems
                        + (op.input_elems + op.output_elems) * op.batch)
                       * hw.bit_width / 8.0)
        compute = float(bd.compute_cycles[j])
        memory = max(float(bd.weight_cycles[j]), float(bd.input_cycles[j]))
        ops.append(OpCost(
            index=j,
            name=op.name or f"{op.kind.value}#{j}",
            kind=op.kind.value,
            macs=macs,
            compute_cycles=compute,
            weight_cycles=float(bd.weight_cycles[j]),
            input_cycles=float(bd.input_cycles[j]),
            total_cycles=float(bd.total_cycles[j]),
            latency_share=float(shares[j]),
            bottleneck=labels[j],
            arithmetic_intensity=(2.0 * macs / bytes_moved
                                  if bytes_moved > 0 else 0.0),
            roofline=("compute-bound" if compute >= memory
                      else "memory-bound"),
            valid=bool(bd.valid[j]),
        ))
    total = float(bd.stream_cycles)
    seconds = total / hw.frequency_hz
    gops = (stream.total_ops / max(seconds, 1e-30) / 1e9) if total > 0 \
        else 0.0
    area = float(config.area(hw))
    valid = bool(bd.stream_valid)
    feasible = valid and (area_budget <= 0 or area <= area_budget)
    cfg = ({k: int(v) for k, v in config.asdict().items()}
           if hasattr(config, "asdict") else dict(config))
    return CostExplanation(config=cfg, total_cycles=total, gops=gops,
                           area=area, area_budget=float(area_budget),
                           valid=valid, feasible=feasible, ops=ops)


# --------------------------------------------------------------------------
# Composition attribution (heterogeneous multi-accelerator designs)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class EngineAttribution:
    """One sub-accelerator's row of a composition breakdown."""

    index: int
    config: Dict[str, int]
    area: float
    area_share: float             # this engine's fraction of the total area
    budget_share: float           # the split share the CDAC stage budgeted
    apps: List[Dict[str, Any]]    # per served app: weight, fraction, gops,
                                  # effective_gops

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CompositionExplanation:
    """Per-engine attribution of one `Composition` under a traffic mix."""

    score: float                  # traffic-weighted geomean effective GOPS
    total_area: float
    area_budget: float
    feasible: bool                # every routed app valid AND within budget
    traffic: Dict[str, float]
    engines: List[EngineAttribution]

    def to_json(self) -> Dict[str, Any]:
        return {
            "score": self.score,
            "total_area": self.total_area,
            "area_budget": self.area_budget,
            "feasible": self.feasible,
            "traffic": dict(self.traffic),
            "engines": [e.to_json() for e in self.engines],
        }

    def table(self) -> str:
        """Text rendering: one block per engine, one row per served app."""
        head = (f"{'engine/app':30s} {'weight':>7s} {'frac':>6s} "
                f"{'gops':>10s} {'eff gops':>10s} {'area':>10s}")
        lines = [head, "-" * len(head)]
        for e in self.engines:
            lines.append(f"engine {e.index} "
                         f"(area {e.area:.0f}, {e.area_share:.0%} of total, "
                         f"budgeted {e.budget_share:.0%})")
            for a in e.apps:
                lines.append(
                    f"  {a['name'][:28]:28s} {a['weight']:7.3f} "
                    f"{a['fraction']:6.2f} {a['gops']:10.1f} "
                    f"{a['effective_gops']:10.1f} {e.area:10.0f}"
                    + ("" if a["gops"] > 0 else "  [infeasible]"))
        lines.append("-" * len(head))
        lines.append(f"{'traffic score':30s} {self.score:>42.1f} "
                     f"{self.total_area:10.0f}"
                     f"{'' if self.feasible else '  [over budget]'}")
        return "\n".join(lines)


def explain_composition(comp, specs, hw: Optional[HardwareConstants] = None,
                        traffic=None, area_budget: float = 0.0,
                        device="cuda") -> CompositionExplanation:
    """Per-engine attribution of a `Composition` on its applications, each
    engine's GOPS computed on `device`.

    `specs` are the `AppSpec`s in composition app order; `traffic` is a
    `TrafficMix` / dict / None (uniform).  Numbers agree bit-for-bit with
    `CompositionEvaluator.score_with_area` (the same raw GOPS, the same
    time-shared effective-rate formula)."""
    from repro_torch.core.costmodel import ConfigBatch, performance_gops
    from repro_torch.dse.composition import TrafficMix, composition_score

    hw = hw or HardwareConstants()
    specs = list(specs)
    by_name = {s.name: s for s in specs}
    mix = TrafficMix.of(traffic, comp.apps)
    w = mix.vector()

    gops = np.zeros(len(comp.apps))
    for i, app in enumerate(comp.apps):
        spec = by_name[app]
        batch = ConfigBatch.from_configs([comp.engine_of(app)])
        gops[i] = performance_gops(batch, spec.stream, hw,
                                   spec.peak_weight_bits,
                                   spec.peak_input_bits, device=device)[0]
    assignment = np.asarray(comp.assignment, dtype=np.int64)
    group_w = np.zeros(comp.k)
    np.add.at(group_w, assignment, w)
    frac = w / group_w[assignment]

    areas = [float(e.area(hw)) for e in comp.engines]
    total = float(sum(areas))
    split = comp.split or tuple(1.0 / comp.k for _ in range(comp.k))
    engines: List[EngineAttribution] = []
    for g in range(comp.k):
        served = [i for i, a in enumerate(comp.assignment) if a == g]
        engines.append(EngineAttribution(
            index=g,
            config={k: int(v) for k, v in comp.engines[g].asdict().items()},
            area=areas[g],
            area_share=(areas[g] / total if total > 0 else 0.0),
            budget_share=float(split[g]),
            apps=[{"name": comp.apps[i],
                   "weight": float(w[i]),
                   "fraction": float(frac[i]),
                   "gops": float(gops[i]),
                   "effective_gops": float(frac[i] * gops[i])}
                  for i in served]))
    score = composition_score(w, comp.assignment, gops)
    feasible = bool(score > 0 and (area_budget <= 0 or total <= area_budget))
    if area_budget > 0 and total > area_budget:
        score = 0.0
    return CompositionExplanation(score=float(score), total_area=total,
                                  area_budget=float(area_budget),
                                  feasible=feasible,
                                  traffic=mix.to_json(), engines=engines)
