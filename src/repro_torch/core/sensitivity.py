"""Application sensitivity analysis (paper §5.3, Fig. 11).

Builds Faster R-CNN in four steps and, at each step, runs the DSE and
summarizes the top-10 % configurations as a "radar chart" — the per-variable
mean of the normalized design values.  The analysis exposes which DNN
characteristics pull which design variables:

  step 1 -> 2 (smaller feature maps)  : loop-tiling variables shrink
  step 2 -> 3 (+ depthwise separable) : configuration essentially unchanged
  step 3 -> 4 (+ large matmul layers) : PE groups and tiling variables grow

Each DSE runs through the port's `Study` on `device`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.costmodel import AccelConfig
from repro_torch.core.graph import ComputationGraph
from repro_torch.core.multiapp import AppSpec
from repro_torch.core.search import EngineSpec
from repro_torch.core.space import DesignSpace

__all__ = ["RadarSummary", "radar_of_top_configs", "sensitivity_study"]


@dataclasses.dataclass
class RadarSummary:
    """Mean normalized value per design variable over the top-10 % configs
    (the quantity plotted on the paper's radar charts, Figs. 6/10/11)."""

    app: str
    values: Dict[str, float]          # variable -> mean in [0, 1]
    n_configs: int
    extras: Dict[str, float] = dataclasses.field(default_factory=dict)

    def fmt(self) -> str:
        body = "  ".join(f"{k}={v:.2f}" for k, v in self.values.items())
        return f"[{self.app} | {self.n_configs} cfgs] {body}"


def _normalize(cfg: AccelConfig, space: DesignSpace) -> Dict[str, float]:
    out = {}
    for var, domain in space.domains.items():
        v = getattr(cfg, var)
        lo, hi = min(domain), max(domain)
        out[var] = 0.0 if hi == lo else (v - lo) / (hi - lo)
    return out


def radar_of_top_configs(name: str, spec: AppSpec, space: DesignSpace,
                         k: int = 3, restarts: int = 4, seed: int = 0,
                         top_frac: float = 0.10,
                         max_rounds: int = 40,
                         engine: EngineSpec = "greedy",
                         device="cuda") -> RadarSummary:
    """Single-app `MaxPerf` DSE through the declarative
    `repro_torch.dse.Study` front door on `device`, summarized as the
    paper's radar-chart means."""
    from repro_torch.dse import MaxPerf, SearchBudget, Study

    study = Study(apps=[spec], space=space, objective=MaxPerf(),
                  engine=engine,
                  budget=SearchBudget(k=k, restarts=restarts,
                                      max_rounds=max_rounds),
                  seed=seed, name="sensitivity", device=device)
    res = study.run().per_app_results[spec.name]
    perf = res.evaluated_perf
    valid = perf > 0
    thresh = np.quantile(perf[valid], 1.0 - top_frac) if valid.any() else 0.0
    top = [res.evaluated[i] for i in np.flatnonzero(perf >= thresh)]
    if not top:
        top = [res.best]
    acc: Dict[str, float] = {v: 0.0 for v in space.variables}
    for cfg in top:
        for var, val in _normalize(cfg, space).items():
            acc[var] += val
    values = {v: acc[v] / len(top) for v in space.variables}
    extras = {
        # geometric means of the *physical* quantities (radar means of the
        # normalized factors can't express products like total MACs)
        "log2_total_macs": float(np.mean(
            [np.log2(c.pe_group * c.mac_per_group) for c in top])),
        "log2_spatial_tile": float(np.mean(
            [np.log2(c.tix * c.tiy) for c in top])),
        "log2_tile_volume": float(np.mean(
            [np.log2(c.tix * c.tiy * c.tif * c.tof) for c in top])),
    }
    return RadarSummary(app=name, values=values, n_configs=len(top),
                        extras=extras)


def sensitivity_study(builders: Sequence, names: Sequence[str],
                      space: DesignSpace, k: int = 3, restarts: int = 3,
                      seed: int = 0,
                      max_rounds: int = 30,
                      engine: EngineSpec = "greedy",
                      device="cuda") -> List[RadarSummary]:
    """Run the radar summarization over a sequence of graph builders
    (the §5.3 four-step Faster-R-CNN build by default) on `device`."""
    out = []
    for i, (build, name) in enumerate(zip(builders, names)):
        graph: ComputationGraph = build()
        spec = AppSpec.from_graph(name, graph)
        out.append(radar_of_top_configs(name, spec, space, k=k,
                                        restarts=restarts,
                                        seed=seed + i, max_rounds=max_rounds,
                                        engine=engine, device=device))
    return out
