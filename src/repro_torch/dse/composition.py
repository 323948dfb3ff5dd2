"""Heterogeneous multi-accelerator composition: K engines, one budget.

The paper (and a monolithic Study) optimizes ONE monolithic
`AccelConfig` per problem.  Production chips serving mixed traffic —
prefill + decode, CNN + LM — want a *composition*: K differently-shaped
sub-accelerators sharing one area budget, each workload routed to the
engine that fits it (the CHARM CDSE->CDAC two-level flow, SNIPPETS.md
#1-2).  This module holds the composition-side value types and scorer;
`repro_torch.core.search.partition` holds the assignment/split combinatorics
and `Study(composition=K)` wires the joint search end to end.

Scoring model — time-shared effective rates
===========================================

Traffic is a normalized weight `w_a` per application.  Engine `g` serves
its assigned group time-shared in proportion to traffic, so app `a` on
engine `g` sees the effective service rate::

    f_a = w_a / sum(w_b for b in group(g))        # engine-time fraction
    rate_a = f_a * gops_g(a)                      # effective GOPS

and a composition scores the traffic-weighted geometric mean of the
effective rates (engines run concurrently; groups multiply)::

    score = prod(rate_a ** w_a)      # 0 if any assigned app is infeasible

A monolithic design is exactly the K=1 composition: every app
time-shares one engine, paying the `prod(f_a ** w_a)` sharing factor a
multi-engine composition avoids — which is what makes "a 2-engine
prefill+decode composition dominates the best monolithic config at
equal area" a meaningful, physically-grounded comparison rather than a
scoring artifact.

`CompositionEvaluator` wraps one memoizing port `Evaluator` shard per
application (the same scorer on the same `device` and `backend` as every
search: `FusedTorchScorer` and `gather_rows` on the GPU by default), so
repeated engine configs — across compositions, across the CDAC
enumeration, across reruns — are never re-scored, and shard caches warmed
by the per-tier CDSE searches merge straight in (`warm_from`).
Everything is bit-deterministic: scoring is a pure function of (configs,
streams, traffic), the same bits on the GPU as on the CPU, so
compositions flow through `Study(workers=N)`, checkpoints, and telemetry
inertness unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.costmodel import (AccelConfig, ConfigBatch,
                                        HardwareConstants, area_many,
                                        performance_gops)
from repro_torch.core.multiapp import AppSpec
from repro_torch.core.search import Evaluator, config_key
from repro_torch.core.search.partition import Partition, group_members

__all__ = ["TrafficMix", "Composition", "CompositionEvaluator",
           "composition_score", "cross_gops", "total_area"]

_LOG_FLOOR = 1e-12


@dataclasses.dataclass(frozen=True)
class TrafficMix:
    """Normalized per-application traffic weights, app order fixed.

    ``TrafficMix.of(None, apps)`` is the uniform mix; a dict form
    (``{"qwen2-0.5b:prefill": 3, "qwen2-0.5b:decode": 1}``) normalizes to
    sum 1 and must name every app exactly (unknown or missing names are
    errors, not silent drops)."""

    apps: Tuple[str, ...]
    weights: Tuple[float, ...]

    def __post_init__(self):
        if len(self.apps) != len(self.weights):
            raise ValueError("one weight per app")
        if not self.apps:
            raise ValueError("empty traffic mix")
        if any(w <= 0 for w in self.weights):
            raise ValueError(f"traffic weights must be positive, got "
                             f"{self.weights}")
        if abs(sum(self.weights) - 1.0) > 1e-9:
            raise ValueError(f"traffic weights must sum to 1, got "
                             f"{self.weights}")

    @staticmethod
    def of(spec: Optional[Mapping[str, float]],
           apps: Sequence[str]) -> "TrafficMix":
        apps = tuple(apps)
        if spec is None:
            w = 1.0 / len(apps)
            # exact normalization: repair the float drift on the last app
            weights = [w] * len(apps)
        else:
            if isinstance(spec, TrafficMix):
                spec = dict(zip(spec.apps, spec.weights))
            unknown = set(spec) - set(apps)
            if unknown:
                raise ValueError(f"traffic names unknown app(s) "
                                 f"{sorted(unknown)}; study apps: "
                                 f"{list(apps)}")
            missing = set(apps) - set(spec)
            if missing:
                raise ValueError(f"traffic is missing app(s) "
                                 f"{sorted(missing)}")
            raw = [float(spec[a]) for a in apps]
            if any(w <= 0 for w in raw):
                raise ValueError(f"traffic weights must be positive: {spec}")
            total = sum(raw)
            weights = [w / total for w in raw]
        weights[-1] = 1.0 - sum(weights[:-1])
        return TrafficMix(apps=apps, weights=tuple(weights))

    def vector(self) -> np.ndarray:
        return np.asarray(self.weights, dtype=np.float64)

    def weight(self, app: str) -> float:
        return self.weights[self.apps.index(app)]

    def to_json(self) -> Dict[str, float]:
        return {a: float(w) for a, w in zip(self.apps, self.weights)}


@dataclasses.dataclass(frozen=True)
class Composition:
    """K sub-accelerator configs plus the workload routing.

    ``engines[g]`` is engine `g`'s `AccelConfig`; ``assignment[i]`` routes
    ``apps[i]`` to one engine (canonical restricted-growth labels, every
    engine used); ``split[g]`` records the area share the CDAC stage
    budgeted engine `g` (provenance — the *actual* area is the sum of the
    engine areas).  Content identity (`key`/`asdict`) covers engines +
    assignment only: two compositions that place the same configs the
    same way are the same design regardless of which split proposed
    them."""

    engines: Tuple[AccelConfig, ...]
    assignment: Tuple[int, ...]
    apps: Tuple[str, ...]
    split: Tuple[float, ...] = ()

    def __post_init__(self):
        if len(self.apps) != len(self.assignment):
            raise ValueError("one assignment entry per app")
        k = len(self.engines)
        if sorted(set(self.assignment)) != list(range(k)):
            raise ValueError(f"assignment {self.assignment} does not use "
                             f"every one of the {k} engine(s)")
        if self.split and len(self.split) != k:
            raise ValueError("one split share per engine")

    @property
    def k(self) -> int:
        return len(self.engines)

    def engine_of(self, app: str) -> AccelConfig:
        return self.engines[self.assignment[self.apps.index(app)]]

    def groups(self) -> List[List[int]]:
        return group_members(self.assignment, self.k)

    def area(self, hw: HardwareConstants) -> float:
        return float(sum(e.area(hw) for e in self.engines))

    # ------------------------------------------------- content identity
    def asdict(self) -> Dict[str, Any]:
        """Flat, sortable content view (drives `config_key` and the
        canonical tie-breaks): engines + assignment, not split."""
        out: Dict[str, Any] = {
            "~kind": "composition",
            "~assignment": ",".join(str(int(g)) for g in self.assignment),
            "~apps": ",".join(self.apps),
        }
        for g, cfg in enumerate(self.engines):
            for f, v in cfg.asdict().items():
                out[f"engine{g}.{f}"] = int(v)
        return out

    def key(self) -> Tuple:
        return config_key(self)

    # ----------------------------------------------------------- persist
    def to_json(self) -> Dict[str, Any]:
        return {
            "kind": "composition",
            "apps": list(self.apps),
            "assignment": [int(g) for g in self.assignment],
            "split": [float(s) for s in self.split],
            "engines": [{k: int(v) for k, v in e.asdict().items()}
                        for e in self.engines],
        }

    @staticmethod
    def from_json(rec: Mapping[str, Any]) -> "Composition":
        return Composition(
            engines=tuple(AccelConfig(**e) for e in rec["engines"]),
            assignment=tuple(int(g) for g in rec["assignment"]),
            apps=tuple(rec["apps"]),
            split=tuple(float(s) for s in rec.get("split", ())))

    def partition(self) -> Partition:
        split = self.split or tuple(1.0 / self.k for _ in range(self.k))
        return Partition(assignment=self.assignment, split=split)


def composition_score(weights: np.ndarray, assignment: Sequence[int],
                      gops: np.ndarray) -> float:
    """Traffic score of one routing given each app's raw GOPS on its
    assigned engine: ``prod((f_a * gops_a) ** w_a)`` with `f_a` the app's
    engine-time fraction, 0.0 when any app is infeasible (gops <= 0)."""
    weights = np.asarray(weights, dtype=np.float64)
    gops = np.asarray(gops, dtype=np.float64)
    if (gops <= 0).any():
        return 0.0
    assignment = np.asarray(assignment, dtype=np.int64)
    group_w = np.zeros(int(assignment.max()) + 1)
    np.add.at(group_w, assignment, weights)
    frac = weights / group_w[assignment]
    return float(np.exp(np.sum(
        weights * np.log(np.maximum(frac * gops, _LOG_FLOOR)))))


class CompositionEvaluator:
    """Traffic-weighted scorer for `Composition`s over K evaluator shards.

    One memoizing `Evaluator` per application (raw metrics only — no
    area-budget masking inside the shard, so one cache serves every
    split); the composition-level feasibility (total area <= budget,
    injected extra constraints per engine config) is applied here.
    Deterministic: same compositions, same scores, regardless of call
    batching, shard cache warmth or `device`.  The shards score on
    `device` through `backend` (see `Evaluator`)."""

    def __init__(self, specs: Sequence[AppSpec],
                 hw: Optional[HardwareConstants] = None,
                 traffic: Optional[Mapping[str, float]] = None,
                 area_budget: float = 0.0,
                 constraints: Sequence[Any] = (),
                 domains: Optional[Dict[str, Sequence[int]]] = None,
                 device="cuda", backend: str = "fused"):
        self.specs = list(specs)
        if not self.specs:
            raise ValueError("CompositionEvaluator needs at least one app")
        self.hw = hw or HardwareConstants()
        self.app_names = tuple(s.name for s in self.specs)
        self.traffic = TrafficMix.of(traffic, self.app_names)
        self.area_budget = float(area_budget)
        self.constraints = tuple(constraints)
        self.shards: Dict[str, Evaluator] = {
            s.name: Evaluator(s.stream, hw=self.hw,
                              peak_weight_bits=s.peak_weight_bits,
                              peak_input_bits=s.peak_input_bits,
                              area_budget=0.0, domains=domains,
                              device=device, backend=backend)
            for s in self.specs}
        self.device = next(iter(self.shards.values())).device

    # ------------------------------------------------------- shard plumbing
    def warm_from(self, app: str, exported: Dict) -> int:
        """Merge a search evaluator's raw-metric cache export into the
        app's shard (content-addressed: values are identical, so this is
        pure reuse, never a semantic change)."""
        return self.shards[app].cache_merge(exported)

    def app_matrix(self, configs: Sequence[AccelConfig]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(`gops[n_apps, n_cands]`, `area[n_cands]`) raw cross-evaluation
        of engine candidates on every app through the memoizing shards;
        columns violating any injected extra constraint are zeroed (the
        area budget is a composition-level property, not applied here)."""
        batch = ConfigBatch.from_configs(list(configs))
        gops = np.zeros((len(self.specs), len(batch)))
        area = np.zeros(len(batch))
        for i, spec in enumerate(self.specs):
            perf, a = self.shards[spec.name].score_with_area(batch)
            gops[i] = perf
            area = a                      # identical for every app row
        if self.constraints and len(batch):
            from repro_torch.dse.constraints import feasible_mask_all
            mask = feasible_mask_all(self.constraints, batch,
                                     {"area": area})
            gops[:, ~mask] = 0.0
        return gops, area

    # ------------------------------------------------------------- scoring
    def _engine_gops(self, comp: Composition) -> np.ndarray:
        """Raw GOPS of each app on its assigned engine (extra-constraint
        masked), aligned with `self.specs`."""
        if tuple(comp.apps) != self.app_names:
            raise ValueError(f"composition routes apps {comp.apps}, "
                             f"evaluator serves {self.app_names}")
        gops, _ = self.app_matrix(comp.engines)
        assignment = np.asarray(comp.assignment, dtype=np.int64)
        return gops[np.arange(len(self.specs)), assignment]

    def score_with_area(self, comps: Sequence[Composition]
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """(`score[N]`, `area[N]`): traffic score with the shared area
        budget applied (0.0 over budget), plus total composition area."""
        scores = np.zeros(len(comps))
        areas = np.zeros(len(comps))
        w = self.traffic.vector()
        for n, comp in enumerate(comps):
            areas[n] = comp.area(self.hw)
            if self.area_budget > 0 and areas[n] > self.area_budget:
                continue
            scores[n] = composition_score(w, comp.assignment,
                                          self._engine_gops(comp))
        return scores, areas

    def __call__(self, comps: Sequence[Composition]) -> np.ndarray:
        return self.score_with_area(comps)[0]

    def score_one(self, comp: Composition) -> float:
        return float(self([comp])[0])

    # ---------------------------------------------------------- attribution
    def per_app_rates(self, comp: Composition) -> Dict[str, float]:
        """Effective per-app service rates `f_a * gops_a` (the quantities
        the traffic score geomeans)."""
        w = self.traffic.vector()
        gops = self._engine_gops(comp)
        assignment = np.asarray(comp.assignment, dtype=np.int64)
        group_w = np.zeros(comp.k)
        np.add.at(group_w, assignment, w)
        frac = w / group_w[assignment]
        return {a: float(f * g) for a, f, g
                in zip(self.app_names, frac, gops)}

    def explain(self, comp: Composition):
        """Per-engine attribution (`repro_torch.obs.attribution.
        CompositionExplanation`) on this evaluator's device: which apps
        each engine serves, their time fractions, raw and effective GOPS,
        areas and shares — `.table()` renders the breakdown."""
        from repro_torch.obs.attribution import explain_composition
        return explain_composition(comp, self.specs, hw=self.hw,
                                   traffic=self.traffic,
                                   area_budget=self.area_budget,
                                   device=self.device)

    # ---------------------------------------------------------------- stats
    def stats(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.shards.values():
            for k, v in ev.stats().items():
                out[k] = out.get(k, 0) + int(v)
        return out


def cross_gops(specs: Sequence[AppSpec], configs: Sequence[AccelConfig],
               hw: HardwareConstants, device="cuda") -> np.ndarray:
    """Uncached [n_apps, n_cands] raw GOPS reference, the broadcast pass
    on `device` (used by tests to check `CompositionEvaluator.app_matrix`
    against the direct path)."""
    batch = ConfigBatch.from_configs(list(configs))
    out = np.zeros((len(specs), len(batch)))
    for i, s in enumerate(specs):
        out[i] = performance_gops(batch, s.stream, hw,
                                  s.peak_weight_bits, s.peak_input_bits,
                                  device=device)
    return out


def total_area(configs: Sequence[AccelConfig],
               hw: HardwareConstants) -> np.ndarray:
    return area_many(ConfigBatch.from_configs(list(configs)), hw)
