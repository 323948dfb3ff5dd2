"""`Study`: the declarative front door of the DSE loop.

The paper frames accelerator design as one optimization problem (§4.3)
evaluated under different objectives — per-app GOPS (Table 3), joint
geomean across applications (§5.1, Tables 4-5), perf/area trade-off
curves at several area budgets (Co-Design-style).  A `Study` is that
problem as a value::

    from repro_torch.dse import Study, SearchBudget, GeomeanAcrossApps

    study = Study(apps=["resnet", "ptb", "wdl"],
                  objective=GeomeanAcrossApps(), engine="greedy",
                  budget=SearchBudget(restarts=2, max_rounds=12), seed=0)
    result = study.run()          # -> StudyResult, scored on the GPU
    result.save("experiments/my_study.json")

Each app gets a multi-restart engine run through its own memoizing
`Evaluator` on `device`, then the objective's selection stage combines
them.  With the same arguments a `Study` selects what the JAX package's
`repro.dse.Study` selects, bit for bit.

`ParetoObjective` studies run the per-app searches under a scalarized
multi-objective signal, cross-evaluate the union of the per-app
non-dominated sets on every app, and sweep the joint (geomean-GOPS, area)
front for one selected design per area budget (Tables 4-5 style).  With
`repro_torch.obs` on, a run records the spans ``study``, ``phase.search``,
``search_app``, ``phase.synthesize`` and ``cross_eval`` (the engines and
the evaluator add theirs) and a telemetry snapshot in
``meta["telemetry"]``, which the persisted JSON leaves out.

Not ported yet (each raises `NotImplementedError`): parallel workers,
checkpoint/resume, compositions and evaluator-mode studies.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch import obs
from repro_torch.core.costmodel import (AccelConfig, ConfigBatch, area_many,
                                        resolve_device)
from repro_torch.core.multiapp import AppSpec, MultiAppResult
from repro_torch.core.search import (EngineSpec, Evaluator, SearchResult,
                                     optimize_for_app, pareto_front_indices)
from repro_torch.core.space import DesignSpace, default_space
from repro_torch.dse.constraints import (AreaBudget, Constraint, PeakBuffers,
                                         feasible_mask_all)
from repro_torch.dse.objectives import (GeomeanAcrossApps, MaxPerf,
                                        Objective, ParetoObjective, geomean,
                                        make_objective)
from repro_torch.dse.parallel import canonical_front_indices

__all__ = ["SearchBudget", "Study", "StudyResult", "FrontPoint",
           "DEFAULT_BUDGET_FACTORS"]

# Tables 4-5 style sweep: relative area budgets when the caller names none
DEFAULT_BUDGET_FACTORS = (0.75, 1.0, 1.25)


def _later(feature: str) -> NotImplementedError:
    return NotImplementedError(f"{feature} is ported in a later slice, see "
                               "ROADMAP.md")


@dataclasses.dataclass
class SearchBudget:
    """How much search each application gets."""

    k: int = 3                    # greedy variable-subset size
    restarts: int = 4             # multi-start count
    max_rounds: int = 40          # rounds per start
    engine_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @staticmethod
    def smoke() -> "SearchBudget":
        """Seconds-scale budget for smoke runs."""
        return SearchBudget(k=2, restarts=1, max_rounds=4,
                            engine_kwargs={"population": 16, "chains": 4,
                                           "batch": 16})

    @staticmethod
    def of(spec: Union["SearchBudget", Dict, None]) -> "SearchBudget":
        if spec is None:
            return SearchBudget()
        if isinstance(spec, SearchBudget):
            return spec
        return SearchBudget(**dict(spec))


@dataclasses.dataclass
class FrontPoint:
    """One non-dominated design on the joint (score up, area down) front."""

    config: Any
    score: float                  # objective value (GOPS or geomean GOPS)
    area: float
    per_app: Dict[str, float] = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict:
        return {"config": _cfg_dict(self.config), "score": self.score,
                "area": self.area, "per_app": dict(self.per_app)}


def _cfg_dict(cfg: Any) -> Optional[Dict]:
    if cfg is None:
        return None
    return {k: int(v) for k, v in cfg.asdict().items()}


def _cfg_load(d: Optional[Dict]) -> Optional[AccelConfig]:
    return None if d is None else AccelConfig(**d)


@dataclasses.dataclass
class StudyResult:
    """Outcome of `Study.run`, JSON-persistable for cross-run comparison.

    `save`/`load` round-trip the declarative summary (meta, best, per-app
    bests, front, per-budget selections, Table-4/5 numbers); the runtime
    handles (`per_app_results` SearchResults, `multiapp` MultiAppResult)
    are rebuilt only by re-running the study.
    """

    meta: Dict
    best: Any
    best_score: float
    per_app: Dict[str, Dict]
    front: Optional[List[FrontPoint]] = None
    budget_selections: Optional[Dict[str, Optional[Dict]]] = None
    multiapp_summary: Optional[Dict] = None
    # runtime-only handles (never serialized)
    multiapp: Optional[MultiAppResult] = \
        dataclasses.field(default=None, repr=False, compare=False)
    per_app_results: Dict[str, SearchResult] = \
        dataclasses.field(default_factory=dict, repr=False, compare=False)

    def to_json(self) -> Dict:
        # `meta["telemetry"]` (runtime observability snapshot, attached
        # only when `repro_torch.obs` is active) is excluded: persisted
        # results stay byte-identical whether telemetry was on or off
        return {
            "version": 1,
            "meta": {k: v for k, v in self.meta.items()
                     if k != "telemetry"},
            "best": _cfg_dict(self.best),
            "best_score": float(self.best_score),
            "per_app": self.per_app,
            "front": ([p.to_json() for p in self.front]
                      if self.front is not None else None),
            "budget_selections": self.budget_selections,
            "multiapp": self.multiapp_summary,
        }

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=2))
        return path

    @staticmethod
    def load(path) -> "StudyResult":
        rec = json.loads(Path(path).read_text())
        front = rec.get("front")
        return StudyResult(
            meta=rec["meta"],
            best=_cfg_load(rec.get("best")),
            best_score=float(rec.get("best_score", 0.0)),
            per_app=rec.get("per_app", {}),
            front=([FrontPoint(config=_cfg_load(p["config"]),
                               score=float(p["score"]),
                               area=float(p["area"]),
                               per_app=dict(p.get("per_app", {})))
                    for p in front] if front is not None else None),
            budget_selections=rec.get("budget_selections"),
            multiapp_summary=rec.get("multiapp"),
        )


class Study:
    """Declarative DSE problem: apps x space x objective x constraints x
    engine x budget, with one `.run()`.

    `apps` is a list of `AppSpec`s or `build_app` names; `device` is where
    every evaluator scores (``"cuda"`` by default, which raises when no GPU
    is available; tests pass ``"cpu"``) and `backend` how (``"fused"`` or
    ``"broadcast"``, see `Evaluator`)."""

    def __init__(self, apps: Sequence = (),
                 space: Optional[DesignSpace] = None,
                 objective: Union[Objective, str, None] = None,
                 constraints: Optional[Sequence[Constraint]] = None,
                 engine: EngineSpec = "greedy",
                 budget: Union[SearchBudget, Dict, None] = None,
                 seed: int = 0, *,
                 top_frac: float = 0.10,
                 max_candidates_per_app: int = 200,
                 area_budgets: Optional[Sequence[float]] = None,
                 weight_peak_mode: str = "streaming",
                 name: str = "study",
                 device="cuda",
                 backend: str = "fused",
                 workers: int = 1,
                 composition: int = 1,
                 evaluator: Any = None):
        if int(workers) != 1:
            raise _later("a Study with workers > 1")
        if int(composition) != 1:
            raise _later("a composition Study")
        if evaluator is not None:
            raise _later("an evaluator-mode Study")
        self.device = resolve_device(device)
        self.backend = backend
        self.name = name
        self.engine = engine
        self.budget = SearchBudget.of(budget)
        self.seed = seed
        self.top_frac = top_frac
        self.max_candidates_per_app = max_candidates_per_app
        self.weight_peak_mode = weight_peak_mode
        self.specs: List[AppSpec] = [
            a if isinstance(a, AppSpec)
            else AppSpec.from_app(a, weight_peak_mode=weight_peak_mode)
            for a in apps]
        if not self.specs:
            raise ValueError("a Study needs apps=...")
        self.space = space if space is not None else default_space()
        if objective is None:
            objective = (GeomeanAcrossApps() if len(self.specs) > 1
                         else MaxPerf())
        self.objective = make_objective(objective)

        # split declared constraints into the evaluator-native pieces
        # (area budget, per-app peak floors) and injected extras
        self.constraints: Tuple[Constraint, ...] = tuple(constraints or ())
        self._area_budget = float(self.space.area_budget)
        self._peak_override: Optional[PeakBuffers] = None
        self._extra: List[Constraint] = []
        for c in self.constraints:
            if isinstance(c, AreaBudget):
                self._area_budget = float(c.budget)
            elif isinstance(c, PeakBuffers):
                self._peak_override = c
            else:
                self._extra.append(c)

        # Pareto sweep budgets (Tables 4-5 style); the search itself runs
        # at the loosest budget so the front spans every requested point
        self.area_budgets: Optional[Tuple[float, ...]] = None
        if isinstance(self.objective, ParetoObjective):
            # the joint synthesis stage cross-evaluates candidates into a
            # (geomean-GOPS, area) front; terms outside perf/area have no
            # cross-app reading there, so reject them up front instead of
            # silently dropping them from the persisted result
            labels = {t.key for t in self.objective.terms}
            if not labels <= {"perf", "area"}:
                raise ValueError(
                    f"application-mode Pareto studies support only "
                    f"'perf'/'-area' terms (got {sorted(labels)}); "
                    f"custom terms need a cost model that produces "
                    f"those metrics columns")
            budgets = tuple(sorted(float(b) for b in (
                area_budgets
                or [f * self._area_budget for f in DEFAULT_BUDGET_FACTORS])))
            self.area_budgets = budgets
            self._search_area_budget = max(max(budgets), self._area_budget)
        else:
            if area_budgets is not None:
                raise ValueError("area_budgets= is only meaningful with a "
                                 "ParetoObjective (perf/area sweep)")
            self._search_area_budget = self._area_budget

        self._search_space = (
            self.space if self._search_area_budget == self.space.area_budget
            else dataclasses.replace(self.space,
                                     area_budget=self._search_area_budget))
        self._evaluators: List[Evaluator] = []

    # ----------------------------------------------------------- plumbing
    def _engine_objective(self) -> Optional[Objective]:
        """Objective injected into each per-app Evaluator.  `MaxPerf` and
        `GeomeanAcrossApps` leave the evaluator on its raw-GOPS contract;
        others reshape the engine-facing score.  Stateful objectives
        (`ParetoObjective` keeps running normalization bounds for its
        scalarizer) are deep-copied per evaluator so one app's GOPS scale
        never leaks into another's scalarization and repeated `run()`
        calls of the same Study are reproducible."""
        if isinstance(self.objective, (MaxPerf, GeomeanAcrossApps)):
            return None
        return copy.deepcopy(self.objective)

    def _peaks_for(self, spec: AppSpec) -> Tuple[int, int]:
        if self._peak_override is not None:
            return (self._peak_override.weight_bits,
                    self._peak_override.input_bits)
        return spec.peak_weight_bits, spec.peak_input_bits

    def _make_evaluator(self, spec: AppSpec) -> Evaluator:
        pw, pi = self._peaks_for(spec)
        return Evaluator(spec.stream, hw=self.space.hw,
                         peak_weight_bits=pw, peak_input_bits=pi,
                         area_budget=self._search_area_budget,
                         objective=self._engine_objective(),
                         constraints=tuple(self._extra),
                         domains={k: tuple(v) for k, v
                                  in self.space.domains.items()},
                         device=self.device, backend=self.backend)

    def _meta(self) -> Dict:
        eng = (self.engine if isinstance(self.engine, str)
               else getattr(self.engine, "__name__", str(self.engine)))
        return {
            "study": self.name,
            "apps": [s.name for s in self.specs],
            "engine": eng,
            "objective": self.objective.describe(),
            "constraints": [c.describe() for c in self.constraints],
            "area_budget": self._area_budget,
            "area_budgets": (list(self.area_budgets)
                             if self.area_budgets else None),
            "budget": dataclasses.asdict(self.budget),
            "seed": self.seed,
            "backend": self.backend,
            "device": str(self.device),
            "weight_peak_mode": self.weight_peak_mode,
        }

    # ---------------------------------------------------------------- run
    def run(self, checkpoint_path=None) -> StudyResult:
        """Search every app (serially, in app order), then run the
        objective's selection stage."""
        if checkpoint_path is not None:
            raise _later("checkpoint/resume")
        self._run_stats: Dict[str, Dict[str, int]] = {}
        t0 = time.perf_counter()
        with obs.span("study", study=self.name, apps=len(self.specs)):
            with obs.span("phase.search", apps=len(self.specs),
                          jobs=len(self.specs)):
                self._evaluators = [self._make_evaluator(s)
                                    for s in self.specs]
                per_app_results = {spec.name: self._search_app(i)
                                   for i, spec in enumerate(self.specs)}
            with obs.span("phase.synthesize"):
                result = self._synthesize(per_app_results)
        self._attach_telemetry(result, time.perf_counter() - t0)
        return result

    def _search_app(self, i: int) -> SearchResult:
        """One app's multi-restart search; its journal records carry the
        app's name."""
        spec, ev = self.specs[i], self._evaluators[i]
        # the JAX package's canonical per-app seed schedule
        seed = self.seed + 7919 * i
        prev_ctx = obs.get_context()
        obs.set_context(app=spec.name)
        try:
            with obs.span("search_app", app=spec.name,
                          engine=str(self.engine), seed=seed,
                          restarts=int(self.budget.restarts)):
                res = optimize_for_app(
                    spec.stream, self._search_space,
                    k=self.budget.k, restarts=self.budget.restarts,
                    seed=seed, max_rounds=self.budget.max_rounds,
                    engine=self.engine,
                    engine_kwargs=dict(self.budget.engine_kwargs) or None,
                    evaluator=ev)
        finally:
            obs.replace_context(prev_ctx)
        self._run_stats[spec.name] = dict(ev.stats())
        return res

    # ----------------------------------------------- telemetry snapshot
    def _attach_telemetry(self, result: StudyResult, wall: float) -> None:
        """Runtime observability snapshot into `meta["telemetry"]` (only
        when `repro_torch.obs` is active; `StudyResult.to_json` excludes
        the key, so persisted output is byte-identical either way)."""
        if not obs.active():
            return
        per_app = {a: dict(s) for a, s in self._run_stats.items()}
        total = {k: sum(int(s.get(k, 0)) for s in per_app.values())
                 for k in ("scored", "cache_hits", "cache_misses",
                           "cache_evictions", "dedup_skipped")}
        obs.counter("evaluator.scored", total["scored"])
        obs.counter("evaluator.cache_hits", total["cache_hits"])
        obs.counter("evaluator.cache_misses", total["cache_misses"])
        obs.counter("evaluator.cache_evictions", total["cache_evictions"])
        obs.counter("search.dedup_skipped", total["dedup_skipped"])
        result.meta["telemetry"] = {
            "wall_seconds": float(wall),
            "configs_scored": total["scored"],
            "configs_per_second": (total["scored"] / wall if wall > 0
                                   else 0.0),
            "cache_hits": total["cache_hits"],
            "cache_misses": total["cache_misses"],
            "cache_evictions": total["cache_evictions"],
            "dedup_skipped": total["dedup_skipped"],
            "per_app": per_app,
            # serial: one in-process worker, never retried or degraded
            "executor": {"workers": 1, "retry_rounds": 0,
                         "degraded": False},
            "metrics": (obs.metrics().summary()
                        if obs.metrics().enabled else None),
            "journal_records": len(obs.journal()),
            "trace_events": len(obs.tracer()),
        }

    # ----------------------------------------------------- synthesis stage
    def _synthesize(self, per_app_results: Dict[str, SearchResult]
                    ) -> StudyResult:
        vector = isinstance(self.objective, ParetoObjective)
        per_app = {}
        for name, res in per_app_results.items():
            rec = {"best": _cfg_dict(res.best),
                   "best_perf": float(res.best_perf),
                   "n_evaluated": len(res.evaluated),
                   "rounds": int(res.rounds)}
            if vector:
                # engines maximized the scalarized signal; keep best_perf
                # in GOPS so the field is commensurable across objectives
                # (a cache hit: the incumbent was scored during search)
                rec["best_scalarized"] = rec["best_perf"]
                rec["best_perf"] = (
                    float(res.evaluator.score_with_area([res.best])[0][0])
                    if res.best is not None else 0.0)
            per_app[name] = rec

        if vector:
            return self._synthesize_pareto(per_app_results, per_app)
        if self.objective.cross_app:
            return self._synthesize_geomean(per_app_results, per_app)
        # per-app objective (MaxPerf / PerfPerArea / user scalar): the
        # study-level best is the best per-app incumbent
        best_app = max(per_app_results,
                       key=lambda a: per_app_results[a].best_perf)
        res = per_app_results[best_app]
        return StudyResult(meta=self._meta(), best=res.best,
                           best_score=float(res.best_perf),
                           per_app=per_app,
                           per_app_results=per_app_results)

    # --------------------------------------------- §5.1 geomean selection
    def _candidates_of(self, res: SearchResult) -> List[Any]:
        """Top-`top_frac` candidate selection: quantile threshold over the
        valid scores, descending order, content dedupe, capped."""
        perf = res.evaluated_perf
        valid = perf > 0
        if valid.any():
            thresh = np.quantile(perf[valid], 1.0 - self.top_frac)
            idx = np.flatnonzero(perf >= thresh)
        else:
            idx = np.asarray([int(np.argmax(perf))])
        order = idx[np.argsort(-perf[idx])]
        seen = set()
        cands: List[Any] = []
        for j in order:
            cfg = res.evaluated[int(j)]
            key = tuple(sorted(cfg.asdict().items()))
            if key not in seen:
                seen.add(key)
                cands.append(cfg)
            if len(cands) >= self.max_candidates_per_app:
                break
        return cands

    def _gops_matrix(self, configs: Sequence[Any]) -> np.ndarray:
        """[n_apps, n_configs] raw GOPS (Eq. 9-13 zeroing under each app's
        peak floors, no area budget), through each app's evaluator."""
        batch = ConfigBatch.from_configs(list(configs))
        return np.stack([ev.raw_metrics(batch)[0]
                         for ev in self._evaluators])

    def _cross_eval(self, cands: Sequence[Any]) -> np.ndarray:
        """[n_apps, n_cands] GOPS matrix; columns infeasible under any
        injected extra constraint are zeroed wholesale (selection-time
        metrics offer `area`)."""
        with obs.span("cross_eval", candidates=len(cands), shards=1):
            cross = self._gops_matrix(cands)
            if self._extra:
                batch = ConfigBatch.from_configs(list(cands))
                metrics = {"area": area_many(batch, self.space.hw)}
                mask = feasible_mask_all(self._extra, batch, metrics)
                cross[:, ~mask] = 0.0
        return cross

    def _synthesize_geomean(self, per_app_results, per_app) -> StudyResult:
        specs = self.specs
        apps = [s.name for s in specs]
        candidates = {s.name: self._candidates_of(per_app_results[s.name])
                      for s in specs}
        best_per_app = {a: per_app_results[a].best for a in apps}
        best_perf_per_app = {a: float(per_app_results[a].best_perf)
                             for a in apps}

        all_cands: List[Any] = []
        for a in apps:
            all_cands.extend(candidates[a])
        cross = self._cross_eval(all_cands)

        # step 4: the objective scores the cross-eval matrix (geomean over
        # everywhere-valid candidates)
        geo = self.objective.score({"perf_matrix": cross})
        valid_cols = (cross > 0).all(axis=0)
        selected = all_cands[int(np.argmax(geo))]

        # step 5: Table 4 / Table 5 under the same peak floors as the
        # search and selection stages
        columns = [best_per_app[a] for a in apps] + [selected]
        perf_matrix = self._gops_matrix(columns)
        row_best = perf_matrix.max(axis=1, keepdims=True)
        normalized = perf_matrix / np.maximum(row_best, 1e-12)
        geomeans = geomean(normalized, axis=0)
        improvements = geomeans[-1] / np.maximum(geomeans[:-1], 1e-12) - 1.0

        # Table 5b: compare against the per-app best *among everywhere-
        # valid* candidates (a per-app best that violates another app's
        # constraints has a ~0 geomean and makes the raw ratio
        # meaningless)
        improvements_valid = np.zeros(len(specs))
        if valid_cols.any():
            cross_valid = np.where(valid_cols[None, :], cross, 0.0)
            geo_valid = np.where(valid_cols, geomean(cross_valid, axis=0),
                                 0.0)
            sel_geo = float(geo_valid.max())
            for i in range(len(specs)):
                j = int(np.argmax(cross_valid[i]))
                improvements_valid[i] = sel_geo / max(geo_valid[j],
                                                      1e-12) - 1.0

        multiapp = MultiAppResult(
            apps=apps, best_per_app=best_per_app,
            best_perf_per_app=best_perf_per_app, selected=selected,
            perf_matrix=perf_matrix, normalized_matrix=normalized,
            geomeans=geomeans, improvements=improvements,
            improvements_valid=improvements_valid,
            candidates_per_app=candidates,
            greedy_results=per_app_results)
        summary = {
            "apps": apps,
            "selected": _cfg_dict(selected),
            "geomeans": geomeans.tolist(),
            "normalized_matrix": normalized.tolist(),
            "improvements": improvements.tolist(),
            "improvements_valid": improvements_valid.tolist(),
        }
        return StudyResult(meta=self._meta(), best=selected,
                           best_score=float(geo.max()), per_app=per_app,
                           multiapp_summary=summary, multiapp=multiapp,
                           per_app_results=per_app_results)

    # ------------------------------------- Pareto front + budget sweep
    def _synthesize_pareto(self, per_app_results, per_app) -> StudyResult:
        apps = [s.name for s in self.specs]
        # candidate pool: each app's local non-dominated set (recomputed
        # from the shared evaluator's cached raw metrics) plus its
        # incumbent, deduped across apps in app order
        seen = set()
        cands: List[Any] = []

        def _add(cfg: Any) -> None:
            key = tuple(sorted(cfg.asdict().items()))
            if key not in seen:
                seen.add(key)
                cands.append(cfg)

        for name, res in per_app_results.items():
            if res.best is not None:
                _add(res.best)
            if not res.evaluated:
                continue
            perf, area = res.evaluator.score_with_area(res.evaluated)
            local = pareto_front_indices(perf, area)
            for j in local[:self.max_candidates_per_app]:
                _add(res.evaluated[j])

        cross = self._cross_eval(cands)
        areas = area_many(ConfigBatch.from_configs(cands), self.space.hw)
        valid = (cross > 0).all(axis=0)
        score = np.where(valid, geomean(cross, axis=0), 0.0)

        # canonical (content-tie-broken) sweep: the joint front is invariant
        # to candidate arrival order
        keys = [tuple(sorted(c.asdict().items())) for c in cands]
        front_idx = canonical_front_indices(score, areas, keys)
        front = [FrontPoint(config=cands[i], score=float(score[i]),
                            area=float(areas[i]),
                            per_app={a: float(cross[k, i])
                                     for k, a in enumerate(apps)})
                 for i in front_idx]

        selections: Dict[str, Optional[Dict]] = {}
        best_pt: Optional[FrontPoint] = None
        for b in self.area_budgets:
            eligible = [p for p in front if p.area <= b and p.score > 0]
            if not eligible:
                selections[f"{b:g}"] = None
                continue
            pick = max(eligible, key=lambda p: p.score)
            selections[f"{b:g}"] = pick.to_json()
            if b <= self._area_budget and (best_pt is None
                                           or pick.score > best_pt.score):
                best_pt = pick
        if best_pt is None and front:
            best_pt = max(front, key=lambda p: p.score)

        return StudyResult(
            meta=self._meta(),
            best=best_pt.config if best_pt else None,
            best_score=float(best_pt.score) if best_pt else 0.0,
            per_app=per_app, front=front, budget_selections=selections,
            per_app_results=per_app_results)
