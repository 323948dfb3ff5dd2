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

Execution resources are not part of the problem: `workers=N` fans the
per-app searches over a spawn process pool (`repro_torch.dse.parallel`;
each worker scores on `device` itself), `run(checkpoint_path=...)` streams
crash-safe fragments and `Study.resume(path)` continues a killed study;
`device`, `backend` and `workers` change no byte of the `StudyResult` JSON
but ``meta["device"]`` / ``meta["backend"]``.  `composition=K` searches K
sub-accelerators under one shared area budget (the CDSE per-tier searches,
then the CDAC synthesis, `repro_torch.dse.composition`), and
`evaluator=` drives any pool scorer (a `FunctionEvaluator`) over `space`
(`autotune_search` composes this).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch import obs
from repro_torch.core.costmodel import (AccelConfig, ConfigBatch,
                                        HardwareConstants, area_many,
                                        resolve_device)
from repro_torch.core.multiapp import AppSpec, MultiAppResult
from repro_torch.core.search import (EngineSpec, Evaluator, SearchResult,
                                     config_key, optimize_for_app,
                                     pareto_front_indices)
from repro_torch.core.search.partition import (enumerate_assignments,
                                               enumerate_splits,
                                               group_members, tier_shares)
from repro_torch.core.space import DesignSpace, default_space
from repro_torch.dse.composition import (Composition, CompositionEvaluator,
                                         TrafficMix)
from repro_torch.dse.constraints import (AreaBudget, Constraint, PeakBuffers,
                                         constraint_from_describe,
                                         feasible_mask_all)
from repro_torch.dse.objectives import (GeomeanAcrossApps, MaxPerf,
                                        Objective, ParetoObjective, geomean,
                                        make_objective)
from repro_torch.dse.parallel import (EvalParams, ParallelExecutor,
                                      _cross_eval_task, _search_app_task,
                                      canonical_front_indices,
                                      merge_pareto_fronts, shard_rows)
from repro_torch.kernels import gather

__all__ = ["SearchBudget", "Study", "StudyResult", "FrontPoint",
           "DEFAULT_BUDGET_FACTORS"]

# Tables 4-5 style sweep: relative area budgets when the caller names none
DEFAULT_BUDGET_FACTORS = (0.75, 1.0, 1.25)


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
    if isinstance(cfg, Composition):
        return cfg.to_json()
    if isinstance(cfg, dict):
        return dict(cfg)
    if hasattr(cfg, "asdict"):
        return {k: int(v) for k, v in cfg.asdict().items()}
    return dict(dataclasses.asdict(cfg))


def _cfg_load(d: Optional[Dict]) -> Any:
    if d is None:
        return None
    if isinstance(d, dict) and d.get("kind") == "composition":
        return Composition.from_json(d)
    try:
        return AccelConfig(**d)
    except TypeError:             # generic (non-accelerator) config
        return dict(d)


def _combine_chunk_records(recs: Sequence[Dict]) -> Dict:
    """Reduce one app's restart-chunk worker records (ascending restart
    offset) into the record a single whole-app task would have returned.

    Mirrors `SearchResult.merge` exactly: earliest strict-max incumbent
    (which also contributes history/engine), logs concatenated in chunk
    order, rounds summed.  Shard caches are content-addressed, so the
    first writer wins without conflicts; stats counters sum."""
    best = recs[0]
    for r in recs[1:]:
        if float(r["best_perf"]) > float(best["best_perf"]):
            best = r
    batches = [r["evaluated"] for r in recs if r["evaluated"] is not None]
    values = [r["evaluated_values"] for r in recs
              if r.get("evaluated_values") is not None]
    cache: Dict = {}
    for r in recs:
        for k, v in (r.get("cache") or {}).items():
            cache.setdefault(k, v)
    stats: Dict[str, int] = {}
    for r in recs:
        for k, v in (r.get("stats") or {}).items():
            stats[k] = stats.get(k, 0) + int(v)
    return {
        "name": best["name"],
        "best": best["best"],
        "best_perf": float(best["best_perf"]),
        "history": list(best["history"]),
        "evaluated": ConfigBatch.concat(batches) if batches else None,
        "evaluated_perf": np.concatenate(
            [np.asarray(r["evaluated_perf"], dtype=np.float64)
             for r in recs]),
        "evaluated_values": (np.vstack(values) if values else None),
        "rounds": sum(int(r["rounds"]) for r in recs),
        "engine": best["engine"],
        "cache": cache,
        "stats": stats,
        "obs": None,              # chunk exports merge separately
    }


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

    Two modes:

      * **application mode** (the default): `apps` is a list of `AppSpec`s
        or `build_app` names (traced zoo workloads like
        ``"qwen2-0.5b:decode"`` included); each gets a multi-restart engine
        run through its own memoizing `Evaluator`, then the objective's
        selection stage combines them.  `device` is where every evaluator
        scores (``"cuda"`` by default, which raises when no GPU is
        available; tests pass ``"cpu"``) and `backend` how (``"fused"`` or
        ``"broadcast"``, see `Evaluator`).
      * **evaluator mode**: pass `evaluator=` (any pool-scoring callable,
        e.g. a `FunctionEvaluator` over dry-runs) and no `apps`; the engine
        drives that evaluator over `space` directly (`autotune_search`
        composes this).  The supplied evaluator owns the scoring, so
        `device` and `backend` are not used there.

    `workers`, `executor`, `device` and `backend` are execution resources:
    every result is byte-identical across them (`meta["device"]` and
    `meta["backend"]` record the last two).
    """

    def __init__(self, apps: Sequence = (),
                 space: Optional[DesignSpace] = None,
                 objective: Union[Objective, str, None] = None,
                 constraints: Optional[Sequence[Constraint]] = None,
                 engine: EngineSpec = "greedy",
                 budget: Union[SearchBudget, Dict, None] = None,
                 seed: int = 0, *,
                 evaluator: Any = None,
                 top_frac: float = 0.10,
                 max_candidates_per_app: int = 200,
                 area_budgets: Optional[Sequence[float]] = None,
                 weight_peak_mode: str = "streaming",
                 name: str = "study",
                 device="cuda",
                 backend: str = "fused",
                 workers: int = 1,
                 executor: Optional[ParallelExecutor] = None,
                 composition: int = 1,
                 traffic: Optional[Dict[str, float]] = None,
                 split_grid: int = 4):
        self.name = name
        self.engine = engine
        self.budget = SearchBudget.of(budget)
        self.seed = seed
        self.backend = backend
        self.top_frac = top_frac
        self.max_candidates_per_app = max_candidates_per_app
        self.weight_peak_mode = weight_peak_mode
        self.evaluator = evaluator
        # execution resources (never part of the problem spec: every result
        # stays byte-identical across worker counts and devices)
        self.device = resolve_device(device) if evaluator is None else None
        self.workers = max(1, int(workers))
        self.executor = executor
        #: columns below this count keep the cross-eval stage serial (the
        #: fan-out only pays for itself on big candidate sets); tests drop
        #: it to force the sharded path
        self.cross_eval_shard_min = 256
        #: `gather_rows` launches of the last run: ``parent`` (this
        #: process, in-process tasks included), ``workers`` (summed over
        #: the pool tasks' own counts) and ``tasks`` (the executor's
        #: per-task records)
        self.launch_stats: Dict[str, Any] = {}
        self._resume_state: Dict[int, SearchResult] = {}
        self._evaluators: List[Evaluator] = []
        self._user_area_budgets = (list(float(b) for b in area_budgets)
                                   if area_budgets is not None else None)
        # name sources survive to the checkpoint record so `Study.resume`
        # can rebuild the specs; None marks an AppSpec passed directly
        # (runnable, but not resumable from JSON)
        self._app_sources: List[Optional[str]] = [
            a if isinstance(a, str) else None for a in apps]

        self.specs: List[AppSpec] = [
            a if isinstance(a, AppSpec)
            else AppSpec.from_app(a, weight_peak_mode=weight_peak_mode)
            for a in apps]
        if not self.specs and evaluator is None:
            raise ValueError("a Study needs apps=... or evaluator=...")
        if evaluator is not None:
            # evaluator-mode scoring is owned by the supplied evaluator;
            # silently accepting objective/constraints here would record
            # them in meta without ever applying them
            if objective is not None:
                raise ValueError(
                    "evaluator-mode studies score through the supplied "
                    "evaluator; bake the objective into it (e.g. an "
                    "Evaluator with objective=...) instead of passing "
                    "objective= here")
            if constraints:
                raise ValueError(
                    "evaluator-mode studies cannot inject constraints; "
                    "enforce them inside the supplied evaluator")
        self.space = space if space is not None else default_space()

        # heterogeneous multi-accelerator composition (CDSE->CDAC): K > 1
        # turns the problem into "K sub-accelerator configs + a traffic
        # routing under one shared area budget"
        self.composition = max(1, int(composition))
        self.split_grid = int(split_grid)
        self.traffic: Optional[TrafficMix] = None
        if self.composition > 1:
            if evaluator is not None:
                raise ValueError("composition studies need application "
                                 "mode (apps=...), not evaluator mode")
            if self.composition > len(self.specs):
                raise ValueError(
                    f"composition={self.composition} engines need at least "
                    f"as many apps (got {len(self.specs)}); every engine "
                    f"must serve at least one workload")
            if self.split_grid < self.composition:
                raise ValueError(
                    f"split_grid={self.split_grid} is too coarse for "
                    f"{self.composition} engines")
            if objective is None:
                objective = ParetoObjective()
            self.traffic = TrafficMix.of(traffic,
                                         [s.name for s in self.specs])
        elif traffic is not None:
            raise ValueError("traffic= is only meaningful with "
                             "composition > 1")

        if objective is None:
            objective = (GeomeanAcrossApps() if len(self.specs) > 1
                         else MaxPerf())
        self.objective = make_objective(objective)
        if self.composition > 1 \
                and not isinstance(self.objective, ParetoObjective):
            raise ValueError(
                "composition studies search the joint (traffic-perf, "
                "total-area) trade-off and need a ParetoObjective "
                f"(got {self.objective!r})")

        # split declared constraints into the evaluator-native pieces
        # (area budget, per-app peak floors) and injected extras
        self.constraints: Tuple[Constraint, ...] = tuple(constraints or ())
        # generic spaces (DiscreteSpace) carry no area budget
        self._area_budget = float(getattr(self.space, "area_budget", 0.0))
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
            if self.specs:
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
            self.space
            if self._search_area_budget == getattr(self.space, "area_budget",
                                                   self._search_area_budget)
            else dataclasses.replace(self.space,
                                     area_budget=self._search_area_budget))

        # the search phase's job list.  Monolithic studies run one search
        # per app.  Composition studies run the CDSE phase: one budgeted
        # search per (app, area tier), where the tiers are every share a
        # split can award one engine — the menus the CDAC synthesis
        # composes from.
        if self.composition > 1:
            shares = tier_shares(self.composition, self.split_grid)
            self._jobs: List[Tuple[int, float]] = [
                (i, s) for i in range(len(self.specs)) for s in shares]
        else:
            self._jobs = [(i, 1.0) for i in range(len(self.specs))]

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

    def _domains(self) -> Dict[str, Tuple[int, ...]]:
        return {k: tuple(v) for k, v in self.space.domains.items()}

    def _eval_params(self, spec: AppSpec, share: float = 1.0) -> EvalParams:
        """Picklable recipe for this app's evaluator shard (each call deep-
        copies any stateful objective, so shards never share state).
        `share` scales the search-phase area budget — the composition
        CDSE tiers; 1.0 (the monolithic case) is exactly the Study's
        budget."""
        pw, pi = self._peaks_for(spec)
        return EvalParams(stream=spec.stream, hw=self.space.hw,
                          peak_weight_bits=pw, peak_input_bits=pi,
                          area_budget=float(share)
                          * self._search_area_budget,
                          objective=self._engine_objective(),
                          constraints=tuple(self._extra),
                          domains=self._domains(), device=str(self.device),
                          backend=self.backend)

    def _make_evaluator(self, spec: AppSpec,
                        share: float = 1.0) -> Evaluator:
        return self._eval_params(spec, share).build()

    # ------------------------------------------------------- job plumbing
    # A "job" is one search-phase task: (spec_index, area-tier share).
    # Monolithic studies have exactly one job per app at share 1.0, so
    # every job-indexed code path below is the app-indexed one.
    def _job_label(self, j: int) -> str:
        i, share = self._jobs[j]
        name = self.specs[i].name
        return name if self.composition <= 1 else f"{name}@{share:g}"

    def _job_space(self, share: float) -> DesignSpace:
        if share == 1.0:
            return self._search_space
        return dataclasses.replace(
            self._search_space,
            area_budget=float(share) * self._search_area_budget)

    def _job_evaluator(self, j: int) -> Evaluator:
        i, share = self._jobs[j]
        return self._make_evaluator(self.specs[i], share)

    def _executor(self) -> ParallelExecutor:
        """One executor per `run()` (cached so retry/degradation counters
        and task records accumulate across phases)."""
        if getattr(self, "_run_executor", None) is None:
            self._run_executor = (self.executor
                                  or ParallelExecutor(workers=self.workers))
        return self._run_executor

    def _meta(self) -> Dict:
        eng = (self.engine if isinstance(self.engine, str)
               else getattr(self.engine, "__name__", str(self.engine)))
        meta = {
            "study": self.name,
            "apps": [s.name for s in self.specs],
            "engine": eng,
            "objective": ({"name": "evaluator-native"}
                          if self.evaluator is not None
                          else self.objective.describe()),
            "constraints": [c.describe() for c in self.constraints],
            "area_budget": self._area_budget,
            "area_budgets": (list(self.area_budgets)
                             if self.area_budgets else None),
            "budget": dataclasses.asdict(self.budget),
            "seed": self.seed,
            "backend": self.backend,
            "device": (None if self.device is None else str(self.device)),
            "weight_peak_mode": self.weight_peak_mode,
        }
        if self.composition > 1:
            meta["composition"] = {
                "k": self.composition,
                "traffic": self.traffic.to_json(),
                "split_grid": self.split_grid,
            }
        return meta

    # ---------------------------------------------------------------- run
    def run(self, checkpoint_path=None, checkpoint_every: int = 1,
            on_checkpoint: Optional[Any] = None) -> StudyResult:
        """Execute the study.

        `checkpoint_path` streams crash-safe `StudyResult` fragments: after
        every `checkpoint_every` completed per-app searches the full
        progress record is atomically rewritten (tmp + rename), so a killed
        study resumes mid-run via `Study.resume(path)` and — because every
        per-app search is a pure function of its canonical seed and the
        synthesis stages are deterministic — produces output bit-identical
        to an uninterrupted run.  The file is removed on success.
        `on_checkpoint(n_completed)` fires after each write (progress hook;
        exceptions it raises abort the run, leaving the checkpoint on
        disk — the tests' crash simulation).

        With `workers > 1` (or an injected `executor`) the per-app searches
        fan out over a process pool; results reduce in canonical app order
        regardless of completion order, so the `StudyResult` is invariant
        to worker count."""
        if self.evaluator is not None:
            if checkpoint_path is not None:
                raise ValueError("generic (evaluator-mode) studies run as "
                                 "one indivisible search; checkpointing "
                                 "has no unit boundary to write at")
            return self._run_generic()

        self._ckpt_every = max(1, int(checkpoint_every))
        self._run_executor = None
        self._run_stats: Dict[str, Dict[str, int]] = {}
        self._evaluators = []
        tasks0 = len(self._executor().tasks)   # an injected one is reused
        launches0 = gather.gather_rows.launches
        t0 = time.perf_counter()
        with obs.span("study", study=self.name, apps=len(self.specs)):
            with obs.span("phase.search", apps=len(self.specs),
                          jobs=len(self._jobs)):
                job_results = self._run_app_searches(
                    checkpoint_path, self._ckpt_every, on_checkpoint)
            with obs.span("phase.synthesize"):
                if self.composition > 1:
                    result = self._synthesize_composition(job_results)
                else:
                    self._evaluators = [job_results[i].evaluator
                                        for i in range(len(self.specs))]
                    result = self._synthesize(
                        {self.specs[i].name: job_results[i]
                         for i in range(len(self.specs))})
        if checkpoint_path is not None:
            Path(checkpoint_path).unlink(missing_ok=True)
        tasks = self._executor().tasks[tasks0:]
        self.launch_stats = {
            "parent": int(gather.gather_rows.launches - launches0),
            "workers": sum(int(t["launches"]) for t in tasks if t["pool"]),
            "tasks": tasks}
        self._attach_telemetry(result, time.perf_counter() - t0)
        return result

    # ----------------------------------------------- per-app search phase
    def _run_app_searches(self, checkpoint_path, checkpoint_every,
                          on_checkpoint) -> Dict[int, SearchResult]:
        """Run every search-phase job; returns job-index -> SearchResult
        (monolithic studies: job index == spec index)."""
        results: Dict[int, SearchResult] = dict(self._resume_state)
        self._resume_state = {}
        todo = [j for j in range(len(self._jobs)) if j not in results]
        if todo:
            if checkpoint_path is not None:
                self._require_resumable()
            plan = self._chunk_plan(todo)
            payloads = [self._task_payload(j, offset, length)
                        for j, offset, length in plan]
            chunks_of: Dict[int, int] = {}
            for j, _, _ in plan:
                chunks_of[j] = chunks_of.get(j, 0) + 1
            pending: Dict[int, Dict[int, Dict]] = {}
            state = {"since_ckpt": 0}

            def on_result(pos: int, rec: Dict) -> None:
                j, offset, _ = plan[pos]
                chunks = pending.setdefault(j, {})
                chunks[offset] = rec
                if len(chunks) < chunks_of[j]:
                    return            # more restart chunks still in flight
                recs = [chunks[o] for o in sorted(chunks)]
                del pending[j]
                whole = recs[0] if len(recs) == 1 \
                    else _combine_chunk_records(recs)
                results[j] = self._rebuild_result(j, whole)
                self._run_stats[self._job_label(j)] = dict(
                    whole.get("stats") or {})
                if checkpoint_path is None:
                    return
                state["since_ckpt"] += 1
                if (state["since_ckpt"] >= checkpoint_every
                        or len(results) == len(self._jobs)):
                    state["since_ckpt"] = 0
                    self._write_checkpoint(checkpoint_path, results)
                    if on_checkpoint is not None:
                        on_checkpoint(len(results))

            outs = self._executor().map(_search_app_task, payloads,
                                        on_result=on_result)
            # fold worker-side obs exports in canonical payload order
            # (never completion order) so merged buffers are reproducible
            for rec in outs:
                obs.merge_worker(rec.get("obs"))
        return results

    def _chunk_plan(self, todo: List[int]) -> List[Tuple[int, int, int]]:
        """(spec_index, restart_offset, n_restarts) tasks covering `todo`.

        When the pool has more workers than apps, each app's restart loop
        splits into contiguous chunks so the spare workers help; the
        chunk payload's seed is the *canonical* seed of its first restart
        (`seed + 7919*i + 1000*offset` — exactly what `optimize_for_app`
        would hand that restart in one piece), and `SearchResult.merge`'s
        earliest-strict-max reduce is associative, so any chunking
        produces byte-identical results.  An explicit engine seed in
        `engine_kwargs` overrides the canonical schedule, so chunking is
        skipped there (every chunk would rerun the same restart)."""
        restarts = int(self.budget.restarts)
        workers = (self.executor.workers if self.executor is not None
                   else self.workers)
        if (restarts <= 1 or workers <= 1 or not todo
                or "seed" in self.budget.engine_kwargs):
            return [(j, 0, restarts) for j in todo]
        per_job = min(restarts, max(1, -(-workers // len(todo))))
        plan: List[Tuple[int, int, int]] = []
        for j in todo:
            for part in np.array_split(np.arange(restarts), per_job):
                if len(part):
                    plan.append((j, int(part[0]), int(len(part))))
        return plan

    def _task_payload(self, j: int, offset: int = 0,
                      restarts: Optional[int] = None) -> Dict:
        i, share = self._jobs[j]
        spec = self.specs[i]
        return {"name": self._job_label(j),
                "spec_index": i,
                "space": self._job_space(share),
                "engine": self.engine,
                "k": self.budget.k,
                "restarts": (int(restarts) if restarts is not None
                             else self.budget.restarts),
                "max_rounds": self.budget.max_rounds,
                "engine_kwargs": dict(self.budget.engine_kwargs) or None,
                "seed": self.seed + 7919 * j + 1000 * int(offset),
                "params": self._eval_params(spec, share),
                "obs": obs.wire_state()}

    def _rebuild_result(self, j: int, rec: Dict) -> SearchResult:
        """Portable worker record -> SearchResult with a parent-side
        evaluator warmed from the worker shard's raw-metric cache (the
        synthesis stages re-read raw metrics; merged keys are content-
        addressed, so values are identical to an in-process run)."""
        ev = self._job_evaluator(j)
        if rec.get("cache"):
            ev.cache_merge(rec["cache"])
        batch = rec.get("evaluated")
        evaluated = batch.to_configs() if batch is not None else []
        return SearchResult(
            best=rec["best"], best_perf=float(rec["best_perf"]),
            history=list(rec.get("history", [])), evaluated=evaluated,
            evaluated_perf=np.asarray(rec["evaluated_perf"],
                                      dtype=np.float64),
            rounds=int(rec["rounds"]), engine=rec.get("engine", ""),
            evaluator=ev, evaluated_values=rec.get("evaluated_values"))

    # ------------------------------------------------------- generic mode
    def _run_generic(self) -> StudyResult:
        self._run_executor = None
        self._run_stats = {}
        t0 = time.perf_counter()
        with obs.span("study", study=self.name, mode="generic"):
            res = optimize_for_app(
                None, self.space,
                k=self.budget.k, restarts=self.budget.restarts,
                seed=self.seed, max_rounds=self.budget.max_rounds,
                engine=self.engine,
                engine_kwargs=dict(self.budget.engine_kwargs) or None,
                evaluator=self.evaluator)
        stats_fn = getattr(self.evaluator, "stats", None)
        if callable(stats_fn):
            self._run_stats["space"] = dict(stats_fn())
        per_app = {"space": {"best": _cfg_dict(res.best),
                             "best_perf": float(res.best_perf),
                             "n_evaluated": len(res.evaluated),
                             "rounds": int(res.rounds)}}
        result = StudyResult(meta=self._meta(), best=res.best,
                             best_score=float(res.best_perf),
                             per_app=per_app,
                             per_app_results={"space": res})
        self._attach_telemetry(result, time.perf_counter() - t0)
        return result

    # ----------------------------------------------- telemetry snapshot
    def _attach_telemetry(self, result: StudyResult, wall: float) -> None:
        """Runtime observability snapshot into `meta["telemetry"]` (only
        when `repro_torch.obs` is active; `StudyResult.to_json` excludes
        the key, so persisted output is byte-identical either way)."""
        if not obs.active():
            return
        per_app = {a: dict(s)
                   for a, s in getattr(self, "_run_stats", {}).items()}
        total = {k: sum(int(s.get(k, 0)) for s in per_app.values())
                 for k in ("scored", "cache_hits", "cache_misses",
                           "cache_evictions", "dedup_skipped")}
        obs.counter("evaluator.scored", total["scored"])
        obs.counter("evaluator.cache_hits", total["cache_hits"])
        obs.counter("evaluator.cache_misses", total["cache_misses"])
        obs.counter("evaluator.cache_evictions", total["cache_evictions"])
        obs.counter("search.dedup_skipped", total["dedup_skipped"])
        ex = getattr(self, "_run_executor", None)
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
            "executor": ({"workers": int(ex.workers),
                          "retry_rounds": int(ex.retry_rounds),
                          "degraded": bool(ex.degraded)}
                         if ex is not None else None),
            "gather_rows_launches": {
                k: self.launch_stats.get(k) for k in ("parent", "workers")},
            "metrics": (obs.metrics().summary()
                        if obs.metrics().enabled else None),
            "journal_records": len(obs.journal()),
            "trace_events": len(obs.tracer()),
        }

    # --------------------------------------------- checkpointing / resume
    def _require_resumable(self) -> None:
        """Fail fast (before the first fragment is written) when this study
        cannot be rebuilt from JSON: checkpoints must round-trip the whole
        problem spec, not just the progress."""
        if any(s is None for s in self._app_sources):
            raise ValueError(
                "checkpointing needs name-built apps; AppSpec objects "
                "passed directly cannot be rebuilt from a JSON checkpoint")
        if not isinstance(self.engine, str):
            raise ValueError("checkpointing needs a named engine "
                             "(factories cannot be rebuilt from JSON)")
        make_objective(self.objective.describe())      # raises if custom
        for c in self.constraints:
            constraint_from_describe(c.describe())     # raises if custom

    def _codec(self):
        if getattr(self, "_codec_cache", None) is None:
            self._codec_cache = self._search_space.codec()
        return self._codec_cache

    def _spec_record(self) -> Dict:
        """The full declarative problem (everything `from_spec` needs),
        plus the execution hints `workers`, `device` and `backend`."""
        rec = {
            "name": self.name,
            "apps": list(self._app_sources),
            "engine": self.engine,
            "objective": self.objective.describe(),
            "constraints": [c.describe() for c in self.constraints],
            "budget": dataclasses.asdict(self.budget),
            "seed": self.seed,
            "backend": self.backend,
            "top_frac": self.top_frac,
            "max_candidates_per_app": self.max_candidates_per_app,
            "area_budgets": self._user_area_budgets,
            "weight_peak_mode": self.weight_peak_mode,
            "space": {"domains": {k: [int(v) for v in dom]
                                  for k, dom in self.space.domains.items()},
                      "hw": dataclasses.asdict(self.space.hw),
                      "area_budget": float(self.space.area_budget)},
            "workers": self.workers,
            "device": str(self.device),
        }
        if self.composition > 1:
            rec["composition"] = {
                "k": self.composition,
                "traffic": self.traffic.to_json(),
                "split_grid": self.split_grid,
            }
        return rec

    @classmethod
    def from_spec(cls, spec: Dict, *, workers: Optional[int] = None,
                  executor: Optional[ParallelExecutor] = None,
                  device="cuda", backend: str = "fused") -> "Study":
        """Rebuild a Study from a `_spec_record` (checkpoint `study` key).

        `workers` overrides the recorded hint.  `device` and `backend`
        default to the constructor's, never to the recorded hints: a
        checkpoint written on the CPU resumes on the GPU unless the caller
        asks for the CPU.  None of the three changes a result."""
        sp = spec["space"]
        space = DesignSpace(
            domains={k: tuple(int(v) for v in dom)
                     for k, dom in sp["domains"].items()},
            hw=HardwareConstants(**sp["hw"]),
            area_budget=float(sp["area_budget"]))
        comp = spec.get("composition") or {}
        return cls(
            apps=list(spec["apps"]), space=space,
            objective=make_objective(spec["objective"]),
            constraints=[constraint_from_describe(d)
                         for d in spec.get("constraints", [])],
            engine=spec["engine"], budget=spec["budget"],
            seed=int(spec["seed"]),
            top_frac=float(spec["top_frac"]),
            max_candidates_per_app=int(spec["max_candidates_per_app"]),
            area_budgets=spec.get("area_budgets"),
            weight_peak_mode=spec["weight_peak_mode"],
            name=spec["name"],
            device=device, backend=backend,
            workers=(workers if workers is not None
                     else int(spec.get("workers", 1))),
            executor=executor,
            composition=int(comp.get("k", 1)),
            traffic=comp.get("traffic"),
            split_grid=int(comp.get("split_grid", 4)))

    def _encode_result(self, i: int, res: SearchResult) -> Dict:
        """One per-app SearchResult as a JSON fragment.  Configs are stored
        as codec index rows (exact integer round-trip); floats survive via
        repr round-trip, so a decoded result reproduces the original
        synthesis inputs bit-for-bit, whichever device scored them."""
        codec = self._codec()
        return {
            "name": self._job_label(i),
            "best": _cfg_dict(res.best),
            "best_perf": float(res.best_perf),
            "engine": res.engine,
            "rounds": int(res.rounds),
            "evaluated": (codec.encode(res.evaluated).tolist()
                          if res.evaluated else []),
            "evaluated_perf": np.asarray(res.evaluated_perf,
                                         dtype=np.float64).tolist(),
            "evaluated_values": (res.evaluated_values.tolist()
                                 if res.evaluated_values is not None
                                 else None),
            "history": [[_cfg_dict(c), float(p)] for c, p in res.history],
        }

    def _decode_result(self, i: int, rec: Dict) -> SearchResult:
        codec = self._codec()
        idx = np.asarray(rec.get("evaluated", []), dtype=np.int64)
        evaluated = (codec.decode(idx.reshape(-1, codec.n_vars))
                     if idx.size else [])
        values = rec.get("evaluated_values")
        return SearchResult(
            best=_cfg_load(rec.get("best")),
            best_perf=float(rec["best_perf"]),
            history=[(_cfg_load(c), float(p))
                     for c, p in rec.get("history", [])],
            evaluated=evaluated,
            evaluated_perf=np.asarray(rec["evaluated_perf"],
                                      dtype=np.float64),
            rounds=int(rec["rounds"]), engine=rec.get("engine", ""),
            evaluator=self._job_evaluator(i),
            evaluated_values=(np.asarray(values, dtype=np.float64)
                              if values is not None else None))

    def _write_checkpoint(self, path, results: Dict[int, SearchResult]
                          ) -> None:
        """Atomically (tmp + rename) rewrite the progress record: a crash
        mid-write never corrupts an existing checkpoint."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        rec = {
            "version": 1,
            "kind": "study-checkpoint",
            "study": self._spec_record(),
            "checkpoint_every": int(getattr(self, "_ckpt_every", 1)),
            "completed": {str(i): self._encode_result(i, results[i])
                          for i in sorted(results)},
        }
        tmp = path.with_name(path.name + ".tmp")
        with obs.span("checkpoint_write", completed=len(results)):
            tmp.write_text(json.dumps(rec))
            os.replace(tmp, path)
        obs.counter("study.checkpoint_writes")

    @classmethod
    def resume(cls, path, *, workers: Optional[int] = None,
               executor: Optional[ParallelExecutor] = None,
               device="cuda", backend: str = "fused",
               checkpoint_every: Optional[int] = None,
               on_checkpoint: Optional[Any] = None) -> StudyResult:
        """Continue a killed study from its checkpoint and return the final
        `StudyResult` — bit-identical (JSON-serialized, `meta["device"]`
        and `meta["backend"]` aside) to what the uninterrupted run would
        have produced, because completed per-app fragments round-trip
        exactly and the remaining searches rerun from their canonical
        seeds.  `workers`, `device` and `backend` are as in `from_spec`.
        The checkpoint file is removed on success."""
        rec = json.loads(Path(path).read_text())
        if rec.get("kind") != "study-checkpoint":
            raise ValueError(f"{path} is not a study checkpoint")
        study = cls.from_spec(rec["study"], workers=workers,
                              executor=executor, device=device,
                              backend=backend)
        study._resume_state = {
            int(i): study._decode_result(int(i), frag)
            for i, frag in rec.get("completed", {}).items()}
        every = (checkpoint_every if checkpoint_every is not None
                 else int(rec.get("checkpoint_every", 1)))
        return study.run(checkpoint_path=path, checkpoint_every=every,
                         on_checkpoint=on_checkpoint)

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
        peak floors, no area budget), through each app's evaluator (built
        here when the study has not run)."""
        if not self._evaluators:
            self._evaluators = [self._make_evaluator(s) for s in self.specs]
        batch = ConfigBatch.from_configs(list(configs))
        return np.stack([ev.raw_metrics(batch)[0]
                         for ev in self._evaluators])

    def _cross_eval(self, cands: Sequence[Any]) -> np.ndarray:
        """[n_apps, n_cands] GOPS matrix; columns infeasible under any
        injected extra constraint are zeroed wholesale (selection-time
        metrics offer `area`).

        With `workers > 1` and at least `cross_eval_shard_min` candidates
        the columns fan out over the process pool (`_cross_eval_task`, each
        shard scored on `device` in its worker); contiguous order-
        preserving shards concatenate back to exactly the serial matrix
        (the cost model is column-wise independent)."""
        batch = ConfigBatch.from_configs(list(cands))
        if (self.workers > 1 or self.executor is not None) \
                and len(batch) >= self.cross_eval_shard_min:
            ex = self._executor()
            apps = [(s.stream,) + self._peaks_for(s) for s in self.specs]
            payloads = [{"batch": batch.take(rows), "hw": self.space.hw,
                         "apps": apps, "constraints": tuple(self._extra),
                         "domains": self._domains(),
                         "device": str(self.device),
                         "backend": self.backend}
                        for rows in shard_rows(len(batch), ex.workers)]
            with obs.span("cross_eval", candidates=len(batch),
                          shards=len(payloads)):
                parts = ex.map(_cross_eval_task, payloads)
            return np.concatenate(parts, axis=1)
        with obs.span("cross_eval", candidates=len(batch), shards=1):
            cross = self._gops_matrix(batch)
            if self._extra:
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

    def _select_per_budget(self, front: List[FrontPoint]
                           ) -> Tuple[Dict[str, Optional[Dict]],
                                      Optional[FrontPoint]]:
        """The best-scoring front point within each area budget (None
        where none fits), and the study's best: the best selection within
        the declared area budget, else the best front point."""
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
        return selections, best_pt

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

        selections, best_pt = self._select_per_budget(front)

        return StudyResult(
            meta=self._meta(),
            best=best_pt.config if best_pt else None,
            best_score=float(best_pt.score) if best_pt else 0.0,
            per_app=per_app, front=front, budget_selections=selections,
            per_app_results=per_app_results)

    # --------------------------- composition synthesis (the CDAC stage)
    def _synthesize_composition(self, job_results: Dict[int, SearchResult]
                                ) -> StudyResult:
        """CHARM-style CDAC over the per-tier CDSE job results: build a
        raw-metric engine menu per app, enumerate every canonical
        (assignment, split) partition, pick each group's best engine
        within its budget slice, then traffic-score the assembled
        `Composition`s and sweep the joint (score, total-area) front.

        Pure function of the job results plus declared knobs — the same
        candidate order and tie-breaks regardless of worker count,
        completion order or device, so composition StudyResults stay
        byte-identical across `workers=N`."""
        specs = self.specs
        apps = [s.name for s in specs]
        K = self.composition

        per_app: Dict[str, Dict] = {}
        for j in sorted(job_results):
            res = job_results[j]
            _, share = self._jobs[j]
            per_app[self._job_label(j)] = {
                "best": _cfg_dict(res.best),
                # raw GOPS (tier incumbents are feasible under their tier
                # budget, so the shard's masking never zeroes them)
                "best_perf": (
                    float(res.evaluator.score_with_area([res.best])[0][0])
                    if res.best is not None else 0.0),
                "best_scalarized": float(res.best_perf),
                "n_evaluated": len(res.evaluated),
                "rounds": int(res.rounds),
                "area_share": float(share),
            }
        per_app_results = {self._job_label(j): job_results[j]
                           for j in sorted(job_results)}

        comp_ev = CompositionEvaluator(
            specs, hw=self.space.hw, traffic=self.traffic,
            area_budget=0.0, constraints=tuple(self._extra),
            domains=self._domains(), device=self.device,
            backend=self.backend)
        for j in sorted(job_results):
            i, _ = self._jobs[j]
            comp_ev.warm_from(specs[i].name,
                              job_results[j].evaluator.cache_export())
        self._evaluators = [comp_ev.shards[name] for name in apps]

        # per-app engine menus: each area tier contributes its raw-metric
        # non-dominated set (+ the tier incumbent); tiers merge per app.
        # Metrics come from the budget-free shards, so one config never
        # carries conflicting numbers across tiers, and an all-infeasible
        # tier reduces to an empty shard front.
        menus: Dict[int, List[Any]] = {}
        for i, name in enumerate(apps):
            shard = comp_ev.shards[name]
            tier_fronts: List[List[Tuple[Any, float, float]]] = []
            for j in sorted(job_results):
                if self._jobs[j][0] != i:
                    continue
                res = job_results[j]
                pool = list(res.evaluated)
                if res.best is not None:
                    pool.append(res.best)
                if not pool:
                    tier_fronts.append([])
                    continue
                perf, area = shard.score_with_area(pool)
                keys = [config_key(c) for c in pool]
                idx = canonical_front_indices(perf, area, keys)
                tier_fronts.append(
                    [(pool[t], float(perf[t]), float(area[t]))
                     for t in idx[:self.max_candidates_per_app]])
            merged = merge_pareto_fronts(tier_fronts)
            menus[i] = [cfg for cfg, _, _
                        in merged[:self.max_candidates_per_app]]

        # global engine candidate pool, deduped by content in (app,
        # front-position) order
        seen = set()
        cands: List[Any] = []
        for i in range(len(apps)):
            for cfg in menus[i]:
                key = config_key(cfg)
                if key not in seen:
                    seen.add(key)
                    cands.append(cfg)
        if not cands:
            return StudyResult(
                meta=self._meta(), best=None, best_score=0.0,
                per_app=per_app, front=[],
                budget_selections={f"{b:g}": None
                                   for b in self.area_budgets},
                per_app_results=per_app_results)

        cross, areas = comp_ev.app_matrix(cands)
        ckeys = [config_key(c) for c in cands]
        w = self.traffic.vector()

        # CDAC enumeration: the total log-score decomposes per group
        # (sum over members of w_a*(log f_a + log gops_a)), so under a
        # given (assignment, split, budget) each group independently
        # takes its best affordable engine — exact, not heuristic.
        comps: Dict[Tuple, Composition] = {}
        for assignment in enumerate_assignments(len(apps), K):
            members = group_members(assignment, K)
            glogs = np.full((K, len(cands)), -np.inf)
            for g, mem in enumerate(members):
                wg = float(sum(w[a] for a in mem))
                ok = (cross[mem, :] > 0).all(axis=0)
                vals = np.zeros(len(cands))
                for a in mem:
                    vals += w[a] * (np.log(w[a] / wg)
                                    + np.log(np.maximum(cross[a], 1e-12)))
                glogs[g] = np.where(ok, vals, -np.inf)
            for split in enumerate_splits(K, self.split_grid):
                for b in self.area_budgets:
                    picks: Optional[List[int]] = []
                    for g in range(K):
                        cap = float(split[g]) * float(b)
                        elig = np.flatnonzero((areas <= cap)
                                              & np.isfinite(glogs[g]))
                        if elig.size == 0:
                            picks = None
                            break
                        picks.append(min(
                            elig.tolist(),
                            key=lambda c: (-glogs[g][c], areas[c],
                                           ckeys[c])))
                    if picks is None:
                        continue
                    comp = Composition(
                        engines=tuple(cands[c] for c in picks),
                        assignment=tuple(assignment),
                        apps=tuple(apps), split=tuple(split))
                    # same engines + routing from another split/budget is
                    # the same physical design; first proposer wins
                    comps.setdefault(comp.key(), comp)

        ordered_keys = sorted(comps)
        ordered = [comps[k] for k in ordered_keys]
        scores, careas = comp_ev.score_with_area(ordered)
        front_idx = canonical_front_indices(scores, careas, ordered_keys)
        front = [FrontPoint(config=ordered[i], score=float(scores[i]),
                            area=float(careas[i]),
                            per_app=comp_ev.per_app_rates(ordered[i]))
                 for i in front_idx]

        selections, best_pt = self._select_per_budget(front)

        return StudyResult(
            meta=self._meta(),
            best=best_pt.config if best_pt else None,
            best_score=float(best_pt.score) if best_pt else 0.0,
            per_app=per_app, front=front, budget_selections=selections,
            per_app_results=per_app_results)
