"""Parallel, fault-tolerant execution layer for `repro_torch.dse` studies.

The per-app searches of a `Study` are embarrassingly parallel: each
application's multi-restart engine run touches its own op stream and its
own memoizing `Evaluator`.  This module fans that work out over a process
pool while keeping every result **deterministic**:

  * `ParallelExecutor` — bounded-retry process-pool map.  Tasks are
    addressed by index, results are returned in task order (never
    completion order), a worker that raises or dies (SIGKILL -> broken
    pool) is retried up to `max_retries` rounds on a fresh pool, and when
    retries are exhausted the remaining tasks degrade to in-process serial
    execution with a `ParallelExecutionWarning` — the study still
    completes, with the exact result a serial run would have produced.
  * `EvalParams` — a picklable recipe for a worker's own `Evaluator`
    shard (stream + hw + peaks + budget + injected objective/constraints
    + the device and backend it scores on).  Each worker builds its shard
    locally, scores through it (on the GPU: its own CUDA context, its own
    scorer tables, `gather_rows` launched in the worker), and ships the
    shard's raw-metric cache back as bytes and floats for a deterministic
    `Evaluator.cache_merge` on the parent.
  * `_search_app_task` / `_score_shard_task` / `_cross_eval_task` — the
    module-level worker functions (picklable under the ``spawn`` start
    method) for per-app searches, sharded population scoring, and sharded
    cross-evaluation.  Payloads and results hold numpy arrays and Python
    values only, never a tensor or a live evaluator.
  * `canonical_front_indices` / `merge_pareto_fronts` — Pareto-front
    reduction with content-based tie-breaking, invariant to worker count
    and shard arrival order.
  * `FaultPlan` — cross-process fault injection for the tests: make the
    Nth matching worker invocation raise or SIGKILL itself, counted
    through O_EXCL token files so the plan survives pool restarts.

Kernel launches are counted per task: `gather_rows.launches` counts in
the process that launches, so each task reads it before and after and
the executor keeps one record per completed task in `tasks` (which
function, which process, pool or in-process, launches, seconds).  The
records never reach a `StudyResult`.

Determinism contract: given the same task payloads, `executor.map`
returns the same results regardless of `workers`, retries, fallbacks, or
completion order, because every task is a pure function of its payload
and the reduce steps (`SearchResult.merge`, `merge_pareto_fronts`,
ordered concatenation of score shards) are order-canonical.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.costmodel import (ConfigBatch, HardwareConstants,
                                        OpStream, area_many)
from repro_torch.core.search import Evaluator, config_key, optimize_for_app
from repro_torch.kernels import gather

_LOG = obs.get_logger("dse.parallel")

__all__ = ["ParallelExecutor", "ParallelExecutionWarning", "FaultPlan",
           "EvalParams", "canonical_front_indices", "merge_pareto_fronts",
           "score_population_sharded", "shard_rows"]


class ParallelExecutionWarning(UserWarning):
    """Raised (as a warning) when the pool degrades to serial execution."""


# --------------------------------------------------------------------------
# Fault injection (test support)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class FaultPlan:
    """Deterministic worker-fault injection for the fault-tolerance tests.

    The first `times` matching worker invocations fail: ``mode="raise"``
    raises RuntimeError inside the worker, ``mode="kill"`` SIGKILLs the
    worker process (exercising the broken-pool path).  `task_index`
    restricts the fault to one task (None = any task).  Consumption is
    counted via O_EXCL token files under `state_dir`, so the count is
    shared across pool restarts and retry rounds — exactly `times`
    failures fire, then the task succeeds.  Faults fire only inside pool
    workers, never on the in-process serial path (so the degraded-mode
    fallback always completes).
    """

    state_dir: str
    mode: str = "raise"              # "raise" | "kill"
    times: int = 1
    task_index: Optional[int] = None

    def to_wire(self) -> Dict[str, Any]:
        return {"dir": self.state_dir, "mode": self.mode,
                "times": int(self.times), "task_index": self.task_index}


def _fault_should_fire(fault: Dict[str, Any], task_index: int) -> bool:
    if fault["task_index"] is not None \
            and int(fault["task_index"]) != task_index:
        return False
    d = Path(fault["dir"])
    d.mkdir(parents=True, exist_ok=True)
    for n in range(int(fault["times"])):
        try:
            fd = os.open(str(d / f"fired.{n}"),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            continue
        os.close(fd)
        return True
    return False


def _counted(fn: Callable[[Any], Any], payload: Any
             ) -> Tuple[Any, Dict[str, Any]]:
    """Run one task and count the `gather_rows` launches it made in this
    process, with its pid and wall seconds."""
    started = time.time()
    before = gather.gather_rows.launches
    t0 = time.perf_counter()
    out = fn(payload)
    return out, {"pid": os.getpid(),
                 "launches": int(gather.gather_rows.launches - before),
                 "seconds": time.perf_counter() - t0, "started": started}


def _call_task(fn: Callable[[Any], Any], payload: Any, task_index: int,
               fault: Optional[Dict[str, Any]]) -> Tuple[Any, Dict]:
    """Worker-side entry: optionally fire an injected fault, then run."""
    if fault is not None and _fault_should_fire(fault, task_index):
        if fault["mode"] == "kill":
            import signal
            os.kill(os.getpid(), signal.SIGKILL)
        raise RuntimeError(
            f"injected worker fault on task {task_index}")
    return _counted(fn, payload)


# --------------------------------------------------------------------------
# The executor
# --------------------------------------------------------------------------

class ParallelExecutor:
    """Bounded-retry process-pool map with serial fallback.

    ``map(fn, payloads)`` runs `fn` over every payload and returns the
    results **in payload order**.  With ``workers <= 1`` everything runs
    in-process (no pool, no pickling) — the reference semantics every
    parallel run must reproduce.  With ``workers > 1`` tasks are submitted
    to a ``ProcessPoolExecutor`` under the ``spawn`` start method (never
    ``fork``: a forked child cannot use a CUDA context its parent made);
    each retry round gets a fresh pool, so a SIGKILLed worker
    (BrokenProcessPool poisons all pending futures) costs one round, not
    the study.  After ``1 + max_retries`` failed rounds the surviving
    tasks run serially in-process and a `ParallelExecutionWarning` is
    emitted.

    `on_result(index, result)` fires as results arrive (completion order)
    — the streaming-checkpoint hook.  Exceptions it raises propagate (a
    deliberately crashed checkpoint callback aborts the map).

    `tasks` gets one record per completed task: ``fn`` (the task
    function's name), ``task`` (its index in that map), ``pool`` (ran in a
    pool worker), ``pid``, ``launches`` (`gather_rows` launches it made)
    and ``seconds``.  `pool_start_seconds` lists, per pool round, the
    seconds from creating the pool to the start of its first task (the
    spawned workers' interpreter start and imports).
    """

    def __init__(self, workers: int = 1, max_retries: int = 2,
                 mp_context: str = "spawn",
                 fault: Optional[FaultPlan] = None):
        self.workers = max(1, int(workers))
        self.max_retries = int(max_retries)
        self.mp_context = mp_context
        self.fault = fault
        self.degraded = False        # True once a map fell back to serial
        self.retry_rounds = 0        # extra pool rounds used so far
        self.tasks: List[Dict[str, Any]] = []
        self.pool_start_seconds: List[float] = []

    # ------------------------------------------------------------------ map
    def map(self, fn: Callable[[Any], Any], payloads: Sequence[Any],
            on_result: Optional[Callable[[int, Any], None]] = None
            ) -> List[Any]:
        payloads = list(payloads)
        results: Dict[int, Any] = {}

        def _serial(indices: Sequence[int]) -> None:
            for i in indices:
                results[i], info = _counted(fn, payloads[i])
                self.tasks.append({"fn": fn.__name__, "task": i,
                                   "pool": False, **info})
                if on_result is not None:
                    on_result(i, results[i])

        if self.workers <= 1 or len(payloads) <= 1:
            _serial(range(len(payloads)))
            return [results[i] for i in range(len(payloads))]

        wire_fault = self.fault.to_wire() if self.fault is not None else None
        remaining = list(range(len(payloads)))
        for attempt in range(1 + self.max_retries):
            if not remaining:
                break
            if attempt > 0:
                self.retry_rounds += 1
                obs.counter("pool.retry_rounds")
                obs.log_event(_LOG, "info", "pool.retry",
                              attempt=attempt, tasks=len(remaining))
            remaining = self._pool_round(fn, payloads, remaining,
                                         wire_fault, results, on_result)
        if remaining:
            self.degraded = True
            obs.counter("pool.serial_degradations")
            msg = (f"parallel execution failed for {len(remaining)} task(s) "
                   f"after {1 + self.max_retries} pool round(s); degrading "
                   f"to serial in-process execution")
            obs.log_event(_LOG, "warning", "pool.serial_degradation",
                          tasks=len(remaining),
                          rounds=1 + self.max_retries)
            warnings.warn(msg, ParallelExecutionWarning, stacklevel=2)
            _serial(remaining)
        return [results[i] for i in range(len(payloads))]

    def _pool_round(self, fn, payloads, indices, wire_fault, results,
                    on_result) -> List[int]:
        """One pool generation over `indices`; returns the failed subset
        (ascending task order, so retries are deterministic too)."""
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor, as_completed

        ctx = multiprocessing.get_context(self.mp_context)
        failed: List[int] = []
        created = time.time()
        starts: List[float] = []
        try:
            pool = ProcessPoolExecutor(
                max_workers=min(self.workers, len(indices)),
                mp_context=ctx)
        except (OSError, ValueError):          # cannot even start a pool
            return list(indices)
        with pool:
            futures = {}
            for i in indices:
                try:
                    futures[pool.submit(_call_task, fn, payloads[i], i,
                                        wire_fault)] = i
                except Exception:              # pool already broken
                    failed.append(i)
            for fut in as_completed(futures):
                i = futures[fut]
                try:
                    results[i], info = fut.result()
                except Exception as e:
                    # task raise, pickling failure, or BrokenProcessPool
                    # (a killed worker poisons every pending future)
                    failed.append(i)
                    obs.counter("pool.task_failures")
                    obs.instant("pool.task_failure", task=i,
                                error=type(e).__name__)
                    obs.log_event(_LOG, "info", "pool.task_failure",
                                  task=i, error=type(e).__name__)
                    continue
                starts.append(info["started"])
                self.tasks.append({"fn": fn.__name__, "task": i,
                                   "pool": True, **info})
                if on_result is not None:
                    on_result(i, results[i])
        if starts:
            self.pool_start_seconds.append(min(starts) - created)
        return sorted(failed)


# --------------------------------------------------------------------------
# Worker-side evaluator shards
# --------------------------------------------------------------------------

@dataclasses.dataclass
class EvalParams:
    """Picklable recipe for one worker's memoizing `Evaluator` shard.

    The cache keys of the built evaluator are content-addressed (row bytes
    of the canonical config field matrix), so two shards that score the
    same configuration produce the same key *and* the same value — shard
    caches merge without conflicts in any order (`Evaluator.cache_merge`),
    whichever device each shard scored on.  `device` is a string (a worker
    resolves it itself) and `backend` the evaluator's (``"fused"`` or
    ``"broadcast"``)."""

    stream: OpStream
    hw: HardwareConstants
    peak_weight_bits: int = 0
    peak_input_bits: int = 0
    area_budget: float = 0.0
    objective: Optional[Any] = None
    constraints: Tuple = ()
    # design-space value domains ({field: (values...)}); lets every worker
    # shard build its fused score tables domain-complete on first use
    domains: Optional[Dict[str, Tuple[int, ...]]] = None
    device: str = "cuda"
    backend: str = "fused"

    def build(self) -> Evaluator:
        return Evaluator(self.stream, hw=self.hw,
                         peak_weight_bits=self.peak_weight_bits,
                         peak_input_bits=self.peak_input_bits,
                         area_budget=self.area_budget,
                         objective=self.objective,
                         constraints=self.constraints,
                         domains=self.domains, device=self.device,
                         backend=self.backend)


def _search_app_task(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Run one application's multi-restart search in a worker.

    Returns a portable record (no live evaluator handle): the incumbent,
    the full evaluated log as a `ConfigBatch`, the worker shard's
    raw-metric cache for the parent-side merge, and — when the payload
    carries obs wire state and this is a fresh pool process — the task's
    exported trace/journal/metrics buffers (`"obs"`, None on the
    in-process path, where events land in the live parent buffers)."""
    owned = obs.begin_task(payload.get("obs"))
    prev_ctx = obs.get_context()
    obs.set_context(app=payload["name"])
    export = None
    try:
        params: EvalParams = payload["params"]
        ev = params.build()
        with obs.span("search_app", app=payload["name"],
                      engine=str(payload["engine"]),
                      seed=int(payload["seed"]),
                      restarts=int(payload["restarts"])):
            res = optimize_for_app(
                params.stream, payload["space"],
                k=payload["k"], restarts=payload["restarts"],
                seed=payload["seed"], max_rounds=payload["max_rounds"],
                engine=payload["engine"],
                engine_kwargs=payload["engine_kwargs"],
                evaluator=ev)
    finally:
        export = obs.end_task(owned)
        if not owned:
            obs.replace_context(prev_ctx)
    return {
        "name": payload["name"],
        "best": res.best,
        "best_perf": float(res.best_perf),
        "history": list(res.history),
        "evaluated": (ConfigBatch.from_configs(res.evaluated)
                      if res.evaluated else None),
        "evaluated_perf": np.asarray(res.evaluated_perf, dtype=np.float64),
        "evaluated_values": res.evaluated_values,
        "rounds": int(res.rounds),
        "engine": res.engine,
        "cache": ev.cache_export(),
        "stats": ev.stats(),
        "obs": export,
    }


def _score_shard_task(payload: Dict[str, Any]) -> np.ndarray:
    """Score one ConfigBatch shard through a fresh evaluator shard."""
    ev = payload["params"].build()
    return np.asarray(ev(payload["batch"]), dtype=np.float64)


def _cross_eval_task(payload: Dict[str, Any]) -> np.ndarray:
    """[n_apps, shard] raw GOPS matrix for one candidate-column shard.

    Each app row is scored through an `Evaluator` built on the payload's
    `device` and `backend` (no area budget: Eq. 9-13 zeroing only), as the
    serial cross-evaluation does; columns infeasible under an injected
    extra constraint are zeroed wholesale."""
    batch: ConfigBatch = payload["batch"]
    hw: HardwareConstants = payload["hw"]
    out = np.zeros((len(payload["apps"]), len(batch)))
    for i, (stream, pw, pi) in enumerate(payload["apps"]):
        ev = EvalParams(stream=stream, hw=hw, peak_weight_bits=pw,
                        peak_input_bits=pi, domains=payload.get("domains"),
                        device=payload["device"],
                        backend=payload["backend"]).build()
        out[i] = ev.raw_metrics(batch)[0]
    extra = payload.get("constraints") or ()
    if extra:
        from repro_torch.dse.constraints import feasible_mask_all
        metrics = {"area": area_many(batch, hw)}
        mask = feasible_mask_all(extra, batch, metrics)
        out[:, ~mask] = 0.0
    return out


def shard_rows(n: int, shards: int) -> List[np.ndarray]:
    """Contiguous row-index shards covering range(n) (order-preserving, so
    concatenating shard outputs reproduces the unsharded row order)."""
    shards = max(1, min(int(shards), n)) if n else 1
    return [idx for idx in np.array_split(np.arange(n, dtype=np.int64),
                                          shards) if len(idx)]


def score_population_sharded(params: EvalParams, batch: ConfigBatch,
                             executor: ParallelExecutor) -> np.ndarray:
    """Score a population with each shard on its own worker-side evaluator
    shard; ordered concatenation makes the result bit-identical to one
    unsharded evaluator call (the cost model is row-wise independent)."""
    shards = shard_rows(len(batch), executor.workers)
    payloads = [{"params": params, "batch": batch.take(rows)}
                for rows in shards]
    parts = executor.map(_score_shard_task, payloads)
    return np.concatenate(parts) if parts else np.zeros(0)


# --------------------------------------------------------------------------
# Deterministic Pareto-front reduction
# --------------------------------------------------------------------------

def canonical_front_indices(perf: np.ndarray, area: np.ndarray,
                            keys: Optional[Sequence] = None) -> List[int]:
    """Non-dominated set for (maximize perf, minimize area) with canonical,
    content-based ordering: the sweep runs over (area asc, perf desc,
    key asc), so the returned front — and which of several metric-tied
    points represents a front step — does not depend on the input order.
    Zero-performance (constraint-violating) points never enter."""
    perf = np.asarray(perf, dtype=np.float64)
    area = np.asarray(area, dtype=np.float64)
    cand = np.flatnonzero(perf > 0)
    if cand.size == 0:
        return []
    if keys is None:
        order = cand[np.lexsort((-perf[cand], area[cand]))]
    else:
        order = sorted(cand.tolist(),
                       key=lambda i: (area[i], -perf[i], keys[i]))
    front: List[int] = []
    best = -np.inf
    for i in order:
        if perf[i] > best:
            front.append(int(i))
            best = perf[i]
    return front


def merge_pareto_fronts(shard_fronts: Sequence[Sequence[Tuple[Any, float,
                                                              float]]]
                        ) -> List[Tuple[Any, float, float]]:
    """Reduce per-shard (config, perf, area) fronts into one global front,
    invariant to shard count and arrival order.

    Entries are first deduped by config content (`config_key`; ties keep
    one canonical representative), then swept with
    `canonical_front_indices`.  The output is sorted by ascending area —
    the same shape `pareto_front_indices` produces — so downstream
    consumers (budget selections, plots) need no changes.

    Shards may be `None` or empty (an all-infeasible worker partition —
    routine under composition sharding, where a tight area tier can zero
    out every candidate a shard saw); they contribute nothing.  An input
    of only such shards reduces to the empty front."""
    by_key: Dict[Tuple, Tuple[Any, float, float]] = {}
    for front in shard_fronts:
        if front is None or len(front) == 0:
            continue
        for cfg, perf, area in front:
            k = config_key(cfg)
            prev = by_key.get(k)
            # identical configs must carry identical metrics; keep the
            # first and let mismatches surface loudly rather than silently
            if prev is not None:
                if (float(prev[1]), float(prev[2])) != (float(perf),
                                                        float(area)):
                    raise ValueError(
                        f"conflicting metrics for one config across "
                        f"shards: {prev[1:]} vs {(perf, area)}")
                continue
            by_key[k] = (cfg, float(perf), float(area))
    entries = [by_key[k] for k in sorted(by_key)]
    perf = np.asarray([e[1] for e in entries])
    area = np.asarray([e[2] for e in entries])
    keys = sorted(by_key)
    idx = canonical_front_indices(perf, area, keys)
    return [entries[i] for i in idx]
