"""Shared memoizing evaluator.

`Evaluator` is the accelerator-space scorer: one batched model call per
pool, behind a cache keyed by the raw canonical field bytes of each config,
so repeated points — within a run, across rounds, across restarts, across
engines sharing the evaluator — are never re-scored.  It returns the GOPS
of the op stream, zeroed where the area budget or the Eq. 9-13 constraints
are violated.  Areas are cached alongside scores so the multi-objective
Pareto mode costs nothing extra.

The cache is the vectorized `rowcache.RowHashCache` (a 64-bit row hash over
the canonical field matrix feeding an open-addressed int64 table with
exact-key collision fallback), on the host.  Cache misses go to one of two
backends on `device` — the GPU unless the caller asks for the CPU:

  * ``"fused"`` (the default): `FusedTorchScorer`, the table-gather
    scorer with the `gather_rows` kernel.  It refuses a stream with a
    zero-size kernel or stride;
  * ``"broadcast"``: `performance_gops(backend="broadcast")` and
    `area_many`, the Eqs. (1)-(13) broadcast pass, which scores any
    stream.

Both give the same bits; only the caller chooses, nothing falls back.

The cache is shard-safe: `cache_export` / `cache_merge` move it between
evaluators of the same stream (a process-pool worker's shard and the
parent's evaluator) as plain bytes and floats.

`FunctionEvaluator` wraps an arbitrary scalar scoring function (e.g. the
dry-run `CellEvaluator` of `core/autotune.py`) behind the same pool
interface, with its own memo, so every engine also drives spaces that are
not the accelerator's.  Pass `batch_score_fn` when the scorer can take a
whole pool at once: each pool's cache misses are then scored in one call.
It runs on the host and never touches a device.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.costmodel import (AccelConfig, ConfigBatch,
                                        HardwareConstants, OpStream,
                                        area_many, performance_gops,
                                        resolve_device)
from repro_torch.core.search import rowcache
from repro_torch.core.search.rowcache import RowHashCache
from repro_torch.kernels.costmodel import FusedTorchScorer

__all__ = ["Evaluator", "FunctionEvaluator", "config_key", "BACKENDS"]

BACKENDS = ("fused", "broadcast")


def config_key(cfg: Any) -> Tuple:
    """Stable hashable identity of a config (dataclass field tuple)."""
    if hasattr(cfg, "asdict"):
        return tuple(sorted(cfg.asdict().items()))
    return tuple(sorted(dataclasses.asdict(cfg).items()))


class _LRU:
    """Tiny LRU dict: key -> value, bounded size, hit/miss counters."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.data: "collections.OrderedDict[Tuple, Any]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: Tuple) -> Optional[Any]:
        if key in self.data:
            self.data.move_to_end(key)
            self.hits += 1
            return self.data[key]
        self.misses += 1
        return None

    def put(self, key: Tuple, value: Any) -> None:
        self.data[key] = value
        self.data.move_to_end(key)
        self.trim()

    def trim(self) -> None:
        while len(self.data) > self.maxsize:
            self.data.popitem(last=False)


class Evaluator:
    """Batched, memoizing scorer for accelerator configs on one op stream.

    `evaluator(pool)` returns the [len(pool)] GOPS vector with the area
    budget applied (0.0 on violation) — identical values to scoring the pool
    uncached, in any batch composition.

    Objective/constraint injection (the `repro_torch.dse` facade): pass
    `objective` (an object with `score(metrics) -> [N]`, or with
    `values(metrics) -> [N, M]` + `scalarize` for vector objectives) and/or
    `constraints` (objects with `feasible_mask(batch, metrics) -> bool[N]`)
    to reshape what `evaluator(pool)` hands the engines.  The cache always
    stores the *raw* (GOPS, area) metrics — Eq. 9-13 zeroing only — so one
    cache serves every objective.  With the defaults the output is the
    GOPS vector above.

    Under ``backend="fused"`` a stream the fused scorer does not support
    (a zero-size kernel or stride) raises at construction; under
    ``"broadcast"`` it is scored.
    """

    def __init__(self, stream: OpStream,
                 hw: Optional[HardwareConstants] = None,
                 peak_weight_bits: int = 0,
                 peak_input_bits: int = 0,
                 area_budget: float = 0.0,
                 cache_size: int = 1 << 16,
                 objective: Optional[Any] = None,
                 constraints: Optional[Sequence[Any]] = None,
                 domains: Optional[Dict[str, Sequence[int]]] = None,
                 device="cuda", backend: str = "fused"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of "
                             f"{BACKENDS}")
        self.stream = stream
        self.hw = hw or HardwareConstants()
        self.peak_weight_bits = peak_weight_bits
        self.peak_input_bits = peak_input_bits
        # Eq. (13) checks abuf >= peak_input_bits * max(batch); validity
        # repair must target the same batch-scaled floor or batched streams
        # (e.g. wdl at batch 128) leave repaired configs still invalid.
        max_batch = int(stream.batch.max()) if len(stream) else 1
        self.peak_input_bits_scaled = peak_input_bits * max_batch
        self.area_budget = area_budget
        self.objective = objective
        self.constraints = tuple(constraints or ())
        # Known per-field value domains (DesignSpace.domains) let the fused
        # scorer build its op tables domain-complete up front; without them
        # the tables grow on first sight of each new value.
        self.domains = ({k: tuple(v) for k, v in domains.items()}
                        if domains else None)
        self.device = resolve_device(device)
        self.backend = backend
        self.scorer = (FusedTorchScorer(stream, self.hw, peak_weight_bits,
                                        peak_input_bits,
                                        domains=self.domains,
                                        device=self.device)
                       if backend == "fused" else None)
        self._cache = RowHashCache(len(ConfigBatch._INDEX), cache_size)
        self.n_batches = 0       # batched model invocations
        self.n_scored = 0        # configs actually sent to the model
        self.dedup_skipped = 0   # cross-round re-proposals (run_search)

    @classmethod
    def for_space(cls, stream: OpStream, space,
                  peak_weight_bits: int = 0, peak_input_bits: int = 0,
                  cache_size: int = 1 << 16,
                  objective: Optional[Any] = None,
                  constraints: Optional[Sequence[Any]] = None,
                  device="cuda", backend: str = "fused") -> "Evaluator":
        """Evaluator bound to a DesignSpace's hw constants + area budget."""
        return cls(stream, hw=space.hw,
                   peak_weight_bits=peak_weight_bits,
                   peak_input_bits=peak_input_bits,
                   area_budget=space.area_budget, cache_size=cache_size,
                   objective=objective, constraints=constraints,
                   domains=getattr(space, "domains", None), device=device,
                   backend=backend)

    # -------------------------------------------------------------- scoring
    def _score_batch(self, matrix: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Uncached path: ONE model call for the whole `[N, 18]` matrix.

        Returns *raw* metrics: GOPS with only the Eq. 9-13 stream
        constraints applied (what `performance_gops` does), plus areas.
        Area-budget masking happens post-cache so the cached values are
        objective-independent."""
        with obs.span("evaluate_batch", n=int(matrix.shape[0]),
                      backend=self.backend):
            if self.scorer is not None:
                perf, areas = self.scorer.metrics(matrix)
            else:
                batch = ConfigBatch(matrix)
                perf = performance_gops(batch, self.stream, self.hw,
                                        self.peak_weight_bits,
                                        self.peak_input_bits,
                                        backend="broadcast",
                                        device=self.device)
                areas = area_many(batch, self.hw, device=self.device)
        self.n_batches += 1
        self.n_scored += int(matrix.shape[0])
        return perf, areas

    def __call__(self, pool) -> np.ndarray:
        batch = ConfigBatch.from_configs(pool)
        perf, area = self._metrics_of(batch)
        mask = self.feasible_mask(batch, {"perf": perf, "area": area})
        metrics = {"perf": np.where(mask, perf, 0.0), "area": area}
        if self.objective is None:
            return metrics["perf"]
        values_fn = getattr(self.objective, "values", None)
        if values_fn is not None:            # vector objective: [N, M] rows
            return values_fn(metrics)
        return np.where(mask, self.objective.score(metrics), 0.0)

    def feasible_mask(self, batch, metrics) -> np.ndarray:
        """AND of the area budget and every injected constraint."""
        mask = np.ones(len(batch), dtype=bool)
        if self.area_budget > 0:
            mask &= metrics["area"] <= self.area_budget
        for c in self.constraints:
            mask &= np.asarray(c.feasible_mask(batch, metrics), dtype=bool)
        return mask

    def scalarize(self, values: np.ndarray) -> np.ndarray:
        """[N, M] objective rows -> [N] engine scores (vector objectives)."""
        fn = getattr(self.objective, "scalarize", None)
        if fn is not None:
            return np.asarray(fn(values), dtype=np.float64)
        return np.asarray(values, dtype=np.float64)[:, 0]

    def score_with_area(self, pool) -> Tuple[np.ndarray, np.ndarray]:
        """(gops[N], area[N]) with the area budget applied to gops, through
        the cache (NSGA-II's objective rows), independent of any injected
        objective."""
        perf, area = self._metrics_of(ConfigBatch.from_configs(pool))
        if self.area_budget > 0:
            perf = np.where(area <= self.area_budget, perf, 0.0)
        return perf, area

    def raw_metrics(self, pool) -> Tuple[np.ndarray, np.ndarray]:
        """Raw (gops[N], area[N]) through the cache: Eq. 9-13 zeroing
        only, no area budget, no objective."""
        return self._metrics_of(ConfigBatch.from_configs(pool))

    def _metrics_of(self, batch) -> Tuple[np.ndarray, np.ndarray]:
        """Raw (gops[N], area[N]) for a `ConfigBatch` through the cache.

        One 64-bit hash pass over the row matrix, exact in-pool dedup
        (duplicates count neither as hits nor misses), one batched table
        probe for the unique rows, one model call for the miss set, one
        scatter back."""
        matrix = np.ascontiguousarray(batch.matrix)
        n = matrix.shape[0]
        perf = np.empty(n, dtype=np.float64)
        area = np.empty(n, dtype=np.float64)
        if n == 0:
            return perf, area
        cache = self._cache
        hashes = rowcache.hash_rows(matrix)
        rep = rowcache.first_occurrence(matrix, hashes)
        uniq = np.flatnonzero(rep == np.arange(n))
        found, vals = cache.lookup(matrix[uniq], hashes[uniq])
        cache.hits += int(found.sum())
        cache.misses += int(uniq.size - found.sum())
        hit_rows = uniq[found]
        perf[hit_rows] = vals[found, 0]
        area[hit_rows] = vals[found, 1]
        miss_rows = uniq[~found]
        if miss_rows.size:
            fp, fa = self._score_batch(matrix[miss_rows])
            perf[miss_rows] = fp
            area[miss_rows] = fa
            cache.insert(matrix[miss_rows], hashes[miss_rows],
                         np.stack([fp, fa], axis=1))
        if uniq.size != n:                  # copy duplicates from their rep
            perf = perf[rep]
            area = area[rep]
        return perf, area

    def score_one(self, cfg: AccelConfig) -> float:
        s = np.asarray(self([cfg]), dtype=np.float64)
        if s.ndim == 2:                     # vector objective: scalarize
            s = self.scalarize(s)
        return float(s[0])

    def explain(self, cfg: AccelConfig):
        """Per-op Table-1 attribution of one config on this evaluator's
        stream, computed on its device: cycles, bottleneck resource,
        latency share, roofline position —
        `repro_torch.obs.attribution.CostExplanation` (its `.table()`
        renders the paper-style breakdown)."""
        from repro_torch.obs.attribution import explain_config
        return explain_config(cfg, self.stream, hw=self.hw,
                              peak_weight_bits=self.peak_weight_bits,
                              peak_input_bits=self.peak_input_bits,
                              area_budget=self.area_budget,
                              device=self.device)

    # ------------------------------------------------------- shard merging
    def cache_export(self) -> Dict[bytes, Tuple[float, float]]:
        """Snapshot of the raw-metric cache: content-addressed row key ->
        (gops, area), host values only.  Keys are pure functions of config
        content, independent of scoring order, worker, device or shard, so
        two evaluator shards that score the same config produce the same
        key and the same value, and exports merge without conflicts."""
        return self._cache.export_bytes()

    def cache_merge(self, exported: Dict[bytes, Tuple[float, float]]) -> int:
        """Fold a worker shard's `cache_export` into this evaluator.

        First-writer-wins per key; keys are content-addressed and values
        deterministic, so the merged values do not depend on merge order or
        shard count (only LRU recency does).  Returns the number of new
        entries.  The hit/miss counters do not move (a merge scores
        nothing)."""
        return self._cache.merge_bytes(exported)

    # ---------------------------------------------------------------- stats
    @property
    def cache_hits(self) -> int:
        return self._cache.hits

    @property
    def cache_misses(self) -> int:
        return self._cache.misses

    @property
    def cache_evictions(self) -> int:
        return self._cache.evictions

    def stats(self) -> Dict[str, int]:
        return {"batches": self.n_batches, "scored": self.n_scored,
                "cache_hits": self._cache.hits,
                "cache_misses": self._cache.misses,
                "cache_evictions": self._cache.evictions,
                "dedup_skipped": self.dedup_skipped,
                "cache_size": len(self._cache)}


class FunctionEvaluator:
    """Pool interface + LRU memoization over a scalar score function.

    Adapts expensive per-config scorers (one dry-run per point of the
    execution space) to the engines' search loop.  `hw`/peaks default to
    neutral values so generic engine code can read them.

    When the underlying scorer can handle a whole pool at once, pass
    `batch_score_fn(configs) -> sequence of floats`: the cache-missing
    subset of each pool is then scored in ONE call instead of one call per
    config.  `score_fn` remains the scalar fallback/reference.
    """

    def __init__(self, score_fn: Callable[[Any], float],
                 cache_size: int = 1 << 12,
                 batch_score_fn: Optional[
                     Callable[[Sequence[Any]], Sequence[float]]] = None):
        self.score_fn = score_fn
        self.batch_score_fn = batch_score_fn
        self.hw = None
        self.peak_weight_bits = 0
        self.peak_input_bits = 0
        self._cache = _LRU(cache_size)
        self.n_scored = 0
        self.n_batches = 0

    def __call__(self, pool: Sequence[Any]) -> np.ndarray:
        pool = list(pool)
        keys = [config_key(cfg) for cfg in pool]
        vals: Dict[Tuple, float] = {}
        miss_seen = set()
        miss_keys: List[Tuple] = []
        miss_cfgs: List[Any] = []
        for k, cfg in zip(keys, pool):
            if k in vals or k in miss_seen:
                continue
            hit = self._cache.get(k)
            if hit is not None:
                vals[k] = hit
            else:
                miss_seen.add(k)
                miss_keys.append(k)
                miss_cfgs.append(cfg)
        if miss_cfgs:
            if self.batch_score_fn is not None:
                scores = [float(s) for s in self.batch_score_fn(miss_cfgs)]
                if len(scores) != len(miss_cfgs):
                    raise ValueError(
                        f"batch_score_fn returned {len(scores)} scores for "
                        f"{len(miss_cfgs)} configs")
                self.n_batches += 1
            else:
                scores = [float(self.score_fn(cfg)) for cfg in miss_cfgs]
            self.n_scored += len(miss_cfgs)
            for k, s in zip(miss_keys, scores):
                self._cache.put(k, s)
                vals[k] = s
        return np.asarray([vals[k] for k in keys], dtype=np.float64)

    def score_one(self, cfg: Any) -> float:
        return float(self([cfg])[0])

    def cache_export(self) -> Dict[Tuple, float]:
        """Shard-safe cache snapshot (config-content key -> score)."""
        return dict(self._cache.data)

    def cache_merge(self, exported: Dict[Tuple, float]) -> int:
        """Fold another FunctionEvaluator shard's export in (first-writer-
        wins per content key; values are deterministic so order is moot)."""
        data = self._cache.data
        new = 0
        for k, v in exported.items():
            if k not in data:
                data[k] = v
                new += 1
        self._cache.trim()
        return new

    def stats(self) -> Dict[str, int]:
        return {"scored": self.n_scored, "cache_hits": self._cache.hits,
                "cache_misses": self._cache.misses}
