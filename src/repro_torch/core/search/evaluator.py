"""Shared memoizing evaluator.

`Evaluator` is the accelerator-space scorer: one batched fused-scorer call
per pool, behind a cache keyed by the raw canonical field bytes of each
config, so repeated points — within a run, across rounds, across restarts,
across engines sharing the evaluator — are never re-scored.  It returns the
GOPS of the op stream, zeroed where the area budget or the Eq. 9-13
constraints are violated.

The cache is the vectorized `rowcache.RowHashCache` (a 64-bit row hash over
the canonical field matrix feeding an open-addressed int64 table with
exact-key collision fallback), on the host.  Cache misses go to the one
scorer, `FusedTorchScorer`, on `device` — the GPU unless the caller asks
for the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.costmodel import (AccelConfig, ConfigBatch,
                                        HardwareConstants, OpStream)
from repro_torch.core.search import rowcache
from repro_torch.core.search.rowcache import RowHashCache
from repro_torch.kernels.costmodel import FusedTorchScorer, resolve_device

__all__ = ["Evaluator"]


class Evaluator:
    """Batched, memoizing scorer for accelerator configs on one op stream.

    `evaluator(pool)` returns the [len(pool)] GOPS vector with the area
    budget applied (0.0 on violation) — identical values to scoring the pool
    uncached, in any batch composition.

    Objective/constraint injection (the `repro_torch.dse` facade): pass
    `objective` (an object with `score(metrics) -> [N]`) and/or
    `constraints` (objects with `feasible_mask(batch, metrics) -> bool[N]`)
    to reshape what `evaluator(pool)` hands the engines.  The cache always
    stores the *raw* (GOPS, area) metrics — Eq. 9-13 zeroing only — so one
    cache serves every objective.  With the defaults the output is the
    GOPS vector above.

    A stream the fused scorer does not support (a zero-size kernel or
    stride) raises at construction.
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
                 device="cuda"):
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
        self.scorer = FusedTorchScorer(stream, self.hw, peak_weight_bits,
                                       peak_input_bits, domains=self.domains,
                                       device=self.device)
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
                  device="cuda") -> "Evaluator":
        """Evaluator bound to a DesignSpace's hw constants + area budget."""
        return cls(stream, hw=space.hw,
                   peak_weight_bits=peak_weight_bits,
                   peak_input_bits=peak_input_bits,
                   area_budget=space.area_budget, cache_size=cache_size,
                   objective=objective, constraints=constraints,
                   domains=getattr(space, "domains", None), device=device)

    # -------------------------------------------------------------- scoring
    def __call__(self, pool) -> np.ndarray:
        batch = ConfigBatch.from_configs(pool)
        perf, area = self._metrics_of(batch)
        mask = self.feasible_mask(batch, {"perf": perf, "area": area})
        if self.objective is None:
            return np.where(mask, perf, 0.0)
        metrics = {"perf": np.where(mask, perf, 0.0), "area": area}
        return np.where(mask, self.objective.score(metrics), 0.0)

    def feasible_mask(self, batch, metrics) -> np.ndarray:
        """AND of the area budget and every injected constraint."""
        mask = np.ones(len(batch), dtype=bool)
        if self.area_budget > 0:
            mask &= metrics["area"] <= self.area_budget
        for c in self.constraints:
            mask &= np.asarray(c.feasible_mask(batch, metrics), dtype=bool)
        return mask

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
        probe for the unique rows, one scorer call for the miss set, one
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
            fp, fa = self.scorer.metrics(matrix[miss_rows])
            self.n_batches += 1
            self.n_scored += int(miss_rows.size)
            perf[miss_rows] = fp
            area[miss_rows] = fa
            cache.insert(matrix[miss_rows], hashes[miss_rows],
                         np.stack([fp, fa], axis=1))
        if uniq.size != n:                  # copy duplicates from their rep
            perf = perf[rep]
            area = area[rep]
        return perf, area

    def score_one(self, cfg: AccelConfig) -> float:
        return float(self([cfg])[0])

    # ---------------------------------------------------------------- stats
    @property
    def cache_hits(self) -> int:
        return self._cache.hits

    @property
    def cache_misses(self) -> int:
        return self._cache.misses

    def stats(self) -> Dict[str, int]:
        return {"batches": self.n_batches, "scored": self.n_scored,
                "cache_hits": self._cache.hits,
                "cache_misses": self._cache.misses,
                "cache_evictions": self._cache.evictions,
                "dedup_skipped": self.dedup_skipped,
                "cache_size": len(self._cache)}
