"""Genetic / evolutionary search over power-of-two design domains.

The population lives as a struct-of-arrays index matrix [population, V]
(`SpaceCodec`), so selection, uniform crossover, and random-reset mutation
are pure vectorized numpy — and on array-capable spaces the generation is
scored as a `ConfigBatch` (one batched Evaluator call, no dataclasses
materialized).

  * tournament selection (size `tournament`) over the scored generation
  * uniform crossover between parent pairs
  * per-gene random-reset mutation with prob `p_mut`
  * elitism: the top `elite` individuals survive unchanged

Crossover and mutation are **constraint-aware**: both the initial
population and every generation of offspring are routed through the
space's `repair_for_peaks` (Eq. 11/13 buffer floors + area budget), so
children spend the evaluation budget inside the feasible region instead of
scoring 0 GOPS and dying to selection pressure alone.  Pass
``repair=False`` to recover the selection-pressure-only behaviour.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

from repro_torch.core.search.base import (Optimizer, codec_for,
                                          repair_many_with, repair_with)

__all__ = ["GeneticOptimizer"]


class GeneticOptimizer(Optimizer):
    name = "genetic"

    def __init__(self, space, evaluator, *, seed: int = 0,
                 max_rounds: int = 30, population: int = 48, elite: int = 4,
                 tournament: int = 3, p_mut: float = 0.15,
                 p_cross: float = 0.9, repair: bool = True):
        super().__init__()
        self.space = space
        self.evaluator = evaluator
        self.max_rounds = max_rounds          # generations
        self.population = max(population, 4)
        self.elite = min(elite, self.population // 2)
        self.tournament = tournament
        self.p_mut = p_mut
        self.p_cross = p_cross
        self.repair = repair
        self.rng = np.random.default_rng(seed)
        self.codec = codec_for(space)
        self._pop_idx: Optional[np.ndarray] = None    # [P, V]
        self._pop_perf: Optional[np.ndarray] = None
        self._cand_idx: Optional[np.ndarray] = None

    def propose(self) -> List[Any]:
        if self._pop_idx is None:
            seeds = [repair_with(self.space, self.evaluator,
                                 self.space.sample(self.rng))
                     for _ in range(self.population)]
            self._cand_idx = self.codec.encode(seeds)
            return seeds
        self._cand_idx, configs = self._next_generation()
        return configs

    def _select(self, n: int) -> np.ndarray:
        """Tournament selection: n row indices into the current population."""
        entrants = self.rng.integers(self.population,
                                     size=(n, self.tournament))
        return entrants[np.arange(n),
                        np.argmax(self._pop_perf[entrants], axis=1)]

    def _next_generation(self):
        """(index array [P, V], pool) for the next generation.

        Constraint-aware offspring: crossover/mutation products are
        repaired onto the Eq. 11/13 buffer floors and into the area budget
        (no-op for spaces without `repair_for_peaks`).  On array-capable
        spaces the whole generation — repair included — stays index/array
        native (`repair_for_peaks_many` on a `ConfigBatch`); the scalar
        per-offspring loop is the fallback and the reference.
        """
        n_child = self.population - self.elite
        pa = self._pop_idx[self._select(n_child)]
        pb = self._pop_idx[self._select(n_child)]
        cross = (self.rng.random((n_child, 1)) < self.p_cross)
        gene_mask = self.rng.random(pa.shape) < 0.5
        children = np.where(cross & gene_mask, pb, pa)
        children = self.codec.mutate_indices(self.rng, children, self.p_mut)
        if self.repair:
            children = self._repair_indices(children)
        elite_idx = self._pop_idx[np.argsort(-self._pop_perf)[:self.elite]]
        pop_idx = np.vstack([elite_idx, children])
        if hasattr(self.space, "decode_batch"):
            return pop_idx, self.space.decode_batch(pop_idx)
        return pop_idx, self.codec.decode(pop_idx)

    def _repair_indices(self, idx: np.ndarray) -> np.ndarray:
        """Route an index population through the space's validity repair."""
        if hasattr(self.space, "decode_batch"):
            repaired = repair_many_with(self.space, self.evaluator,
                                        self.space.decode_batch(idx))
            if repaired is not None:
                return self.space.encode_batch(repaired)
        cfgs = [repair_with(self.space, self.evaluator, cfg)
                for cfg in self.codec.decode(idx)]
        return self.codec.encode(cfgs)

    def observe(self, pool: Sequence[Any], scores: np.ndarray) -> None:
        scores = self._scalar(scores)
        self._track_best(pool, scores)
        if self._pop_idx is not None:
            self.rounds += 1
        self._pop_idx = self._cand_idx
        self._pop_perf = scores
        self.history.append((self.best, self.best_perf))

    @property
    def done(self) -> bool:
        return self.rounds >= self.max_rounds
