"""NSGA-II: elitist non-dominated sorting genetic algorithm (Deb et al.
2002) over the accelerator index space.

Where the other engines chase one scalarized number, NSGA-II ranks the
population by Pareto dominance over the raw `[N, M]` objective rows —
either the vector values a `ParetoObjective` evaluator already returns
(`observes_vector`: the driver hands the rows straight through), or, for
legacy scalar evaluators, the (GOPS, -area) columns recovered for free
from the Evaluator's raw-metric cache via `score_with_area`.  Selection is
the canonical (mu + lambda) loop:

  * fast non-dominated sort with Deb's constraint-domination (feasible
    always beats infeasible; `feasible_mask` / zeroed-perf witness),
  * crowding distance as the within-front tie-breaker,
  * binary tournament on (rank, crowding) to pick parents,
  * uniform crossover + random-reset mutation, offspring routed through
    `repair_for_peaks_many` so the population stays on the Eq. 11/13
    buffer floors instead of drifting into the 0-GOPS desert.

The scalarized signal still feeds `best`/`history` (so `SearchResult`
merging, restarts, and the Study bookkeeping behave like every other
engine); the front itself is `front_indices()` / the evaluated log.  The
engine is deterministic given its seed and serializes its generation state
(population, objective rows, feasibility, RNG) via `state_dict` /
`load_state` for mid-generation checkpointing.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.search.base import (Optimizer, codec_for,
                                          pack_config, repair_many_with,
                                          repair_with, unpack_config)

__all__ = ["NSGA2Optimizer"]

# stand-in for +-inf in objective rows: keeps domination/crowding math
# NaN-free while preserving the ordering of genuinely observed values
_BIG = 1e30


class NSGA2Optimizer(Optimizer):
    name = "nsga2"
    observes_vector = True

    def __init__(self, space, evaluator, *, seed: int = 0,
                 max_rounds: int = 30, population: int = 32,
                 p_mut: float = 0.15, p_cross: float = 0.9,
                 repair: bool = True):
        super().__init__()
        self.space = space
        self.evaluator = evaluator
        self.max_rounds = max_rounds          # generations
        self.population = max(int(population), 4)
        self.p_mut = p_mut
        self.p_cross = p_cross
        self.repair = repair
        self.rng = np.random.default_rng(seed)
        self.codec = codec_for(space)
        self._pop_idx: Optional[np.ndarray] = None    # [P, V] survivors
        self._pop_F: Optional[np.ndarray] = None      # [P, M] maximize rows
        self._pop_feas: Optional[np.ndarray] = None   # [P] bool
        self._cand_idx: Optional[np.ndarray] = None

    # ------------------------------------------------------------- propose
    def propose(self) -> List[Any]:
        if self._pop_idx is None:
            idx = self.codec.sample_indices(self.rng, self.population)
        else:
            idx = self._offspring()
        if self.repair:
            idx = self._repair_indices(idx)
        self._cand_idx = idx
        if hasattr(self.space, "decode_batch"):
            return self.space.decode_batch(idx)
        return self.codec.decode(idx)

    def _offspring(self) -> np.ndarray:
        rank, crowd = self._rank_and_crowding(self._pop_F, self._pop_feas)
        n = self.population
        pa = self._pop_idx[self._tournament(rank, crowd, n)]
        pb = self._pop_idx[self._tournament(rank, crowd, n)]
        cross = self.rng.random((n, 1)) < self.p_cross
        gene_mask = self.rng.random(pa.shape) < 0.5
        children = np.where(cross & gene_mask, pb, pa)
        return self.codec.mutate_indices(self.rng, children, self.p_mut)

    def _tournament(self, rank: np.ndarray, crowd: np.ndarray,
                    n: int) -> np.ndarray:
        """Binary tournament on (rank asc, crowding desc)."""
        a = self.rng.integers(len(rank), size=n)
        b = self.rng.integers(len(rank), size=n)
        a_wins = (rank[a] < rank[b]) | ((rank[a] == rank[b])
                                        & (crowd[a] > crowd[b]))
        return np.where(a_wins, a, b)

    def _repair_indices(self, idx: np.ndarray) -> np.ndarray:
        if hasattr(self.space, "decode_batch"):
            repaired = repair_many_with(self.space, self.evaluator,
                                        self.space.decode_batch(idx))
            if repaired is not None:
                return self.space.encode_batch(repaired)
        cfgs = [repair_with(self.space, self.evaluator, cfg)
                for cfg in self.codec.decode(idx)]
        return self.codec.encode(cfgs)

    # ------------------------------------------------------------- observe
    def observe(self, pool: Sequence[Any], scores: np.ndarray) -> None:
        scores = np.asarray(scores, dtype=np.float64)
        F, feas = self._objective_rows(pool, scores)
        self._track_best(pool, self._scalar(scores))
        if self._cand_idx is not None and len(self._cand_idx) == len(F):
            cand = self._cand_idx
        else:                                  # externally driven pool
            cand = self._encode_pool(pool)
        self._cand_idx = None
        if self._pop_idx is None:              # founding generation
            union_idx, union_F, union_feas = cand, F, feas
        else:                                  # (mu + lambda) elitism
            union_idx = np.vstack([self._pop_idx, cand])
            union_F = np.vstack([self._pop_F, F])
            union_feas = np.concatenate([self._pop_feas, feas])
            self.rounds += 1
        keep = self._environmental_selection(union_F, union_feas)
        self._pop_idx = union_idx[keep]
        self._pop_F = union_F[keep]
        self._pop_feas = union_feas[keep]
        self.history.append((self.best, self.best_perf))

    def _objective_rows(self, pool, scores: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Maximize-oriented [N, M] rows + feasibility for this pool.

        Vector scores pass through (the ParetoObjective convention zeroes
        every infeasible row, and its first maximize column is strictly
        positive on feasible rows — the validity witness).  Scalar
        evaluators with cached raw metrics recover (GOPS, -area) for free
        (`score_with_area` after `__call__` is pure cache hits); anything
        else degrades to single-objective rows, where NSGA-II behaves as a
        plain elitist GA."""
        if scores.ndim == 2 and scores.shape[1] >= 2:
            obj = getattr(self.evaluator, "objective", None)
            witness = int(getattr(obj, "_valid_col", 0) or 0)
            feas = (np.isfinite(scores).all(axis=1)
                    & (scores[:, witness] > 0))
            F = np.nan_to_num(scores, nan=-_BIG, posinf=_BIG, neginf=-_BIG)
            return F, feas
        if hasattr(self.evaluator, "score_with_area"):
            perf, area = self.evaluator.score_with_area(pool)
            feas = np.isfinite(perf) & (perf > 0) & np.isfinite(area)
            F = np.stack([np.nan_to_num(perf, nan=-_BIG, posinf=_BIG,
                                        neginf=-_BIG),
                          -np.nan_to_num(area, nan=_BIG, posinf=_BIG,
                                         neginf=-_BIG)], axis=1)
            return F, feas
        scalar = self._scalar(scores)          # non-finite -> -inf
        feas = np.isfinite(scalar)
        return np.where(feas, scalar, -_BIG)[:, None], feas

    def _encode_pool(self, pool) -> np.ndarray:
        if hasattr(self.space, "encode_batch") and hasattr(pool, "take"):
            return self.space.encode_batch(pool)
        return self.codec.encode(list(pool))

    # -------------------------------------------- non-dominated machinery
    @staticmethod
    def _domination(F: np.ndarray, feas: np.ndarray) -> np.ndarray:
        """[n, n] bool: dom[i, j] = i constraint-dominates j (Deb 2002).

        Feasible always dominates infeasible; same-feasibility pairs fall
        back to Pareto domination on the maximize-oriented rows (among
        infeasible points this keeps selection pressure toward the
        feasible region, e.g. smaller area under an area budget)."""
        ge = (F[:, None, :] >= F[None, :, :]).all(axis=-1)
        gt = (F[:, None, :] > F[None, :, :]).any(axis=-1)
        pareto = ge & gt
        fi, fj = feas[:, None], feas[None, :]
        return (fi & ~fj) | ((fi == fj) & pareto)

    @classmethod
    def _fronts(cls, F: np.ndarray, feas: np.ndarray) -> List[np.ndarray]:
        """Fast non-dominated sort: list of index arrays, best front first."""
        dom = cls._domination(F, feas)
        dominated_by = dom.sum(axis=0).astype(np.int64)   # count over i
        remaining = np.ones(len(F), dtype=bool)
        fronts: List[np.ndarray] = []
        while remaining.any():
            cur = np.flatnonzero(remaining & (dominated_by == 0))
            if cur.size == 0:                  # numeric safety net
                cur = np.flatnonzero(remaining)
            fronts.append(cur)
            remaining[cur] = False
            dominated_by -= dom[cur].sum(axis=0)
        return fronts

    @staticmethod
    def _crowding(F: np.ndarray) -> np.ndarray:
        """Crowding distance of each row within one front (Deb 2002)."""
        n, m = F.shape
        d = np.zeros(n, dtype=np.float64)
        if n <= 2:
            return np.full(n, np.inf)
        for j in range(m):
            order = np.argsort(F[:, j], kind="stable")
            vals = F[order, j]
            span = vals[-1] - vals[0]
            d[order[0]] = d[order[-1]] = np.inf
            if span > 0:
                d[order[1:-1]] += (vals[2:] - vals[:-2]) / span
        return d

    def _rank_and_crowding(self, F: np.ndarray, feas: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
        rank = np.empty(len(F), dtype=np.int64)
        crowd = np.empty(len(F), dtype=np.float64)
        for r, front in enumerate(self._fronts(F, feas)):
            rank[front] = r
            crowd[front] = self._crowding(F[front])
        return rank, crowd

    def _environmental_selection(self, F: np.ndarray,
                                 feas: np.ndarray) -> np.ndarray:
        """Indices of the `population` survivors of a (mu + lambda) union:
        whole fronts in rank order, the split front truncated by crowding
        (stable sort -> deterministic under ties)."""
        keep: List[np.ndarray] = []
        room = min(self.population, len(F))
        for front in self._fronts(F, feas):
            if front.size <= room:
                keep.append(front)
                room -= front.size
                if room == 0:
                    break
            else:
                crowd = self._crowding(F[front])
                order = np.argsort(-crowd, kind="stable")[:room]
                keep.append(front[np.sort(order)])
                room = 0
                break
        return np.concatenate(keep)

    def front_indices(self) -> np.ndarray:
        """Rows of the current population on its first non-dominated front."""
        if self._pop_F is None:
            return np.empty(0, dtype=np.int64)
        return self._fronts(self._pop_F, self._pop_feas)[0]

    def front_configs(self) -> List[Any]:
        """Decoded configs of the current first front (feasible leaders)."""
        idx = self._pop_idx[self.front_indices()] \
            if self._pop_idx is not None else np.empty((0, 0), dtype=np.int64)
        if idx.size == 0:
            return []
        return self.codec.decode(idx)

    @property
    def done(self) -> bool:
        return self.rounds >= self.max_rounds

    # ----------------------------------------------------- state round-trip
    def state_dict(self) -> Dict:
        return {
            "engine": self.name,
            "rounds": int(self.rounds),
            "pop_idx": (self._pop_idx.tolist()
                        if self._pop_idx is not None else None),
            "pop_F": (self._pop_F.tolist()
                      if self._pop_F is not None else None),
            "pop_feas": (self._pop_feas.tolist()
                         if self._pop_feas is not None else None),
            "best": (pack_config(self.codec, self.best)
                     if self.best is not None else None),
            "best_perf": float(self.best_perf),
            "history": [[pack_config(self.codec, c), float(p)]
                        for c, p in self.history],
            "rng": self.rng.bit_generator.state,
        }

    def load_state(self, state: Dict) -> None:
        if state.get("engine") != self.name:
            raise ValueError(f"state is for engine {state.get('engine')!r}, "
                             f"not {self.name!r}")
        self.rounds = int(state["rounds"])
        self._pop_idx = (np.asarray(state["pop_idx"], dtype=np.int64)
                         if state["pop_idx"] is not None else None)
        self._pop_F = (np.asarray(state["pop_F"], dtype=np.float64)
                       if state["pop_F"] is not None else None)
        self._pop_feas = (np.asarray(state["pop_feas"], dtype=bool)
                          if state["pop_feas"] is not None else None)
        self.best = (unpack_config(self.codec, state["best"])
                     if state["best"] is not None else None)
        self.best_perf = float(state["best_perf"])
        self.history = [(unpack_config(self.codec, row), float(p))
                        for row, p in state["history"]]
        self.rng.bit_generator.state = state["rng"]
        self._cand_idx = None
