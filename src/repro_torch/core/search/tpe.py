"""Tree-structured Parzen Estimator engine over the power-of-two grid.

Classic TPE (Bergstra et al. 2011) models *p(x | good)* and *p(x | bad)*
instead of *p(score | x)*: observations are split at the `gamma` score
quantile, a density is fit per dimension to each side, candidates are drawn
from the good-side density, and the batch with the best expected-improvement
proxy l(x)/g(x) is proposed.  Every axis of the accelerator space is a
small *ordered* power-of-two grid, so the per-dimension densities here are
smoothed categoricals over `SpaceCodec` int64 index columns:

  * counts over the observed indices of the good / bad split,
  * a discrete triangular kernel (`smooth` mass to each grid neighbour —
    adjacent power-of-two values are genuinely similar designs, so
    observing 64 should also raise the density at 32 and 128),
  * a uniform Laplace prior (`prior_weight`) so unseen values keep
    nonzero sampling probability.

Proposals stay fully batched: `candidates` rows are drawn from the good
density in one vectorized pass, ranked by sum_j log l_j - log g_j, and the
top `batch` are validity-repaired (`repair_for_peaks_many`) and scored in
ONE Evaluator call — the ask/tell contract of every other engine, which is
exactly what makes TPE pay off when one score is expensive (one XLA
compile per point in `autotune_search`).

The engine is deterministic given its seed and serializes its full search
state — the observation history IS the model — via `state_dict` /
`load_state` for mid-study checkpointing.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.search.base import (Optimizer, codec_for,
                                          pack_config, repair_many_with,
                                          repair_with, unpack_config)

__all__ = ["TPEOptimizer"]


class TPEOptimizer(Optimizer):
    """Per-dimension kernel-density TPE on codec index columns.

    `startup_rounds` uniform-random (repaired) batches seed the model;
    after that every round draws `candidates` rows from the good-side
    density and proposes the `batch` best by EI ratio.  `gamma` is the
    good-quantile, `smooth` the neighbour-kernel mass, `prior_weight` the
    Laplace prior."""

    name = "tpe"

    def __init__(self, space, evaluator, *, seed: int = 0,
                 max_rounds: int = 30, batch: int = 16,
                 startup_rounds: int = 2, gamma: float = 0.25,
                 candidates: int = 256, smooth: float = 0.25,
                 prior_weight: float = 1.0, repair: bool = True):
        super().__init__()
        self.space = space
        self.evaluator = evaluator
        self.max_rounds = max_rounds
        self.batch = max(int(batch), 1)
        self.startup_rounds = max(int(startup_rounds), 1)
        self.gamma = float(gamma)
        self.candidates = max(int(candidates), self.batch)
        self.smooth = float(smooth)
        self.prior_weight = float(prior_weight)
        self.repair = repair
        self.rng = np.random.default_rng(seed)
        self.codec = codec_for(space)
        self._obs_idx: Optional[np.ndarray] = None      # [n, V]
        self._obs_score: Optional[np.ndarray] = None    # [n], -inf = invalid
        self._cand_idx: Optional[np.ndarray] = None     # pool awaiting observe

    # ------------------------------------------------------------- propose
    def propose(self) -> List[Any]:
        if self.rounds < self.startup_rounds or self._n_informative() < max(
                self.batch, 4):
            idx = self.codec.sample_indices(self.rng, self.batch)
        else:
            idx = self._sample_guided()
        return self._materialize(idx)

    def _n_informative(self) -> int:
        if self._obs_score is None:
            return 0
        return int(np.isfinite(self._obs_score).sum())

    def _sample_guided(self) -> np.ndarray:
        keep = np.isfinite(self._obs_score)
        obs = self._obs_idx[keep]
        sc = self._obs_score[keep]
        n_good = max(1, int(np.ceil(self.gamma * obs.shape[0])))
        order = np.argsort(-sc, kind="stable")
        good = obs[order[:n_good]]
        bad = obs[order[n_good:]]
        if bad.shape[0] == 0:            # degenerate split: uniform contrast
            bad = obs
        cand = np.empty((self.candidates, self.codec.n_vars), dtype=np.int64)
        ei = np.zeros(self.candidates, dtype=np.float64)
        for j in range(self.codec.n_vars):
            size = int(self.codec.sizes[j])
            lp = self._pmf(good[:, j], size)
            gp = self._pmf(bad[:, j], size)
            col = self.rng.choice(size, size=self.candidates, p=lp)
            cand[:, j] = col
            ei += np.log(lp[col]) - np.log(gp[col])
        top = np.argsort(-ei, kind="stable")[:self.batch]
        return cand[top]

    def _pmf(self, col: np.ndarray, size: int) -> np.ndarray:
        counts = np.bincount(col, minlength=size).astype(np.float64)
        if size > 1 and self.smooth > 0:
            # discrete triangular kernel: the grid is ordered (powers of
            # two), so mass bleeds to each value's neighbours
            spread = np.zeros_like(counts)
            spread[:-1] += self.smooth * counts[1:]
            spread[1:] += self.smooth * counts[:-1]
            counts = counts + spread
        counts += self.prior_weight
        return counts / counts.sum()

    def _materialize(self, idx: np.ndarray):
        """Index rows -> (repaired) pool; remembers the post-repair indices
        so `observe` records what was actually scored."""
        if hasattr(self.space, "decode_batch"):
            batch = self.space.decode_batch(idx)
            if not self.repair:
                self._cand_idx = idx
                return batch
            repaired = repair_many_with(self.space, self.evaluator, batch)
            if repaired is not None:
                self._cand_idx = self.space.encode_batch(repaired)
                return repaired
        cfgs = self.codec.decode(idx)
        if self.repair:
            cfgs = [repair_with(self.space, self.evaluator, c) for c in cfgs]
        self._cand_idx = self.codec.encode(cfgs)
        return cfgs

    # ------------------------------------------------------------- observe
    def observe(self, pool: Sequence[Any], scores: np.ndarray) -> None:
        scores = self._scalar(scores)          # non-finite -> -inf
        self._track_best(pool, scores)
        if self._cand_idx is not None and len(self._cand_idx) == len(scores):
            idx = self._cand_idx
        else:                                  # externally driven pool
            idx = self._encode_pool(pool)
        self._cand_idx = None
        if self._obs_idx is None:
            self._obs_idx, self._obs_score = idx, scores
        else:
            self._obs_idx = np.vstack([self._obs_idx, idx])
            self._obs_score = np.concatenate([self._obs_score, scores])
        self.rounds += 1
        self.history.append((self.best, self.best_perf))

    def _encode_pool(self, pool) -> np.ndarray:
        if hasattr(self.space, "encode_batch") and hasattr(pool, "take"):
            return self.space.encode_batch(pool)
        return self.codec.encode(list(pool))

    @property
    def done(self) -> bool:
        return self.rounds >= self.max_rounds

    # ----------------------------------------------------- state round-trip
    def state_dict(self) -> Dict:
        return {
            "engine": self.name,
            "rounds": int(self.rounds),
            "obs_idx": (self._obs_idx.tolist()
                        if self._obs_idx is not None else None),
            "obs_score": ([float(s) for s in self._obs_score]
                          if self._obs_score is not None else None),
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
        self._obs_idx = (np.asarray(state["obs_idx"], dtype=np.int64)
                         if state["obs_idx"] is not None else None)
        self._obs_score = (np.asarray(state["obs_score"], dtype=np.float64)
                           if state["obs_score"] is not None else None)
        self.best = (unpack_config(self.codec, state["best"])
                     if state["best"] is not None else None)
        self.best_perf = float(state["best_perf"])
        self.history = [(unpack_config(self.codec, row), float(p))
                        for row, p in state["history"]]
        self.rng.bit_generator.state = state["rng"]
        self._cand_idx = None
