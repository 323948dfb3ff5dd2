"""Simulated annealing over discrete design spaces.

Runs `chains` independent Metropolis walkers so every round scores one
batched pool of `chains` candidates (one vectorized model call through the
shared Evaluator).  Moves flip a single random variable to a random domain
value; acceptance uses the relative improvement so the schedule is
insensitive to the absolute GOPS scale of the target stream.  Geometric
cooling `T <- alpha * T` from `t0`.

Constraint-violating candidates score 0 and are almost never accepted once
the temperature drops; chains start from validity-repaired samples
(Eq. 11/13 buffer floors + area budget) so they never begin in the
0-GOPS desert.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

from repro_torch.core.search.base import Optimizer, codec_for, repair_with

__all__ = ["AnnealOptimizer"]


class AnnealOptimizer(Optimizer):
    name = "anneal"

    def __init__(self, space, evaluator, *, seed: int = 0,
                 max_rounds: int = 60, chains: int = 8, t0: float = 0.25,
                 alpha: float = 0.93, init: Optional[Any] = None):
        super().__init__()
        self.space = space
        self.evaluator = evaluator
        self.max_rounds = max_rounds
        self.chains = chains
        self.t = t0
        self.alpha = alpha
        self.rng = np.random.default_rng(seed)
        self.codec = codec_for(space)
        self.init = init
        self._cur_idx: Optional[np.ndarray] = None    # [chains, V]
        self._cur_perf: Optional[np.ndarray] = None   # [chains]
        self._cand_idx: Optional[np.ndarray] = None

    def propose(self) -> List[Any]:
        if self._cur_idx is None:
            starts = []
            for i in range(self.chains):
                # one chain starts at `init` (if given); the rest stay random
                # samples so multi-chain diversity survives a seeded start
                if self.init is not None and i == 0:
                    s = self.init
                else:
                    s = self.space.sample(self.rng)
                s = repair_with(self.space, self.evaluator, s)
                starts.append(self.codec.snap(s))
            self._cand_idx = self.codec.encode(starts)
            return starts
        # one-variable move per chain, vectorized on the index array
        idx = self._cur_idx.copy()
        rows = np.arange(self.chains)
        cols = self.rng.integers(self.codec.n_vars, size=self.chains)
        idx[rows, cols] = self.rng.integers(self.codec.sizes[cols])
        self._cand_idx = idx
        # array-native pool on spaces that support it (no dataclasses)
        if hasattr(self.space, "decode_batch"):
            return self.space.decode_batch(idx)
        return self.codec.decode(idx)

    def observe(self, pool: Sequence[Any], scores: np.ndarray) -> None:
        scores = self._scalar(scores)
        self._track_best(pool, scores)
        if self._cur_idx is None:
            self._cur_idx = self._cand_idx
            self._cur_perf = scores
            self.history.append((self.best, self.best_perf))
            return
        self.rounds += 1
        delta = scores - self._cur_perf
        scale = np.maximum(self._cur_perf, 1e-9) * max(self.t, 1e-9)
        accept = (delta >= 0) | (self.rng.random(self.chains)
                                 < np.exp(np.minimum(delta / scale, 0.0)))
        self._cur_idx = np.where(accept[:, None], self._cand_idx,
                                 self._cur_idx)
        self._cur_perf = np.where(accept, scores, self._cur_perf)
        self.t *= self.alpha
        self.history.append((self.best, self.best_perf))

    @property
    def done(self) -> bool:
        return self.rounds >= self.max_rounds
