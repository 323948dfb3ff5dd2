"""Multi-step greedy engine (paper §4.3, Algorithm 1) on the Optimizer
interface.

The RNG call sequence (initial valid sample, per-round k-subset variable
choice, pool-cap subsampling) and the pool construction are those of the
JAX package's `GreedyOptimizer`, and the scores are bit-identical, so a run
through `run_search` reproduces its results bit-for-bit at a fixed seed.

    1:  Start with a random initial valid accelerator configuration
    2:  do
    3:      Pool <- [S0]
    4:      Randomly pick k design variables (V0 ... V_{k-1})
    5:      for i <- 0 to k-1 do
    6:          for all S in Pool do
    7:              for all possible values v of V_i do
    8:                  S' <- S with V_i = v
    9:                  Pool <- Pool + [S']
    10:     S_max <- argmax P_S where S in Pool
    11:     dP <- P_Smax - P_S0
    12:     S0 <- S_max
    13: while dP > dP_t
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

from repro_torch.core.search.base import Optimizer, codec_for, repair_with

__all__ = ["GreedyOptimizer"]


class GreedyOptimizer(Optimizer):
    """Algorithm 1.  `k` trades off optimality and per-round cost.

    `patience=1` is the paper-verbatim stopping rule (stop on the first
    round with dP <= dP_t).  Because each round sweeps a *random* k-subset
    of variables, allowing a few unproductive rounds before stopping
    (`patience>1`) explores more variable subsets from the same start; the
    multi-restart driver uses patience=3.
    """

    name = "greedy"

    def __init__(self, space, evaluator, *, k: int = 3,
                 delta_p_threshold: float = 1e-3, max_rounds: int = 40,
                 seed: int = 0, init: Optional[Any] = None,
                 pool_cap: int = 20000, patience: int = 1):
        super().__init__()
        self.space = space
        self.evaluator = evaluator
        self.k = k
        self.delta_p_threshold = delta_p_threshold
        self.max_rounds = max_rounds
        self.pool_cap = pool_cap
        self.patience = patience
        self.rng = np.random.default_rng(seed)
        self.init = init
        self.codec = codec_for(space)
        self._s0: Optional[Any] = None
        self._p0: float = 0.0
        self._stale = 0
        self._finished = False
        self._initialized = False

    # ------------------------------------------------------------- propose
    def propose(self) -> List[Any]:
        if not self._initialized:
            if self.init is not None:
                s0 = self.init
            else:
                # "Start with a random initial *valid* accelerator
                # configuration": valid = area budget + Eq. 9-13 constraints
                # on the target stream.  A repair pass grows buffers to the
                # peak-demand floors (Eq. 11/13) first — pure rejection
                # sampling is hopeless for apps whose peak demands occupy
                # most of the area budget (fasterRCNN, deeplab).
                def _valid(cfg: Any) -> bool:
                    return self.evaluator.score_one(
                        repair_with(self.space, self.evaluator, cfg)) > 0.0
                s0 = self.space.sample(self.rng, validator=_valid)
                s0 = repair_with(self.space, self.evaluator, s0)
            self._s0 = s0
            return [s0]

        variables = list(self.rng.choice(self.space.variables, size=self.k,
                                         replace=False))
        try:
            s0_idx = self.codec.encode([self._s0])
        except (KeyError, TypeError):
            # s0 has out-of-domain fields (e.g. a user init on a restricted
            # space): fall back to the object path, which sweeps around it
            # with dataclasses.replace and leaves the other fields alone
            s0_idx = None

        if s0_idx is not None:
            # Array-native pool construction: same Algorithm-1 pool (same
            # candidate order, same RNG stream, same pool-cap subsample) as
            # the object path below, built by index-matrix ops.  Each
            # variable sweep appends an s-major x domain-order block —
            # exactly lines 5-9's `for s in pool: for v in domain` order.
            pool_idx = s0_idx
            for var in variables:                   # lines 5-9
                j = self.codec.variables.index(var)
                d = int(self.codec.sizes[j])
                block = np.repeat(pool_idx, d, axis=0)
                block[:, j] = np.tile(np.arange(d, dtype=np.int64),
                                      pool_idx.shape[0])
                pool_idx = np.vstack([pool_idx, block])
                if pool_idx.shape[0] > self.pool_cap:   # memory guard
                    sub = self.rng.choice(pool_idx.shape[0] - 1,
                                          size=self.pool_cap - 1,
                                          replace=False) + 1
                    pool_idx = np.vstack([pool_idx[:1], pool_idx[sub]])
            if hasattr(self.space, "decode_batch"):
                return self.space.decode_batch(pool_idx)
            return self.codec.decode(pool_idx)

        pool: List[Any] = [self._s0]
        for var in variables:                       # lines 5-9
            new_pool = list(pool)
            for s in pool:
                for cand in self.space.neighbors_over(s, var):
                    new_pool.append(cand)
            pool = new_pool
            if len(pool) > self.pool_cap:           # memory guard
                # keep S0 plus a uniform subsample; the greedy argmax below
                # is unaffected in expectation and the cap is never hit with
                # the default space at k <= 3.
                idx = self.rng.choice(len(pool) - 1,
                                      size=self.pool_cap - 1,
                                      replace=False) + 1
                pool = [pool[0]] + [pool[i] for i in idx]
        return pool

    # ------------------------------------------------------------- observe
    def observe(self, pool: Sequence[Any], scores: np.ndarray) -> None:
        scores = self._scalar(scores)
        if not self._initialized:
            self._initialized = True
            self._p0 = float(scores[0])
            self.history = [(self._s0, self._p0)]
            self.best, self.best_perf = self._s0, self._p0
            return

        self.rounds += 1
        i_max = int(np.argmax(scores))              # line 10
        delta = float(scores[i_max]) - self._p0     # line 11
        self._s0 = pool[i_max]                      # line 12
        self._p0 = float(scores[i_max])
        self.history.append((self._s0, self._p0))
        self.best, self.best_perf = self._s0, self._p0
        if delta <= self.delta_p_threshold * max(self._p0, 1e-12):  # line 13
            self._stale += 1
            if self._stale >= self.patience:
                self._finished = True
        else:
            self._stale = 0

    @property
    def done(self) -> bool:
        return self._finished or (self._initialized
                                  and self.rounds >= self.max_rounds)
