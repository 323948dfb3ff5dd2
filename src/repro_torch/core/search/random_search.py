"""Pure random search — the baseline every other engine must beat.

Each round draws one uniform batch over the domains (struct-of-arrays via
`SpaceCodec`), applies the same validity repair the other engines get for
their starting points (otherwise virtually every draw lands in the 0-GOPS
constraint desert and the baseline is vacuous), and scores it in one
batched Evaluator call.

On spaces with an array decode (`decode_batch`, i.e. the accelerator
`DesignSpace`) the whole round stays array-native: indices -> `ConfigBatch`
-> batched `repair_for_peaks_many` -> Evaluator, with no dataclass
materialized; the repaired population is bit-identical to the per-config
scalar path.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np

from repro_torch.core.search.base import (Optimizer, codec_for,
                                          repair_many_with, repair_with)

__all__ = ["RandomSearchOptimizer"]


class RandomSearchOptimizer(Optimizer):
    name = "random"

    def __init__(self, space, evaluator, *, seed: int = 0,
                 max_rounds: int = 10, batch: int = 64):
        super().__init__()
        self.space = space
        self.evaluator = evaluator
        self.max_rounds = max_rounds
        self.batch = batch
        self.rng = np.random.default_rng(seed)
        self.codec = codec_for(space)

    def propose(self) -> List[Any]:
        idx = self.codec.sample_indices(self.rng, self.batch)
        if hasattr(self.space, "decode_batch"):
            batch = self.space.decode_batch(idx)
            repaired = repair_many_with(self.space, self.evaluator, batch)
            if repaired is not None:
                return repaired
            # space decodes to arrays but has no batched repair: fall back
            # to the scalar repair below rather than skipping repair
        draws = self.codec.decode(idx)
        return [repair_with(self.space, self.evaluator, c) for c in draws]

    def observe(self, pool: Sequence[Any], scores: np.ndarray) -> None:
        self._track_best(pool, self._scalar(scores))
        self.rounds += 1
        self.history.append((self.best, self.best_perf))

    @property
    def done(self) -> bool:
        return self.rounds >= self.max_rounds
