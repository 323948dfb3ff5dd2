"""Deterministic synthetic LM data pipeline (numpy only), the twin of
`repro.data.pipeline`: the same tokens for every (seed, step, shard).

Design goals (the fault-tolerance story depends on all three):

  * **Step-keyed determinism** — batch contents are a pure function of
    (seed, step, shard), so restarting from a checkpoint at step k
    reproduces the exact token stream with no data-loader state to save.
  * **Shard re-assignability** — any host can materialize any shard: when
    a node fails and the mesh shrinks (the reference's
    launch/elastic.py), surviving hosts recompute the lost shards with no
    data loss.
  * **Prefetch** — a background thread keeps `prefetch` batches ahead so
    host-side generation overlaps device compute.

The synthetic stream is a Zipf-distributed token source with a Markov
flavor (next token depends on the previous one), which keeps the
cross-entropy learnable — loss decreases measurably during the example
runs, unlike uniform noise.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = ["SyntheticLMDataset", "make_batch_iterator"]


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2

    def _rng_for(self, step: int, shard: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))

    def shard_batch(self, step: int, shard: int, n_shards: int
                    ) -> Dict[str, np.ndarray]:
        """Materialize shard `shard` of `n_shards` for `step` (pure)."""
        assert self.global_batch % n_shards == 0
        b = self.global_batch // n_shards
        rng = self._rng_for(step, shard)
        # Zipf body + Markov mixing: tok[t] = (tok[t-1]*p + z[t]) % V
        z = rng.zipf(self.zipf_a, size=(b, self.seq_len)).astype(np.int64)
        z = np.minimum(z, self.vocab_size - 1)
        mix = rng.integers(1, 7)
        tokens = np.empty((b, self.seq_len), np.int32)
        tokens[:, 0] = z[:, 0] % self.vocab_size
        for t in range(1, self.seq_len):
            tokens[:, t] = (tokens[:, t - 1] * mix + z[:, t]) \
                % self.vocab_size
        return {"tokens": tokens}

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        return self.shard_batch(step, 0, 1)


def make_batch_iterator(ds: SyntheticLMDataset, start_step: int = 0,
                        prefetch: int = 2,
                        extras_fn=None) -> Iterator[Dict[str, np.ndarray]]:
    """Prefetching iterator over global batches from `start_step`."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            batch = ds.global_batch_at(step)
            if extras_fn is not None:
                batch.update(extras_fn(step))
            q.put((step, batch))
            step += 1

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            _, batch = q.get()
            yield batch
    finally:
        stop.set()
