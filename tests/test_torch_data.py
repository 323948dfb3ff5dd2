"""The port's synthetic data pipeline (`repro_torch.data`) against the JAX
package's (`repro.data`, numpy too): the same tokens bit for bit for every
(seed, step, shard), the iterator's order, its resume from a step and its
extras."""

import numpy as np
import pytest

from repro.data import SyntheticLMDataset as RefDataset
from repro.data import make_batch_iterator as ref_iterator
from repro_torch.data import SyntheticLMDataset, make_batch_iterator


@pytest.mark.parametrize("seed,step,shard,n_shards", [
    (0, 0, 0, 1), (0, 7, 0, 1), (1, 3, 2, 4), (123, 1000, 1, 2),
    (5, 12, 3, 4)])
@pytest.mark.parametrize("vocab,seq,batch", [(101, 8, 4),
                                              (151936, 64, 8)])
def test_tokens_are_the_references(seed, step, shard, n_shards, vocab, seq,
                                   batch):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    got = SyntheticLMDataset(**kw).shard_batch(step, shard, n_shards)
    want = RefDataset(**kw).shard_batch(step, shard, n_shards)
    assert got.keys() == want.keys() == {"tokens"}
    assert got["tokens"].dtype == want["tokens"].dtype == np.int32
    assert got["tokens"].tobytes() == want["tokens"].tobytes()
    assert got["tokens"].shape == (batch // n_shards, seq)
    assert 0 <= got["tokens"].min() and got["tokens"].max() < vocab


def test_shards_make_up_no_global_batch_of_their_own():
    """`global_batch_at` is shard 0 of 1, a function of (seed, step)."""
    ds = SyntheticLMDataset(vocab_size=97, seq_len=6, global_batch=4, seed=2)
    assert np.array_equal(ds.global_batch_at(3)["tokens"],
                          ds.shard_batch(3, 0, 1)["tokens"])
    assert not np.array_equal(ds.global_batch_at(3)["tokens"],
                              ds.global_batch_at(4)["tokens"])


def test_iterator_prefetch_and_order():
    """Twin of `tests/test_substrate.py::test_iterator_prefetch_and_order`,
    and the same batches as the reference's iterator."""
    ds = SyntheticLMDataset(vocab_size=101, seq_len=8, global_batch=4,
                            seed=1)
    it = make_batch_iterator(ds, start_step=3)
    ref = ref_iterator(RefDataset(vocab_size=101, seq_len=8, global_batch=4,
                                  seed=1), start_step=3)
    for step in (3, 4, 5):
        b = next(it)
        np.testing.assert_array_equal(b["tokens"],
                                      ds.global_batch_at(step)["tokens"])
        np.testing.assert_array_equal(b["tokens"], next(ref)["tokens"])


def test_iterator_resumes_and_feeds_extras():
    """A resumed iterator (from `start_step`) continues the stream, and
    `extras_fn(step)` is merged into each batch in step order."""
    ds = SyntheticLMDataset(vocab_size=50, seq_len=5, global_batch=2, seed=0)
    full = make_batch_iterator(ds, extras_fn=lambda s: {"step": np.int64(s)})
    first = [next(full) for _ in range(6)]
    resumed = make_batch_iterator(ds, start_step=4)
    for want in first[4:]:
        np.testing.assert_array_equal(next(resumed)["tokens"],
                                      want["tokens"])
    assert [int(b["step"]) for b in first] == list(range(6))
