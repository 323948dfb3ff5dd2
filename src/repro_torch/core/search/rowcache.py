"""Vectorized open-addressed row cache for `[N, F]` int64 config matrices.

The Evaluator's memo used to key a Python dict with one `row.tobytes()`
per config — at 4096-config pools the keying loop alone costs more than
the fused cost model.  This module replaces it with array machinery:

  `hash_rows`      — a numpy-vectorized splitmix64-style 64-bit hash over
                     the whole matrix (one fused pass per column, no
                     per-row Python).  Module-level on purpose: tests
                     monkeypatch it to force collisions.
  `first_occurrence` — exact in-pool dedup driven by the hashes (only
                     same-hash groups fall back to byte keys), preserving
                     the Evaluator contract that in-pool duplicates are
                     counted neither as cache hits nor misses.
  `RowHashCache`   — an open-addressed int64 hash table (linear probing,
                     load factor <= 0.5, lazy power-of-two growth) storing
                     the full key rows for exact collision fallback plus a
                     `[cap, V]` float64 value block.  Lookups are a batched
                     gather, inserts one vectorized scatter with
                     winner-per-slot claiming; eviction is a rebuild that
                     keeps the most recently touched `maxsize` rows.

Collisions are *correct*, not just unlikely: every hash match is verified
against the stored key row before it counts as a hit, and colliding keys
linear-probe to their own slots — `tests/test_fused_eval.py` pins this by
monkeypatching `hash_rows` to a constant.

The wire format of `Evaluator.cache_export`/`cache_merge` (raw row bytes
-> value tuple) is unchanged; `export_bytes`/`merge_bytes` translate at
the boundary so parallel-study shard merges are oblivious to the table.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["hash_rows", "first_occurrence", "RowHashCache"]

_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_PHI = np.uint64(0x9E3779B97F4A7C15)
_SEED = np.uint64(0x243F6A8885A308D3)
_S30 = np.uint64(30)
_S27 = np.uint64(27)
_S31 = np.uint64(31)


def hash_rows(matrix: np.ndarray) -> np.ndarray:
    """[N, F] int64 matrix -> [N] uint64 row hashes (splitmix64 chain).

    Pure function of row content (column order is the canonical
    `_CFG_FIELDS` order), so hashes are shard-safe the same way the
    `tobytes()` keys are.  Vectorized down the columns; uint64 arithmetic
    wraps mod 2^64 silently, which is exactly the mixing we want."""
    m = np.ascontiguousarray(matrix, dtype=np.int64).view(np.uint64)
    n, ncols = m.shape
    salts = _PHI * np.arange(1, ncols + 1, dtype=np.uint64)
    h = np.full(n, _SEED, dtype=np.uint64)
    for j in range(ncols):
        h = h + (m[:, j] + salts[j])
        h = (h ^ (h >> _S30)) * _M1
        h = (h ^ (h >> _S27)) * _M2
        h = h ^ (h >> _S31)
    return h


def first_occurrence(matrix: np.ndarray, hashes: np.ndarray) -> np.ndarray:
    """rep[i] = smallest j with matrix[j] == matrix[i] (exactly, all F
    columns).  Rows are grouped by hash first; only groups with two or
    more members (in-pool duplicates or true collisions) fall back to a
    byte-keyed scan, so typical pools stay fully vectorized."""
    n = matrix.shape[0]
    rep = np.arange(n, dtype=np.int64)
    if n < 2:
        return rep
    order = np.argsort(hashes, kind="stable")
    hs = hashes[order]
    adj_dup = hs[1:] == hs[:-1]
    if not adj_dup.any():
        return rep
    starts = np.flatnonzero(np.r_[True, ~adj_dup])
    ends = np.r_[starts[1:], n]
    for g in np.flatnonzero(ends - starts > 1):
        rows = order[starts[g]:ends[g]]   # ascending (stable sort)
        seen: Dict[bytes, int] = {}
        for i in rows.tolist():
            k = matrix[i].tobytes()
            j = seen.setdefault(k, i)
            if j != i:
                rep[i] = j
    return rep


class RowHashCache:
    """Open-addressed (row-key -> float64[V] values) map with LRU eviction.

    Invariants: capacity is a power of two; live load factor stays <= 0.5
    (probe chains stay short); `insert` callers guarantee the batch has
    unique keys none of which are present (what `Evaluator._metrics_of`'s
    dedup + lookup establishes).  `hits`/`misses` are owned by the caller
    — `lookup` only touches recency stamps — mirroring how the old `_LRU`
    let `cache_merge` bypass the counters."""

    def __init__(self, ncols: int, maxsize: int, values: int = 2,
                 init_capacity: int = 1024):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        self.ncols = int(ncols)
        self.maxsize = int(maxsize)
        self.nvalues = int(values)
        self.size = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._stamp = 0
        cap = 1
        while cap < init_capacity:
            cap <<= 1
        self._alloc(cap)

    def _alloc(self, cap: int) -> None:
        self._cap = cap
        self._hash = np.zeros(cap, dtype=np.uint64)
        self._used = np.zeros(cap, dtype=bool)
        self._key = np.zeros((cap, self.ncols), dtype=np.int64)
        self._val = np.zeros((cap, self.nvalues), dtype=np.float64)
        self._age = np.zeros(cap, dtype=np.int64)

    # ------------------------------------------------------------- probing
    def lookup(self, matrix: np.ndarray, hashes: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(found[N] bool, values[N, V]) — values rows are zero where not
        found.  Hash matches are verified against the stored key row, so a
        colliding key simply probes past its impostor."""
        n = matrix.shape[0]
        found = np.zeros(n, dtype=bool)
        vals = np.zeros((n, self.nvalues), dtype=np.float64)
        if n == 0 or self.size == 0:
            return found, vals
        mask = np.uint64(self._cap - 1)
        idx = (hashes & mask).astype(np.int64)
        pending = np.arange(n, dtype=np.int64)
        while pending.size:
            slot = idx[pending]
            occ = self._used[slot]
            alive = pending[occ]                 # empty slot -> miss, done
            if alive.size == 0:
                break
            aslot = idx[alive]
            hm = self._hash[aslot] == hashes[alive]
            cand = alive[hm]
            cont = alive[~hm]
            if cand.size:
                exact = (self._key[idx[cand]] == matrix[cand]).all(axis=1)
                hit = cand[exact]
                found[hit] = True
                vals[hit] = self._val[idx[hit]]
                cont = np.concatenate([cont, cand[~exact]])
            idx[cont] = (idx[cont] + 1) & self._cap - 1
            pending = cont
        hit_rows = np.flatnonzero(found)
        if hit_rows.size:                        # recency touch (LRU)
            self._age[idx[hit_rows]] = self._stamp + 1 + hit_rows
            self._stamp += 1 + int(hit_rows[-1])
        return found, vals

    def insert(self, matrix: np.ndarray, hashes: np.ndarray,
               values: np.ndarray) -> None:
        """Batch insert of rows known to be absent and batch-unique."""
        n = matrix.shape[0]
        if n == 0:
            return
        self._reserve(n)
        base = self._stamp + 1
        self._scatter(matrix, hashes, values,
                      base + np.arange(n, dtype=np.int64))
        self._stamp = base + n
        self.size += n
        if self.size > self.maxsize:
            self._evict()

    def _scatter(self, matrix, hashes, values, stamps) -> None:
        """The raw probe-and-claim loop (no growth, no eviction)."""
        mask = np.uint64(self._cap - 1)
        idx = (hashes & mask).astype(np.int64)
        pending = np.arange(matrix.shape[0], dtype=np.int64)
        while pending.size:
            slot = idx[pending]
            occ = self._used[slot]
            movers = pending[occ]
            free = pending[~occ]
            if free.size:
                # Several rows may target one empty slot: first (stable
                # unique) claims it, the rest re-probe next round.
                _, first = np.unique(idx[free], return_index=True)
                winners = free[np.sort(first)]
                ws = idx[winners]
                self._used[ws] = True
                self._hash[ws] = hashes[winners]
                self._key[ws] = matrix[winners]
                self._val[ws] = values[winners]
                self._age[ws] = stamps[winners]
                if winners.size != free.size:
                    keep = np.ones(free.size, dtype=bool)
                    keep[np.searchsorted(free, winners)] = False
                    movers = np.concatenate([movers, free[keep]])
            idx[movers] = (idx[movers] + 1) & self._cap - 1
            pending = np.sort(movers)   # claim logic needs ascending rows

    def _reserve(self, n_new: int) -> None:
        need = (self.size + n_new) * 2
        if need <= self._cap:
            return
        cap = self._cap
        while cap < need:
            cap <<= 1
        self._rebuild(cap, keep=self._cap)

    def _evict(self) -> None:
        """Drop the least-recently-touched rows down to `maxsize`."""
        drop = self.size - self.maxsize
        self.evictions += drop
        self._rebuild(self._cap, keep=self.maxsize)

    def _rebuild(self, cap: int, keep: int) -> None:
        slots = np.flatnonzero(self._used)
        order = slots[np.argsort(self._age[slots], kind="stable")]
        if keep < order.size:
            order = order[order.size - keep:]
        keys = self._key[order].copy()
        hs = self._hash[order].copy()
        vals = self._val[order].copy()
        ages = self._age[order].copy()
        self._alloc(cap)
        self.size = order.size
        if order.size:
            self._scatter(keys, hs, vals, ages)

    # ----------------------------------------------------------- wire I/O
    def export_bytes(self) -> Dict[bytes, Tuple[float, ...]]:
        """Row bytes -> value tuple, oldest-touched first (the same
        insertion-ordered dict the `_LRU` export produced)."""
        slots = np.flatnonzero(self._used)
        order = slots[np.argsort(self._age[slots], kind="stable")]
        keys = self._key[order]
        vals = self._val[order]
        return {keys[i].tobytes(): tuple(vals[i].tolist())
                for i in range(order.size)}

    def merge_bytes(self, exported: Dict[bytes, Tuple[float, ...]]) -> int:
        """First-writer-wins fold of an `export_bytes` dict; returns the
        number of new rows.  Does not touch hit/miss counters."""
        if not exported:
            return 0
        raw = b"".join(exported.keys())
        matrix = np.frombuffer(raw, dtype=np.int64).reshape(
            len(exported), self.ncols)
        vals = np.asarray(list(exported.values()), dtype=np.float64)
        if vals.ndim == 1:
            vals = vals[:, None]
        h = hash_rows(matrix)
        found, _ = self.lookup(matrix, h)
        fresh = np.flatnonzero(~found)
        if fresh.size:
            self.insert(matrix[fresh], h[fresh], vals[fresh])
        return int(fresh.size)

    def __len__(self) -> int:
        return self.size
