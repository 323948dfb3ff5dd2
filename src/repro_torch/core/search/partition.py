"""Deterministic partition combinatorics for multi-accelerator composition.

The CDAC stage of a CHARM-style two-level flow (CDSE per accelerator,
then composition under one shared resource budget) enumerates *who runs
where* and *how the budget splits*.  Both enumerations live here as pure
functions of their arguments — no RNG, no global state — so every
consumer (the `Study` composition synthesis, benchmarks, tests) sees the
exact same candidate order regardless of worker count or call site.

Canonical forms
===============

* An **assignment** maps each of `n` workloads to one of exactly `k`
  sub-accelerator groups.  Groups are unordered (engine 0 vs engine 1 is
  a labeling artifact), so assignments are canonicalized as *restricted
  growth strings*: group labels appear in first-occurrence order, i.e.
  ``a[0] == 0`` and ``a[i] <= max(a[:i]) + 1``.  Enumeration is
  lexicographic over those strings, surjective onto ``range(k)`` — the
  Stirling-number S(n, k) set, each unordered partition exactly once.
* A **split** divides a unit budget into `k` positive shares on a grid:
  each share is a positive multiple of ``1/grid`` and the shares sum to
  1.  Enumeration is lexicographic over the numerator tuples (the
  C(grid-1, k-1) compositions of `grid`).
* `tier_shares(k, grid)` is the sorted set of share values any split can
  award one group — the per-group search budgets the CDSE phase must
  cover (K=1 degenerates to ``(1.0,)``).

`Partition` bundles one assignment with one split and round-trips
through JSON for checkpointed studies.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

__all__ = ["Partition", "enumerate_assignments", "enumerate_splits",
           "tier_shares", "group_members"]


def enumerate_assignments(n: int, k: int,
                          limit: int = 0) -> List[Tuple[int, ...]]:
    """All canonical surjective assignments of `n` items onto `k` groups.

    Returned tuples are restricted growth strings (first occurrences of
    the group labels are in increasing order) using exactly `k` labels,
    in lexicographic order.  `limit > 0` truncates the enumeration after
    `limit` entries (still a deterministic prefix); S(n, k) grows fast,
    so callers with many workloads should cap it.
    """
    n, k = int(n), int(k)
    if k < 1:
        raise ValueError(f"need k >= 1 groups, got {k}")
    if n < k:
        raise ValueError(
            f"cannot place {n} workload(s) onto {k} group(s) surjectively; "
            f"composition needs at least as many workloads as engines")
    out: List[Tuple[int, ...]] = []

    def _grow(prefix: List[int], used: int) -> None:
        if limit > 0 and len(out) >= limit:
            return
        i = len(prefix)
        if i == n:
            if used == k:
                out.append(tuple(prefix))
            return
        # pruning: the remaining slots must still introduce k - used labels
        if used + (n - i) < k:
            return
        for g in range(min(used + 1, k)):
            prefix.append(g)
            _grow(prefix, max(used, g + 1))
            prefix.pop()
            if limit > 0 and len(out) >= limit:
                return

    _grow([], 0)
    return out


def enumerate_splits(k: int, grid: int) -> List[Tuple[float, ...]]:
    """All ways to split a unit budget into `k` positive shares on a
    ``1/grid`` grid, lexicographic by numerator tuple.  ``k == grid``
    yields only the even split; ``grid < k`` is an error (some group
    would get nothing)."""
    k, grid = int(k), int(grid)
    if k < 1:
        raise ValueError(f"need k >= 1 shares, got {k}")
    if grid < k:
        raise ValueError(
            f"split grid {grid} is too coarse for {k} groups (every group "
            f"needs at least one 1/{grid} share)")
    out: List[Tuple[float, ...]] = []

    def _grow(prefix: List[int], left: int) -> None:
        if len(prefix) == k - 1:
            out.append(tuple(p / grid for p in prefix + [left]))
            return
        keep = k - 1 - len(prefix)          # groups still to fill after this
        for units in range(1, left - keep + 1):
            prefix.append(units)
            _grow(prefix, left - units)
            prefix.pop()

    _grow([], grid)
    return out


def tier_shares(k: int, grid: int) -> Tuple[float, ...]:
    """Sorted distinct share values `enumerate_splits(k, grid)` can award
    a single group — the area tiers the per-engine CDSE phase searches."""
    shares = sorted({s for split in enumerate_splits(k, grid)
                     for s in split})
    return tuple(shares)


def group_members(assignment: Tuple[int, ...], k: int) -> List[List[int]]:
    """Item indices per group, group-major: ``out[g]`` lists the items
    assigned to group `g` in ascending order."""
    out: List[List[int]] = [[] for _ in range(int(k))]
    for i, g in enumerate(assignment):
        out[int(g)].append(i)
    return out


@dataclasses.dataclass(frozen=True)
class Partition:
    """One composition skeleton: who runs where, and the budget split.

    ``assignment[i]`` is the engine index of workload `i` (canonical
    restricted-growth labeling); ``split[g]`` is engine `g`'s share of
    the total area budget.  Immutable and JSON-round-trippable so it can
    ride inside study checkpoints and persisted results."""

    assignment: Tuple[int, ...]
    split: Tuple[float, ...]

    def __post_init__(self):
        k = len(self.split)
        if not self.assignment:
            raise ValueError("empty assignment")
        if sorted(set(self.assignment)) != list(range(k)):
            raise ValueError(
                f"assignment {self.assignment} is not surjective onto "
                f"{k} group(s)")
        if abs(sum(self.split) - 1.0) > 1e-9:
            raise ValueError(f"split {self.split} does not sum to 1")

    @property
    def k(self) -> int:
        return len(self.split)

    def groups(self) -> List[List[int]]:
        return group_members(self.assignment, self.k)

    def to_json(self) -> Dict:
        return {"assignment": [int(g) for g in self.assignment],
                "split": [float(s) for s in self.split]}

    @staticmethod
    def from_json(rec: Dict) -> "Partition":
        return Partition(
            assignment=tuple(int(g) for g in rec["assignment"]),
            split=tuple(float(s) for s in rec["split"]))


def enumerate_partitions(n: int, k: int, grid: int,
                         limit_assignments: int = 0
                         ) -> Iterator[Partition]:
    """Every (assignment, split) pair, assignment-major — the CDAC outer
    loop.  Deterministic; total count S(n, k) * C(grid-1, k-1)."""
    splits = enumerate_splits(k, grid)
    for assignment in enumerate_assignments(n, k, limit=limit_assignments):
        for split in splits:
            yield Partition(assignment=assignment, split=split)


__all__.append("enumerate_partitions")
