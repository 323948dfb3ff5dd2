"""Deterministic Pareto-front reduction for `repro_torch.dse` studies.

`canonical_front_indices` / `merge_pareto_fronts` reduce (perf, area)
points to their non-dominated front with content-based tie-breaking, so
the front is invariant to the order the candidates arrive in — the joint
front of a Pareto `Study` does not depend on app order within a tie, and
the parallel Study (a later slice: the process-pool executor, its worker
tasks and checkpoint/resume, `ROADMAP.md` A3.4) reduces its shards with
the same functions.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.search import config_key

__all__ = ["canonical_front_indices", "merge_pareto_fronts"]


def canonical_front_indices(perf: np.ndarray, area: np.ndarray,
                            keys: Optional[Sequence] = None) -> List[int]:
    """Non-dominated set for (maximize perf, minimize area) with canonical,
    content-based ordering: the sweep runs over (area asc, perf desc,
    key asc), so the returned front — and which of several metric-tied
    points represents a front step — does not depend on the input order.
    Zero-performance (constraint-violating) points never enter."""
    perf = np.asarray(perf, dtype=np.float64)
    area = np.asarray(area, dtype=np.float64)
    cand = np.flatnonzero(perf > 0)
    if cand.size == 0:
        return []
    if keys is None:
        order = cand[np.lexsort((-perf[cand], area[cand]))]
    else:
        order = sorted(cand.tolist(),
                       key=lambda i: (area[i], -perf[i], keys[i]))
    front: List[int] = []
    best = -np.inf
    for i in order:
        if perf[i] > best:
            front.append(int(i))
            best = perf[i]
    return front


def merge_pareto_fronts(shard_fronts: Sequence[Sequence[Tuple[Any, float,
                                                              float]]]
                        ) -> List[Tuple[Any, float, float]]:
    """Reduce per-shard (config, perf, area) fronts into one global front,
    invariant to shard count and arrival order.

    Entries are first deduped by config content (`config_key`; ties keep
    one canonical representative), then swept with
    `canonical_front_indices`.  The output is sorted by ascending area —
    the same shape `pareto_front_indices` produces — so downstream
    consumers (budget selections, plots) need no changes.

    Shards may be `None` or empty (an all-infeasible worker partition —
    routine under composition sharding, where a tight area tier can zero
    out every candidate a shard saw); they contribute nothing.  An input
    of only such shards reduces to the empty front."""
    by_key: Dict[Tuple, Tuple[Any, float, float]] = {}
    for front in shard_fronts:
        if front is None or len(front) == 0:
            continue
        for cfg, perf, area in front:
            k = config_key(cfg)
            prev = by_key.get(k)
            # identical configs must carry identical metrics; keep the
            # first and let mismatches surface loudly rather than silently
            if prev is not None:
                if (float(prev[1]), float(prev[2])) != (float(perf),
                                                        float(area)):
                    raise ValueError(
                        f"conflicting metrics for one config across "
                        f"shards: {prev[1:]} vs {(perf, area)}")
                continue
            by_key[k] = (cfg, float(perf), float(area))
    entries = [by_key[k] for k in sorted(by_key)]
    perf = np.asarray([e[1] for e in entries])
    area = np.asarray([e[2] for e in entries])
    keys = sorted(by_key)
    idx = canonical_front_indices(perf, area, keys)
    return [entries[i] for i in idx]
