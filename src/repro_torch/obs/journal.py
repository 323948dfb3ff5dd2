"""JSONL search journal: one record per engine ask/tell round.

The shoot-out benchmark used to hand-roll per-engine trajectory lists;
the journal makes "anytime curve" data a first-class byproduct of *every*
search.  `run_search` emits one record per round::

    {"seq": 3, "kind": "round", "app": "resnet", "engine": "tpe",
     "round": 4, "pool": 16, "n_scored": 64, "dedup_skipped": 5,
     "best": 1530.2, "feasible_frac": 0.81, "hypervolume": 41234.5}

`best` is the incumbent scalar after the round (null until one exists),
`feasible_frac` the fraction of the round's pool scoring > 0,
`dedup_skipped` how many of the round's proposals were already proposed
in an earlier round of the same search (served from the evaluator's row
cache, never re-scored), and `hypervolume` the exact 2-D hypervolume of
the (GOPS up, area down) front over everything journaled so far,
referenced to the evaluator's area budget (null when the evaluator
carries no area reading).

Records are picklable dicts; worker processes export their buffers and
the parent merges them (the parallel Study), so one Study yields one
journal regardless of worker count.  `write_jsonl` orders records by
(app, engine, seq) — a canonical order independent of task completion
order.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List

__all__ = ["Journal", "REQUIRED_FIELDS", "validate_record"]

#: every journal record carries these; `app` is added from the ambient
#: context when one is set (worker tasks always set it)
REQUIRED_FIELDS = ("seq", "kind", "engine", "round", "pool", "n_scored",
                   "best", "feasible_frac", "hypervolume")


def validate_record(rec: Dict[str, Any]) -> None:
    """Raise ValueError unless `rec` is a well-formed round record."""
    missing = [k for k in REQUIRED_FIELDS if k not in rec]
    if missing:
        raise ValueError(f"journal record missing fields {missing}: {rec}")
    if not isinstance(rec["seq"], int) or rec["seq"] < 0:
        raise ValueError(f"bad seq in journal record: {rec['seq']!r}")
    if rec["kind"] != "round":
        raise ValueError(f"unknown journal record kind: {rec['kind']!r}")
    if not isinstance(rec["engine"], str) or not rec["engine"]:
        raise ValueError(f"bad engine in journal record: {rec['engine']!r}")
    for k in ("round", "pool", "n_scored"):
        if not isinstance(rec[k], int) or rec[k] < 0:
            raise ValueError(f"bad {k} in journal record: {rec[k]!r}")
    # optional (records from pre-dedup journals omit it)
    if "dedup_skipped" in rec and (not isinstance(rec["dedup_skipped"], int)
                                   or rec["dedup_skipped"] < 0):
        raise ValueError(
            f"bad dedup_skipped in journal record: {rec['dedup_skipped']!r}")
    for k in ("best", "feasible_frac", "hypervolume"):
        if rec[k] is not None and not isinstance(rec[k], (int, float)):
            raise ValueError(f"bad {k} in journal record: {rec[k]!r}")
    if "app" in rec and rec["app"] is not None \
            and not isinstance(rec["app"], str):
        raise ValueError(f"bad app in journal record: {rec['app']!r}")


class Journal:
    def __init__(self) -> None:
        self.enabled = False
        self._records: List[Dict[str, Any]] = []
        self._seq = 0

    def record(self, **fields: Any) -> None:
        if not self.enabled:
            return
        rec = {"seq": self._seq}
        rec.update(fields)
        self._seq += 1
        self._records.append(rec)

    # ------------------------------------------------------- export / merge
    def export(self) -> List[Dict[str, Any]]:
        return list(self._records)

    def merge(self, records: List[Dict[str, Any]]) -> int:
        self._records.extend(records)
        return len(records)

    def reset(self) -> None:
        self._records.clear()
        self._seq = 0

    def __len__(self) -> int:
        return len(self._records)

    @property
    def records(self) -> List[Dict[str, Any]]:
        return list(self._records)

    # --------------------------------------------------------------- output
    def write_jsonl(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        ordered = sorted(
            self._records,
            key=lambda r: (str(r.get("app") or ""),
                           str(r.get("engine") or ""), int(r["seq"])))
        path.write_text("".join(json.dumps(r, sort_keys=True) + "\n"
                                for r in ordered))
        return path
