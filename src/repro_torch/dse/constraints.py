"""Declarative constraints for the `repro_torch.dse` Study API.

Before this facade existed the feasibility story was split: the area
budget was applied inside the `Evaluator` (scores zeroed past the
budget), while the Eq. 11/13 peak-buffer floors were enforced by the
*space* (`repair_for_peaks` growing sampled/offspring configs onto the
floors).  A `Constraint` unifies both behind one interface::

    feasible_mask(batch, metrics) -> bool[N]   # which rows satisfy it
    repair(batch, space)          -> batch'    # move rows into the
                                               # feasible region (optional;
                                               # identity by default)

`feasible_mask` is consumed by the shared `Evaluator` (rows outside the
mask score 0 — the paper's "0 GOPS on violation") and by the Study's
cross-application selection stage (`feasible_mask_all`); `repair` is
consumed by the engines' starting-point/offspring plumbing —
`repro_torch.core.search.base.repair_with`/`repair_many_with` chain the
injected constraints' `repair` hooks after the space's own peak repair.
`batch` is the array-native `ConfigBatch`, so masks are vectorized
column math.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Sequence

import numpy as np

from repro_torch.core.costmodel import ConfigBatch

__all__ = ["Constraint", "AreaBudget", "PeakBuffers", "UserConstraint",
           "feasible_mask_all", "constraint_from_describe"]


class Constraint:
    """Base: named feasibility predicate over config batches."""

    name = "constraint"

    def feasible_mask(self, batch: ConfigBatch,
                      metrics: Dict[str, np.ndarray]) -> np.ndarray:
        raise NotImplementedError

    def repair(self, batch: ConfigBatch, space) -> ConfigBatch:
        """Optional projection into the feasible region (identity here)."""
        return batch

    def describe(self) -> Dict:
        return {"name": self.name}


@dataclasses.dataclass
class AreaBudget(Constraint):
    """Total cost-model area <= `budget` (the evaluator's legacy mask)."""

    budget: float
    name: str = dataclasses.field(default="area-budget", init=False)

    def feasible_mask(self, batch, metrics) -> np.ndarray:
        return np.asarray(metrics["area"], dtype=np.float64) <= self.budget

    def describe(self) -> Dict:
        return {"name": self.name, "budget": float(self.budget)}


@dataclasses.dataclass
class PeakBuffers(Constraint):
    """Eq. (11)/(13) peak-demand floors: the weight buffer must hold
    `weight_bits` and the activation buffer `input_bits` (batch-scaled
    where the consumer passes the evaluator's scaled floor).

    `repair` routes the whole batch through the space's vectorized
    `repair_for_peaks_many` — which also re-enters the space's area budget
    (phases C/D), i.e. the historical grow-buffers-then-shrink schedule —
    so the previously split evaluator/space paths share one front door.
    """

    weight_bits: int = 0
    input_bits: int = 0
    name: str = dataclasses.field(default="peak-buffers", init=False)

    @staticmethod
    def from_spec(spec, scale_batch: int = 1) -> "PeakBuffers":
        """Floors from an `AppSpec` (Eq. 13 scales by the stream batch)."""
        return PeakBuffers(weight_bits=spec.peak_weight_bits,
                           input_bits=spec.peak_input_bits * scale_batch)

    def feasible_mask(self, batch, metrics) -> np.ndarray:
        return ((batch.weight_buffer_bits_arr() >= self.weight_bits)
                & (batch.act_buffer_bits_arr() >= self.input_bits))

    def repair(self, batch, space) -> ConfigBatch:
        fn = getattr(space, "repair_for_peaks_many", None)
        if fn is None:
            return batch
        return fn(batch, self.weight_bits, self.input_bits)

    def describe(self) -> Dict:
        return {"name": self.name, "weight_bits": int(self.weight_bits),
                "input_bits": int(self.input_bits)}


class UserConstraint(Constraint):
    """Arbitrary predicate.  `fn(batch, metrics) -> bool[N]` (vectorized),
    or — via `from_config_predicate` — a scalar `fn(config) -> bool`
    applied row-wise for quick one-offs."""

    def __init__(self, fn: Callable[[ConfigBatch, Dict], np.ndarray],
                 name: str = "user"):
        self.fn = fn
        self.name = name

    @staticmethod
    def from_config_predicate(fn: Callable[[Any], bool],
                              name: str = "user") -> "UserConstraint":
        def batched(batch: ConfigBatch, metrics) -> np.ndarray:
            return np.asarray([bool(fn(c)) for c in batch.to_configs()])
        return UserConstraint(batched, name=name)

    def feasible_mask(self, batch, metrics) -> np.ndarray:
        return np.asarray(self.fn(batch, metrics), dtype=bool)


def feasible_mask_all(constraints: Sequence[Constraint], batch: ConfigBatch,
                      metrics: Dict[str, np.ndarray]) -> np.ndarray:
    """AND of every constraint's mask (all-True for an empty list)."""
    mask = np.ones(len(batch), dtype=bool)
    for c in constraints:
        mask &= np.asarray(c.feasible_mask(batch, metrics), dtype=bool)
    return mask


def constraint_from_describe(d: Dict) -> Constraint:
    """Rebuild a constraint from its `describe()` record (the inverse used
    by study checkpoints).  Only the declarative built-ins round-trip;
    `UserConstraint` carries an arbitrary callable and cannot."""
    name = d.get("name")
    if name == "area-budget":
        return AreaBudget(budget=float(d["budget"]))
    if name == "peak-buffers":
        return PeakBuffers(weight_bits=int(d["weight_bits"]),
                           input_bits=int(d["input_bits"]))
    raise ValueError(
        f"constraint {name!r} is not reconstructible from its describe() "
        "record (only area-budget / peak-buffers round-trip)")
