"""Declarative optimization objectives for the `repro_torch.dse` Study API.

The paper evaluates accelerator designs under several readings of "best":
per-application GOPS (Table 3) and geometric-mean GOPS across applications
(§5.1, Tables 4-5).  An `Objective` makes that reading a first-class object
instead of a hardcoded branch inside the evaluator or each consumer.

Objectives implement::

    score(metrics) -> np.ndarray [N]        # higher is better

over a metrics dict of aligned columns — ``perf`` ([N] GOPS, already
zeroed on constraint violation), ``area`` ([N] cost-model area units),
and, at the cross-application selection stage, ``perf_matrix``
([n_apps, N]).  The JAX package's vector `ParetoObjective` is not ported
yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["Objective", "MaxPerf", "PerfPerArea", "GeomeanAcrossApps",
           "geomean", "OBJECTIVES", "make_objective"]

Metrics = Dict[str, np.ndarray]


def geomean(x: np.ndarray, axis: int = 0) -> np.ndarray:
    """Geometric mean with a 1e-12 floor (the JAX package's floor, so
    selections agree with it byte for byte)."""
    x = np.maximum(np.asarray(x, dtype=np.float64), 1e-12)
    return np.exp(np.log(x).mean(axis=axis))


class Objective:
    """Base: a named, picklable-to-JSON description of "better"."""

    name = "objective"
    #: True when `score` needs the cross-app ``perf_matrix`` column (the
    #: Study then runs its selection stage over candidates from every app).
    cross_app = False

    def score(self, metrics: Metrics) -> np.ndarray:
        raise NotImplementedError

    def describe(self) -> Dict:
        return {"name": self.name}

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"{type(self).__name__}()"


class MaxPerf(Objective):
    """Per-application GOPS, the paper's default (§4.3)."""

    name = "maxperf"

    def score(self, metrics: Metrics) -> np.ndarray:
        return np.asarray(metrics["perf"], dtype=np.float64)


class PerfPerArea(Objective):
    """GOPS per unit cost-model area — the efficiency reading of Table 3.

    Infeasible points keep score 0 (their perf column is already zeroed).
    """

    name = "perf-per-area"

    def score(self, metrics: Metrics) -> np.ndarray:
        perf = np.asarray(metrics["perf"], dtype=np.float64)
        area = np.maximum(np.asarray(metrics["area"], dtype=np.float64),
                          1e-12)
        return perf / area


class GeomeanAcrossApps(Objective):
    """§5.1 joint selection: geometric-mean GOPS across all applications,
    zero for candidates that violate any application's constraints."""

    name = "geomean"
    cross_app = True

    def score(self, metrics: Metrics) -> np.ndarray:
        cross = np.asarray(metrics["perf_matrix"], dtype=np.float64)
        valid = (cross > 0).all(axis=0)
        return np.where(valid, geomean(cross, axis=0), 0.0)


OBJECTIVES = {
    "maxperf": MaxPerf,
    "perf-per-area": PerfPerArea,
    "geomean": GeomeanAcrossApps,
}


def make_objective(spec) -> Objective:
    """Objective from a name, class or instance."""
    if isinstance(spec, Objective):
        return spec
    if isinstance(spec, str):
        if spec == "pareto":
            raise NotImplementedError(
                "the pareto objective is ported in a later slice, see "
                "ROADMAP.md")
        try:
            return OBJECTIVES[spec]()
        except KeyError:
            raise ValueError(f"unknown objective {spec!r}; available: "
                             f"{sorted(OBJECTIVES)}")
    if isinstance(spec, type) and issubclass(spec, Objective):
        return spec()
    raise TypeError(f"cannot build an Objective from {spec!r}")
