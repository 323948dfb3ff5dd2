"""Declarative optimization objectives for the `repro_torch.dse` Study API.

The paper evaluates accelerator designs under several readings of "best":
per-application GOPS (Table 3), geometric-mean GOPS across applications
(§5.1, Tables 4-5), and perf/area trade-off curves at multiple area
budgets (Co-Design-style, cf. Kwon et al. 2018).  An `Objective` makes
that reading a first-class object instead of a hardcoded branch inside the
evaluator or each consumer script.

Scalar objectives implement::

    score(metrics) -> np.ndarray [N]        # higher is better

over a metrics dict of aligned columns — ``perf`` ([N] GOPS, already
zeroed on constraint violation), ``area`` ([N] cost-model area units),
and, at the cross-application selection stage, ``perf_matrix``
([n_apps, N]).  Vector objectives (`ParetoObjective`) additionally
implement::

    values(metrics)   -> np.ndarray [N, M]  # per-term columns, maximize
    scalarize(values) -> np.ndarray [N]     # engine-facing reduction

`values` is what the shared `Evaluator` returns to the search loop;
`scalarize` is the hook `make_engine` installs on every engine so the
ask/tell loop still optimizes one number per candidate while
`SearchResult.evaluated_values` retains the full rows for Pareto-front
extraction.  Two scalarizations are provided: augmented weighted-Chebyshev
(any number of terms) and exact 2-D hypervolume contribution.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Objective", "MaxPerf", "PerfPerArea", "GeomeanAcrossApps",
           "ParetoObjective", "geomean", "OBJECTIVES", "make_objective"]

Metrics = Dict[str, np.ndarray]


def geomean(x: np.ndarray, axis: int = 0) -> np.ndarray:
    """Geometric mean with the same 1e-12 floor `run_multiapp_study` uses
    (so selections through the Study API stay byte-identical)."""
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
    zero for candidates that violate any application's constraints —
    exactly the `run_multiapp_study` step-4 rule."""

    name = "geomean"
    cross_app = True

    def score(self, metrics: Metrics) -> np.ndarray:
        cross = np.asarray(metrics["perf_matrix"], dtype=np.float64)
        valid = (cross > 0).all(axis=0)
        return np.where(valid, geomean(cross, axis=0), 0.0)


# --------------------------------------------------------------------------
# Vector-valued objective + scalarizers
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Term:
    """One objective term: a metrics column and its orientation."""

    key: str          # metrics column ("perf", "area", ...)
    sign: float       # +1 maximize, -1 minimize (column stored negated)

    @staticmethod
    def parse(spec) -> "_Term":
        if isinstance(spec, _Term):
            return spec
        if isinstance(spec, (tuple, list)):
            return _Term(str(spec[0]), float(spec[1]))
        s = str(spec)
        return _Term(s[1:], -1.0) if s.startswith("-") else _Term(s, 1.0)

    def label(self) -> str:
        return self.key if self.sign > 0 else f"-{self.key}"


class ParetoObjective(Objective):
    """Vector objective: maximize every term jointly (e.g.
    ``ParetoObjective(["perf", "-area"])`` = fast AND small).

    `values` hands the engines an [N, M] matrix (term `m` = sign *
    metrics column, so every column is maximize-oriented); `scalarize`
    reduces it for the ask/tell loop:

      * ``method="chebyshev"``    — augmented weighted-Chebyshev
        achievement over running per-term bounds (any M);
      * ``method="hypervolume"``  — exact exclusive hypervolume
        contribution in 2-D (falls back to Chebyshev for M != 2).

    The FIRST maximize term (canonically perf) is the validity witness:
    rows where it is <= 0 (constraint violations — the evaluator zeroes
    the perf column) scalarize to 0, preserving the paper's "0 GOPS on
    violation" semantics for every engine.  Scalarized scores are only a
    search signal; the deliverable is the non-dominated front retained in
    `SearchResult.evaluated_values` / `StudyResult.front`.
    """

    name = "pareto"

    def __init__(self, terms: Sequence = ("perf", "-area"),
                 method: str = "chebyshev",
                 weights: Optional[Sequence[float]] = None,
                 rho: float = 0.05):
        self.terms: Tuple[_Term, ...] = tuple(_Term.parse(t) for t in terms)
        if len(self.terms) < 2:
            raise ValueError("ParetoObjective needs >= 2 terms")
        if method not in ("chebyshev", "hypervolume"):
            raise ValueError(f"unknown scalarization {method!r}")
        self.method = method
        self.weights = (np.asarray(weights, dtype=np.float64)
                        if weights is not None
                        else np.ones(len(self.terms)))
        if len(self.weights) != len(self.terms):
            raise ValueError("one weight per term")
        self.rho = rho
        # running per-term bounds over feasible points (normalization state
        # for the scalarizers; deterministic given the evaluation sequence)
        self._lo: Optional[np.ndarray] = None
        self._hi: Optional[np.ndarray] = None
        try:
            self._valid_col = next(i for i, t in enumerate(self.terms)
                                   if t.sign > 0)
        except StopIteration:
            raise ValueError("at least one maximize term is required")

    # ------------------------------------------------------------- columns
    def values(self, metrics: Metrics) -> np.ndarray:
        cols = [t.sign * np.asarray(metrics[t.key], dtype=np.float64)
                for t in self.terms]
        return np.stack(cols, axis=1)

    def score(self, metrics: Metrics) -> np.ndarray:
        return self.scalarize(self.values(metrics))

    # ---------------------------------------------------------- scalarizers
    def _normalize(self, values: np.ndarray,
                   valid: np.ndarray) -> np.ndarray:
        """Map values into [0, 1] per term using running feasible bounds."""
        if valid.any():
            lo = values[valid].min(axis=0)
            hi = values[valid].max(axis=0)
            self._lo = lo if self._lo is None else np.minimum(self._lo, lo)
            self._hi = hi if self._hi is None else np.maximum(self._hi, hi)
        if self._lo is None:
            return np.zeros_like(values)
        span = np.maximum(self._hi - self._lo, 1e-12)
        return np.clip((values - self._lo) / span, 0.0, 1.0)

    def scalarize(self, values: np.ndarray) -> np.ndarray:
        values = np.asarray(values, dtype=np.float64)
        valid = values[:, self._valid_col] > 0
        norm = self._normalize(values, valid)
        if self.method == "hypervolume" and values.shape[1] == 2:
            out = self._hypervolume_2d(norm)
        else:
            w = self.weights / self.weights.sum()
            # augmented weighted-Chebyshev achievement (higher = better):
            # the worst-off weighted term, plus a small sum term so weakly
            # dominated points still rank below dominating ones
            out = ((w[None, :] * norm).min(axis=1)
                   + self.rho * (w[None, :] * norm).sum(axis=1))
        # strictly positive for every feasible row so validators
        # (`score_one(...) > 0`) accept feasible starting points even
        # before the running bounds have spread
        return np.where(valid, 1e-9 + out, 0.0)

    @staticmethod
    def _hypervolume_2d(norm: np.ndarray) -> np.ndarray:
        """Exclusive hypervolume contribution w.r.t. the (0, 0) reference
        for the batch's own non-dominated set; dominated points fall back
        to a (scaled-down) dominated-volume score so selection pressure
        still ranks them."""
        n = norm.shape[0]
        out = norm[:, 0] * norm[:, 1] * 1e-3          # dominated fallback
        order = np.lexsort((-norm[:, 1], -norm[:, 0]))
        best_y = -np.inf
        front: list = []
        for i in order:
            if norm[i, 1] > best_y:
                front.append(i)
                best_y = norm[i, 1]
        # front is sorted by descending x, ascending y
        for pos, i in enumerate(front):
            x_next = norm[front[pos + 1], 0] if pos + 1 < len(front) else 0.0
            y_prev = norm[front[pos - 1], 1] if pos > 0 else 0.0
            out[i] = max((norm[i, 0] - x_next) * (norm[i, 1] - y_prev), 0.0)
        return out

    def describe(self) -> Dict:
        return {"name": self.name,
                "terms": [t.label() for t in self.terms],
                "method": self.method,
                "weights": self.weights.tolist(),
                "rho": float(self.rho)}

    def __repr__(self) -> str:  # pragma: no cover
        return (f"ParetoObjective({[t.label() for t in self.terms]}, "
                f"method={self.method!r})")


OBJECTIVES = {
    "maxperf": MaxPerf,
    "perf-per-area": PerfPerArea,
    "geomean": GeomeanAcrossApps,
    "pareto": ParetoObjective,
}


def make_objective(spec) -> Objective:
    """Objective from a name, class, instance, or `describe()` record.

    The dict form is the inverse of `Objective.describe()` (used by study
    checkpoints to round-trip the problem spec through JSON): ``{"name":
    "pareto", "terms": [...], "method": ..., "weights": [...]}`` rebuilds a
    `ParetoObjective`; the scalar objectives rebuild from their name alone.
    """
    if isinstance(spec, Objective):
        return spec
    if isinstance(spec, dict):
        name = spec.get("name")
        if name not in OBJECTIVES:
            raise ValueError(
                f"objective {name!r} is not reconstructible from its "
                f"describe() record; available: {sorted(OBJECTIVES)}")
        if name == "pareto":
            return ParetoObjective(terms=spec.get("terms", ("perf", "-area")),
                                   method=spec.get("method", "chebyshev"),
                                   weights=spec.get("weights"),
                                   rho=float(spec.get("rho", 0.05)))
        return OBJECTIVES[name]()
    if isinstance(spec, str):
        try:
            return OBJECTIVES[spec]()
        except KeyError:
            raise ValueError(f"unknown objective {spec!r}; available: "
                             f"{sorted(OBJECTIVES)}")
    if isinstance(spec, type) and issubclass(spec, Objective):
        return spec()
    raise TypeError(f"cannot build an Objective from {spec!r}")
