"""Closed-form synthetic DSE problems with exactly known optima.

Three multi-objective (maximize perf, minimize area) problems on the same
power-of-two grid the accelerator space uses, small enough to enumerate
*exhaustively* — so tests and benchmarks can compare any engine's outcome
against the true optimum, the true Pareto front, and the true hypervolume
instead of against another search run.  Each problem is a caricature of
one accelerator-DSE pathology:

``roofline``   smooth compute-vs-bandwidth saturation under a tight area
               budget: perf = C / (1 + C/M) rewards *balancing* compute
               (pe*mac*tb) against buffer bandwidth (bufw*bufa) — a
               single smooth basin, the friendliest landscape.
``desert``     Eq. 11/13-style peak-demand floors (bufa >= 8*tb*tk,
               bufw >= mac): most of the grid scores exactly 0, the
               feasible region is a thin shell — random sampling wastes
               its budget, engines must learn the constraint structure.
``ridge``      matched-bandwidth ridge: perf decays 2x per octave of
               |log2(pe*tb) - log2(mac*tk)| imbalance, so the optima lie
               on a narrow multi-modal diagonal of the grid.

`SyntheticEvaluator` wraps a problem behind the exact pool contract the
real `Evaluator` has — memoized `__call__` (masked perf), `score_with_area`,
`feasible_mask`, `n_scored` counting *unique* configs sent to the model —
so every engine (including NSGA-II's raw-metric recovery path) runs
unmodified, and evaluations-to-target is measured in the same cache-miss
units as the expensive-evaluator path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.search.base import (DiscreteSpace,
                                          pareto_front_indices)

__all__ = ["GridConfig", "SyntheticProblem", "SyntheticEvaluator",
           "PROBLEMS", "make_problem", "problem_truth", "hypervolume_2d"]


def _pow2(n: int) -> Tuple[int, ...]:
    return tuple(2 ** i for i in range(n))


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """One point of the synthetic power-of-two grid."""

    pe: int        # processing elements
    mac: int       # MACs per element
    bufw: int      # weight-buffer banks
    bufa: int      # activation-buffer banks
    tb: int        # batch tile
    tk: int        # channel tile

    def asdict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


_FIELDS = ("pe", "mac", "bufw", "bufa", "tb", "tk")

_DOMAINS: Dict[str, Tuple[int, ...]] = {
    "pe": _pow2(8), "mac": _pow2(8),
    "bufw": _pow2(11), "bufa": _pow2(11),
    "tb": _pow2(4), "tk": _pow2(4),
}

Values = Dict[str, np.ndarray]


@dataclasses.dataclass(frozen=True)
class SyntheticProblem:
    """Closed-form (perf, area, feasibility) on the power-of-two grid."""

    name: str
    perf: Callable[[Values], np.ndarray]
    area: Callable[[Values], np.ndarray]
    feasible: Callable[[Values], np.ndarray]
    area_budget: float

    def space(self) -> DiscreteSpace:
        return DiscreteSpace(domains=dict(_DOMAINS), make_config=GridConfig)


def _roofline_perf(v: Values) -> np.ndarray:
    compute = v["pe"] * v["mac"] * v["tb"]
    mem = v["bufw"] * v["bufa"]
    return compute / (1.0 + compute / np.maximum(mem, 1.0))


def _roofline_area(v: Values) -> np.ndarray:
    return (4.0 * v["pe"] * v["mac"] + v["bufw"] + v["bufa"]
            + 16.0 * v["tb"] * v["tk"])


def _desert_perf(v: Values) -> np.ndarray:
    return v["pe"] * v["mac"] * np.sqrt(v["tb"] * v["tk"])


def _desert_area(v: Values) -> np.ndarray:
    return 2.0 * v["pe"] * v["mac"] + v["bufw"] + v["bufa"]


def _desert_feasible(v: Values) -> np.ndarray:
    # peak-demand floors, the Eq. 11/13 caricature
    return ((v["bufa"] >= 16.0 * v["tb"] * v["tk"])
            & (v["bufw"] >= 2.0 * v["mac"]))


def _ridge_perf(v: Values) -> np.ndarray:
    imbalance = np.abs(np.log2(v["pe"] * v["tb"])
                       - np.log2(v["mac"] * v["tk"]))
    cap = np.minimum(1.0, (v["bufw"] * v["bufa"]) / 65536.0)
    return np.sqrt(v["pe"] * v["mac"] * v["tb"] * v["tk"]) \
        * (4.0 ** -imbalance) * cap


def _ridge_area(v: Values) -> np.ndarray:
    return (v["pe"] * v["pe"] + v["mac"] * v["mac"]
            + v["bufw"] + v["bufa"])


def _always(v: Values) -> np.ndarray:
    return np.ones(len(next(iter(v.values()))), dtype=bool)


PROBLEMS: Dict[str, SyntheticProblem] = {
    "roofline": SyntheticProblem("roofline", _roofline_perf, _roofline_area,
                                 _always, area_budget=4096.0),
    "desert": SyntheticProblem("desert", _desert_perf, _desert_area,
                               _desert_feasible, area_budget=2048.0),
    "ridge": SyntheticProblem("ridge", _ridge_perf, _ridge_area,
                              _always, area_budget=8192.0),
}


def make_problem(name: str) -> SyntheticProblem:
    if name not in PROBLEMS:
        raise ValueError(f"unknown synthetic problem {name!r}; "
                         f"available: {sorted(PROBLEMS)}")
    return PROBLEMS[name]


class SyntheticEvaluator:
    """Memoizing pool scorer over a `SyntheticProblem` — same contract as
    the accelerator `Evaluator` (`__call__` masked perf, `score_with_area`,
    `feasible_mask`, `n_scored` = unique configs scored), so engines and
    the sample-efficiency benchmark drive it unmodified."""

    def __init__(self, problem: SyntheticProblem):
        self.problem = problem
        self.area_budget = float(problem.area_budget)
        self.hw = None
        self.peak_weight_bits = 0
        self.peak_input_bits = 0
        self.peak_input_bits_scaled = 0
        self.objective = None
        self.constraints: Tuple = ()
        self._cache: Dict[Tuple, Tuple[float, float, bool]] = {}
        self.n_scored = 0          # unique configs sent to the "model"
        self.n_batches = 0

    # ------------------------------------------------------------- scoring
    @staticmethod
    def _values(pool: Sequence[Any]) -> Values:
        return {f: np.asarray([getattr(c, f) for c in pool],
                              dtype=np.float64) for f in _FIELDS}

    def _metrics_of(self, pool) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        pool = list(pool)
        keys = [tuple(getattr(c, f) for f in _FIELDS) for c in pool]
        miss = [i for i, k in enumerate(keys) if k not in self._cache]
        if miss:
            seen = set()
            fresh = [i for i in miss
                     if keys[i] not in seen and not seen.add(keys[i])]
            v = self._values([pool[i] for i in fresh])
            perf = self.problem.perf(v)
            area = self.problem.area(v)
            feas = (self.problem.feasible(v)
                    & (area <= self.area_budget))
            for j, i in enumerate(fresh):
                self._cache[keys[i]] = (float(perf[j]), float(area[j]),
                                        bool(feas[j]))
            self.n_scored += len(fresh)
            self.n_batches += 1
        rows = [self._cache[k] for k in keys]
        perf = np.asarray([r[0] for r in rows], dtype=np.float64)
        area = np.asarray([r[1] for r in rows], dtype=np.float64)
        feas = np.asarray([r[2] for r in rows], dtype=bool)
        return perf, area, feas

    def __call__(self, pool) -> np.ndarray:
        perf, _, feas = self._metrics_of(pool)
        return np.where(feas, perf, 0.0)

    def score_with_area(self, pool) -> Tuple[np.ndarray, np.ndarray]:
        perf, area, feas = self._metrics_of(pool)
        return np.where(feas, perf, 0.0), area

    def feasible_mask(self, batch, metrics) -> np.ndarray:
        _, _, feas = self._metrics_of(batch)
        return feas

    def score_one(self, cfg) -> float:
        return float(self([cfg])[0])

    def stats(self) -> Dict[str, int]:
        return {"scored": self.n_scored, "batches": self.n_batches,
                "cache_size": len(self._cache)}


# --------------------------------------------------------------------------
# Exact ground truth by exhaustive enumeration
# --------------------------------------------------------------------------

_TRUTH_CACHE: Dict[str, Dict] = {}


def problem_truth(name: str) -> Dict:
    """Exact optimum + Pareto front of a synthetic problem (exhaustive,
    vectorized enumeration of the full grid; cached per process).

    Returns ``{"best_perf", "front_perf", "front_area", "hypervolume",
    "ref_area", "n_feasible", "n_total"}`` where the hypervolume is taken
    against the (perf=0, area=area_budget) reference point."""
    if name in _TRUTH_CACHE:
        return _TRUTH_CACHE[name]
    problem = make_problem(name)
    sizes = [len(_DOMAINS[f]) for f in _FIELDS]
    grids = np.meshgrid(*[np.arange(s) for s in sizes], indexing="ij")
    idx = np.stack([g.ravel() for g in grids], axis=1)
    values = {f: np.asarray(_DOMAINS[f], dtype=np.float64)[idx[:, j]]
              for j, f in enumerate(_FIELDS)}
    perf = problem.perf(values)
    area = problem.area(values)
    feas = problem.feasible(values) & (area <= problem.area_budget)
    perf = np.where(feas, perf, 0.0)
    front = pareto_front_indices(perf, area)
    fp = perf[front]
    fa = area[front]
    truth = {
        "best_perf": float(perf.max()),
        "front_perf": fp,
        "front_area": fa,
        "ref_area": float(problem.area_budget),
        "hypervolume": hypervolume_2d(fp, fa, float(problem.area_budget)),
        "n_feasible": int(feas.sum()),
        "n_total": int(len(perf)),
    }
    _TRUTH_CACHE[name] = truth
    return truth


def hypervolume_2d(perf: np.ndarray, area: np.ndarray,
                   ref_area: float) -> float:
    """Exact 2-D hypervolume of a (maximize perf, minimize area) point set
    w.r.t. the reference point (perf=0, area=ref_area).  Dominated and
    out-of-reference points contribute nothing, so any evaluated log can
    be passed directly."""
    perf = np.asarray(perf, dtype=np.float64)
    area = np.asarray(area, dtype=np.float64)
    keep = (perf > 0) & (area <= ref_area)
    if not keep.any():
        return 0.0
    perf, area = perf[keep], area[keep]
    order = np.lexsort((-perf, area))          # area asc, perf desc
    hv = 0.0
    best = 0.0
    for i in order:
        if perf[i] > best:
            hv += (ref_area - area[i]) * (perf[i] - best)
            best = perf[i]
    return float(hv)
