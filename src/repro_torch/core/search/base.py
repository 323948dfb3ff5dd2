"""Optimizer interface, search driver, and discrete-space plumbing.

See the package docstring (`repro_torch.core.search`) for the contract.
The key pieces here:

  * `Optimizer`      — the propose / observe / done interface every engine
                       implements.
  * `run_search`     — the driver loop: score each proposed pool through the
                       shared `Evaluator` and feed the scores back.
  * `SearchResult`   — uniform result record.
  * `SpaceCodec`     — vectorized config <-> index-array conversion so
                       population engines manipulate struct-of-arrays, not
                       lists of dataclasses.
  * `DiscreteSpace`  — minimal generic space (ordered discrete domains +
                       config constructor) so the same engines drive spaces
                       other than the accelerator one.
"""

from __future__ import annotations

import abc
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.costmodel import ConfigBatch
from repro_torch.core.search import rowcache

__all__ = ["Optimizer", "SearchResult", "run_search", "SpaceCodec",
           "DiscreteSpace", "pareto_front_indices", "pack_config",
           "unpack_config"]


# --------------------------------------------------------------------------
# Vectorized config <-> index-array conversion
# --------------------------------------------------------------------------

class SpaceCodec:
    """Bijective map between config objects and int index arrays [N, V].

    Column `j` of the array indexes `domains[variables[j]]`.  Engines that
    work on populations (genetic, annealing chains, random batches) keep the
    index representation and only decode when a pool must be scored.
    """

    def __init__(self, domains: Dict[str, Sequence],
                 make_config: Callable[..., Any]):
        self.variables: List[str] = list(domains.keys())
        self.domains: Dict[str, Tuple] = {k: tuple(v)
                                          for k, v in domains.items()}
        self.make_config = make_config
        self.sizes = np.asarray([len(self.domains[v])
                                 for v in self.variables], dtype=np.int64)
        self._index_of = [
            {val: i for i, val in enumerate(self.domains[v])}
            for v in self.variables
        ]
        # per-variable numeric value LUTs for the array-native paths; None
        # where a domain is non-numeric (e.g. string-valued ExecPoint vars)
        self._value_luts: List[Optional[np.ndarray]] = []
        for v in self.variables:
            try:
                self._value_luts.append(
                    np.asarray(self.domains[v], dtype=np.int64))
            except (TypeError, ValueError, OverflowError):
                self._value_luts.append(None)

    @property
    def all_numeric(self) -> bool:
        """True when every domain is int-valued (array decode possible)."""
        return all(lut is not None for lut in self._value_luts)

    @property
    def n_vars(self) -> int:
        return len(self.variables)

    def encode(self, configs: Sequence[Any]) -> np.ndarray:
        """configs -> [N, V] domain-index array (struct-of-arrays view)."""
        n = len(configs)
        out = np.empty((n, self.n_vars), dtype=np.int64)
        for j, var in enumerate(self.variables):
            lut = self._index_of[j]
            out[:, j] = [lut[getattr(c, var)] for c in configs]
        return out

    def decode(self, idx: np.ndarray) -> List[Any]:
        """[N, V] domain-index array -> config objects."""
        idx = np.asarray(idx, dtype=np.int64)
        cols = [
            [self.domains[var][i] for i in idx[:, j]]
            for j, var in enumerate(self.variables)
        ]
        return [
            self.make_config(**{var: cols[j][r]
                                for j, var in enumerate(self.variables)})
            for r in range(idx.shape[0])
        ]

    def decode_values(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        """[N, V] domain-index array -> {var: [N] int64 value array}.

        The array-native decode: no config objects are materialized.  Only
        valid for all-numeric spaces (`self.all_numeric`)."""
        idx = np.asarray(idx, dtype=np.int64)
        out: Dict[str, np.ndarray] = {}
        for j, var in enumerate(self.variables):
            lut = self._value_luts[j]
            if lut is None:
                raise TypeError(f"domain of {var!r} is not numeric; "
                                "array decode unavailable")
            out[var] = lut[idx[:, j]]
        return out

    def encode_values(self, values: Dict[str, np.ndarray]) -> np.ndarray:
        """{var: [N] value array} -> [N, V] domain-index array (inverse of
        `decode_values`; every value must be a domain member)."""
        n = len(next(iter(values.values())))
        out = np.empty((n, self.n_vars), dtype=np.int64)
        for j, var in enumerate(self.variables):
            lut = self._value_luts[j]
            if lut is None:
                raise TypeError(f"domain of {var!r} is not numeric; "
                                "array encode unavailable")
            order = np.argsort(lut, kind="stable")
            pos = np.searchsorted(lut[order], values[var])
            idx = order[np.clip(pos, 0, len(lut) - 1)]
            if not np.array_equal(lut[idx], values[var]):
                bad = values[var][lut[idx] != values[var]]
                raise ValueError(f"values {bad[:4]}... of {var!r} are not "
                                 "in its domain")
            out[:, j] = idx
        return out

    def sample_indices(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Uniform random [n, V] index population."""
        return rng.integers(self.sizes[None, :], size=(n, self.n_vars))

    def snap(self, cfg: Any) -> Any:
        """Return `cfg` with any out-of-domain field replaced by the nearest
        domain value (first value for non-numeric fields), so it encodes.

        Needed for user-supplied `init` points whose fields fall outside a
        mode-restricted space (e.g. a train-shaped ExecPoint baseline on a
        decode cell)."""
        kwargs = {}
        changed = False
        for j, var in enumerate(self.variables):
            val = getattr(cfg, var)
            if val in self._index_of[j]:
                kwargs[var] = val
            else:
                dom = self.domains[var]
                try:
                    kwargs[var] = min(dom, key=lambda d: abs(d - val))
                except TypeError:
                    kwargs[var] = dom[0]
                changed = True
        return self.make_config(**kwargs) if changed else cfg

    def mutate_indices(self, rng: np.random.Generator, idx: np.ndarray,
                       rate: float) -> np.ndarray:
        """Random-reset mutation: each gene is redrawn with prob `rate`."""
        mask = rng.random(idx.shape) < rate
        fresh = rng.integers(self.sizes[None, :], size=idx.shape)
        return np.where(mask, fresh, idx)


@dataclasses.dataclass
class DiscreteSpace:
    """Generic ordered-discrete design space.

    The engines only need: `variables`, `domains`, `sample`,
    `neighbors_over`, and a codec.  `repro_torch.core.space.DesignSpace`
    offers the same surface (plus accelerator-specific validity repair);
    this class adapts any other domain dict to the engines.
    """

    domains: Dict[str, Tuple]
    make_config: Callable[..., Any]

    @property
    def variables(self) -> List[str]:
        return list(self.domains.keys())

    def codec(self) -> SpaceCodec:
        return SpaceCodec(self.domains, self.make_config)

    def sample(self, rng: np.random.Generator, max_tries: int = 1000,
               validator=None) -> Any:
        for _ in range(max_tries):
            kwargs = {k: v[int(rng.integers(len(v)))]
                      for k, v in self.domains.items()}
            cfg = self.make_config(**kwargs)
            if validator is not None and not validator(cfg):
                continue
            return cfg
        raise RuntimeError("could not sample a valid configuration")

    def neighbors_over(self, cfg: Any, variable: str) -> List[Any]:
        return [dataclasses.replace(cfg, **{variable: v})
                for v in self.domains[variable]]


def codec_for(space: Any) -> SpaceCodec:
    """Codec for either a DesignSpace (accelerator) or a DiscreteSpace."""
    fn = getattr(space, "codec", None)
    if fn is not None:
        return fn()
    raise TypeError(f"space {type(space).__name__} has no codec()")


def pack_config(codec: SpaceCodec, cfg: Any) -> List[int]:
    """Config -> JSON-able domain-index row (for engine `state_dict`)."""
    return [int(x) for x in codec.encode([cfg])[0]]


def unpack_config(codec: SpaceCodec, row: Sequence[int]) -> Any:
    """Inverse of `pack_config` (exact integer round-trip)."""
    return codec.decode(np.asarray([row], dtype=np.int64))[0]


def _constraint_repairs(evaluator: Any, batch: Any, space: Any) -> Any:
    """Chain the injected constraints' `repair` hooks (repro_torch.dse) over a
    batch; identity when the evaluator carries none."""
    for c in getattr(evaluator, "constraints", ()):
        fn = getattr(c, "repair", None)
        if fn is not None:
            batch = fn(batch, space)
    return batch


def repair_with(space: Any, evaluator: Any, cfg: Any) -> Any:
    """Apply the space's validity repair if it has one (Eq. 11/13 buffer
    floors + area budget for the accelerator space; identity otherwise),
    then any injected constraints' `repair` hooks.

    Prefers the evaluator's batch-scaled activation floor
    (`peak_input_bits_scaled`) because Eq. (13) multiplies the peak demand
    by the stream's batch size."""
    fn = getattr(space, "repair_for_peaks", None)
    if fn is not None:
        peak_in = getattr(evaluator, "peak_input_bits_scaled",
                          getattr(evaluator, "peak_input_bits", 0))
        cfg = fn(cfg, getattr(evaluator, "peak_weight_bits", 0), peak_in)
    if getattr(evaluator, "constraints", ()):
        batch = _constraint_repairs(evaluator,
                                    ConfigBatch.from_configs([cfg]), space)
        cfg = batch.to_configs()[0]
    return cfg


def repair_many_with(space: Any, evaluator: Any, batch: Any) -> Any:
    """Batched `repair_with`: route a whole population (ConfigBatch or
    config sequence) through `space.repair_for_peaks_many` with the
    evaluator's peak floors, then the injected constraints' `repair`
    hooks.  Returns None when the space has no batched repair (caller
    falls back to the scalar path)."""
    fn = getattr(space, "repair_for_peaks_many", None)
    if fn is None:
        return None
    peak_in = getattr(evaluator, "peak_input_bits_scaled",
                      getattr(evaluator, "peak_input_bits", 0))
    out = fn(batch, getattr(evaluator, "peak_weight_bits", 0), peak_in)
    return _constraint_repairs(evaluator, out, space)


# --------------------------------------------------------------------------
# Results
# --------------------------------------------------------------------------

def pareto_front_indices(perf: np.ndarray, area: np.ndarray) -> List[int]:
    """Indices of the non-dominated set for (maximize perf, minimize area).

    Zero-performance (constraint-violating) points never enter the front.
    """
    perf = np.asarray(perf, dtype=np.float64)
    area = np.asarray(area, dtype=np.float64)
    cand = np.flatnonzero(perf > 0)
    if cand.size == 0:
        return []
    # sweep by ascending area; a point joins the front iff it beats the best
    # perf seen at any smaller-or-equal area
    order = cand[np.lexsort((-perf[cand], area[cand]))]
    front: List[int] = []
    best = -np.inf
    for i in order:
        if perf[i] > best:
            front.append(int(i))
            best = perf[i]
    return front


@dataclasses.dataclass
class SearchResult:
    """Uniform search outcome."""

    best: Any
    best_perf: float
    history: List[Tuple[Any, float]]       # per-round incumbent
    evaluated: List[Any]                   # every scored config, in order
    evaluated_perf: np.ndarray             # aligned scores (scalarized)
    rounds: int
    engine: str = ""
    evaluator: Any = dataclasses.field(default=None, repr=False)
    # [N, M] objective-value rows when the evaluator scored a vector
    # objective; None for scalar runs
    evaluated_values: Optional[np.ndarray] = None

    @classmethod
    def merge(cls, results: Sequence["SearchResult"],
              evaluator: Any = None) -> "SearchResult":
        """Deterministic reduce over restart results.

        Evaluated logs concatenate in the given (restart) order; the
        incumbent is the earliest result holding the maximum `best_perf`
        (strict ``>`` — exactly the historical multi-restart rule) and
        contributes its `history`/`engine`.  `rounds` sum.  `evaluator`
        defaults to the first result's handle."""
        results = list(results)
        if not results:
            raise ValueError("cannot merge zero SearchResults")
        best = results[0]
        for r in results[1:]:
            if r.best_perf > best.best_perf:
                best = r
        evaluated: List[Any] = []
        perf: List[float] = []
        values: List[np.ndarray] = []
        rounds = 0
        for r in results:
            evaluated.extend(r.evaluated)
            if r.evaluated_values is not None:
                values.append(r.evaluated_values)
            perf.extend(np.asarray(r.evaluated_perf,
                                   dtype=np.float64).tolist())
            rounds += int(r.rounds)
        if evaluator is None:
            evaluator = next((r.evaluator for r in results
                              if r.evaluator is not None), None)
        return cls(best=best.best, best_perf=float(best.best_perf),
                   history=list(best.history), evaluated=evaluated,
                   evaluated_perf=np.asarray(perf), rounds=rounds,
                   engine=best.engine, evaluator=evaluator,
                   evaluated_values=(np.vstack(values) if values else None))


# --------------------------------------------------------------------------
# Optimizer interface + driver
# --------------------------------------------------------------------------

class Optimizer(abc.ABC):
    """Ask/tell search engine.

    Contract (see package docstring): the driver alternates
    `pool = engine.propose()` -> `scores = evaluator(pool)` ->
    `engine.observe(pool, scores)` until `engine.done`.  Engines own their
    RNG, their incumbent/`history` bookkeeping, and their stopping rule.

    Vector scores: an evaluator carrying a multi-objective (e.g.
    `ParetoObjective`) may hand back an [N, M] value matrix instead of an
    [N] score vector.  Engines stay single-objective internally — every
    `observe` first routes scores through `_scalar`, which applies the
    engine's `scalarizer` hook (installed by `make_engine` from the
    evaluator's `scalarize`) so the incumbent/acceptance logic sees one
    number per candidate while the search loop keeps the full rows for
    the Pareto front.
    """

    name: str = "engine"
    #: engines that consume the full [N, M] objective-value matrix in
    #: `observe` (NSGA-II non-dominated sorting) set this True; the driver
    #: then hands them the raw rows while still logging the scalarized
    #: signal for `SearchResult.evaluated_perf`
    observes_vector: bool = False

    def __init__(self) -> None:
        self.best: Any = None
        self.best_perf: float = -np.inf
        self.history: List[Tuple[Any, float]] = []
        self.rounds: int = 0
        # [N, M] -> [N] reduction for vector-scored pools; None = take the
        # first objective column (by convention the perf-like term)
        self.scalarizer: Optional[Callable[[np.ndarray], np.ndarray]] = None

    def _scalar(self, scores) -> np.ndarray:
        """Reduce evaluator output to the [N] vector engines optimize.

        Non-finite entries (NaN from a crashed measurement, inf from a
        degenerate model) become -inf: an invalid evaluation must never win
        the incumbent slot or poison a comparison chain, and -inf keeps
        every engine's ordering logic (argmax, Metropolis accept, quantile
        splits) well-defined where NaN would not."""
        scores = np.asarray(scores, dtype=np.float64)
        if scores.ndim != 1:
            if self.scalarizer is not None:
                scores = np.asarray(self.scalarizer(scores),
                                    dtype=np.float64)
            else:
                scores = scores[:, 0]
        return np.where(np.isfinite(scores), scores, -np.inf)

    # --------------------------------------------- optional state round-trip
    def state_dict(self) -> Dict:
        """JSON-able snapshot of the engine's search state, taken at a
        round boundary (after `observe`, before the next `propose`).
        Engines that support mid-study checkpointing (tpe, nsga2) override
        both hooks; `load_state` into a freshly constructed engine must
        continue bit-identically to the uninterrupted run."""
        raise NotImplementedError(
            f"engine {self.name!r} does not serialize search state")

    def load_state(self, state: Dict) -> None:
        raise NotImplementedError(
            f"engine {self.name!r} does not serialize search state")

    @abc.abstractmethod
    def propose(self) -> List[Any]:
        """Next pool of candidate configurations to score (may be empty)."""

    @abc.abstractmethod
    def observe(self, pool: Sequence[Any], scores: np.ndarray) -> None:
        """Feed back the scores for the pool returned by `propose`."""

    @property
    @abc.abstractmethod
    def done(self) -> bool:
        """True once the engine has converged / exhausted its budget."""

    # shared bookkeeping helper
    def _track_best(self, pool: Sequence[Any], scores: np.ndarray) -> int:
        i = int(np.argmax(scores))
        if float(scores[i]) > self.best_perf:
            self.best, self.best_perf = pool[i], float(scores[i])
        return i


class _RoundJournal:
    """Per-round search-journal emitter (active only while the obs journal
    is enabled, so the search loop pays nothing otherwise).

    Result-inert by construction: `hypervolume` re-reads the pool's
    (GOPS, area) through `score_with_area` — every row is a cache hit
    because `run_search` just scored the pool — so no engine-visible value
    changes whether the journal is on or off."""

    def __init__(self, engine: Optimizer, evaluator: Any) -> None:
        self.engine = engine
        self.evaluator = evaluator
        self.ref_area = float(getattr(evaluator, "area_budget", 0.0) or 0.0)
        self.can_hv = (self.ref_area > 0
                       and hasattr(evaluator, "score_with_area"))
        self._perf: List[float] = []
        self._area: List[float] = []

    def emit(self, pool: Sequence[Any], scalar: np.ndarray,
             dedup_skipped: int = 0) -> None:
        hv = None
        if self.can_hv:
            from repro_torch.core.search.synthetic import hypervolume_2d
            p, a = self.evaluator.score_with_area(pool)
            self._perf.extend(np.asarray(p, dtype=np.float64).tolist())
            self._area.extend(np.asarray(a, dtype=np.float64).tolist())
            hv = float(hypervolume_2d(np.asarray(self._perf),
                                      np.asarray(self._area),
                                      self.ref_area))
        best = float(self.engine.best_perf)
        obs.journal_record(
            kind="round",
            engine=self.engine.name,
            round=int(self.engine.rounds),
            pool=int(len(pool)),
            n_scored=int(getattr(self.evaluator, "n_scored", 0)),
            dedup_skipped=int(dedup_skipped),
            best=(best if np.isfinite(best) else None),
            feasible_frac=(float(np.mean(np.asarray(scalar) > 0))
                           if len(scalar) else 0.0),
            hypervolume=hv)


class _CrossRoundDedup:
    """Counts how many proposed rows were already proposed in an earlier
    round of the same search (the engines re-propose heavily near
    convergence).  Those rows never reach the cost model — the evaluator's
    hashed row cache serves them as hits — so this is pure bookkeeping:
    the count accumulates onto `evaluator.dedup_skipped`.  Counting is
    hash-based (collisions could overcount by one-in-2^64); scores are
    never affected."""

    def __init__(self) -> None:
        self._seen: set = set()

    def observe(self, pool: Sequence[Any]) -> int:
        if hasattr(pool, "matrix"):
            keys = rowcache.hash_rows(pool.matrix).tolist()
        elif pool and hasattr(pool[0], next(iter(ConfigBatch._INDEX))):
            keys = rowcache.hash_rows(
                ConfigBatch.from_configs(pool).matrix).tolist()
        else:
            # generic spaces carry arbitrary dataclass points; fall back to
            # exact field-tuple keys
            keys = [tuple(sorted(dataclasses.asdict(c).items()))
                    for c in pool]
        seen = self._seen
        skipped = 0
        for h in keys:
            if h in seen:
                skipped += 1
            else:
                seen.add(h)
        return skipped


def run_search(engine: Optimizer, evaluator) -> SearchResult:
    """Drive `engine` to completion through `evaluator`; collect the log.

    Engines may propose either config-object lists or array-native
    `ConfigBatch` pools; batches stay arrays through scoring and are only
    materialized to dataclasses once, after the loop, for the
    `SearchResult.evaluated` log.

    When the evaluator returns an [N, M] objective-value matrix (vector
    objective), the loop scalarizes ONCE through the engine's hook —
    scalar engines then observe plain scalars (their `_scalar` is finite-
    identity on 1-D input, so the stateful scalarizer is not applied
    twice), while engines with `observes_vector` (NSGA-II) receive the raw
    rows — and the full rows are kept in
    `SearchResult.evaluated_values`.

    With `repro_torch.obs` on, each round is an ``ask_tell_round`` span,
    its seconds a ``round_seconds.<engine>`` histogram sample and one
    journal record."""
    pools: List[Any] = []
    perf: List[float] = []
    value_rows: List[np.ndarray] = []
    jrn = _RoundJournal(engine, evaluator) if obs.journal().enabled else None
    timed = obs.metrics().enabled
    dedup = _CrossRoundDedup()
    while not engine.done:
        t0 = time.perf_counter() if timed else 0.0
        with obs.span("ask_tell_round", engine=engine.name,
                      round=engine.rounds):
            pool = engine.propose()
            if pool is None or len(pool) == 0:
                break
            round_skipped = dedup.observe(pool)
            evaluator.dedup_skipped = (
                getattr(evaluator, "dedup_skipped", 0) + round_skipped)
            scores = np.asarray(evaluator(pool), dtype=np.float64)
            if scores.ndim == 2:
                value_rows.append(scores)
                scalar = engine._scalar(scores)
                # vector-observing engines (NSGA-II) get the raw rows; the
                # stateful scalarizer was already fed this batch, so the
                # engine's own `_scalar` call on it is idempotent
                observed = scores if engine.observes_vector else scalar
            else:
                scalar = observed = scores
            pools.append(pool)
            perf.extend(scalar.tolist())
            engine.observe(pool, observed)
        if timed:
            obs.observe(f"round_seconds.{engine.name}",
                        time.perf_counter() - t0)
        if jrn is not None:
            jrn.emit(pool, scalar, dedup_skipped=round_skipped)
    evaluated: List[Any] = []
    for pool in pools:
        evaluated.extend(pool.to_configs() if hasattr(pool, "to_configs")
                         else pool)
    best = engine.best
    best_perf = float(engine.best_perf)
    if best is None and evaluated:          # engine kept no incumbent
        i = int(np.argmax(perf))
        best, best_perf = evaluated[i], float(perf[i])
    return SearchResult(best=best, best_perf=best_perf,
                        history=list(engine.history), evaluated=evaluated,
                        evaluated_perf=np.asarray(perf), rounds=engine.rounds,
                        engine=engine.name, evaluator=evaluator,
                        evaluated_values=(np.vstack(value_rows)
                                          if value_rows else None))
